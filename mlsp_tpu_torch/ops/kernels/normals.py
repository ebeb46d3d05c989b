"""Wrapper of the kNN normal-moments kernel (`csrc/knn_moments.cu`, K3),
the port of `knn_moments_pallas`.

`knn_moments_cuda` launches the kernel on a CUDA tensor or raises; it never
falls back. Its plain version is `ops.normals.knn_moments_torch`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlsp_tpu_torch.ops.kernels import _build
from mlsp_tpu_torch.ops.kernels.knn import MAX_K

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("knn_moments")
    lib.mlsp_knn_moments.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.mlsp_knn_moments.restype = _I
    return lib


def knn_moments_cuda(x: torch.Tensor, k: int, return_indices: bool = False):
    """Sums over each point's k nearest points of x [B, N, 3] (K1's
    selection): s1 [B, N, 3] of the coordinates and s2 [B, N, 9] of their
    outer products, row-major. With `return_indices` also the int64
    [B, N, k] neighbour indices the kernel chose (for checking)."""
    if not x.is_cuda:
        raise ValueError(f"knn_moments_cuda: needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"knn_moments_cuda: expected [B, N, 3], got "
                         f"{tuple(x.shape)}")
    B, N, _ = x.shape
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"knn_moments_cuda: k={k} outside "
                         f"[1, min(N={N}, {MAX_K})]")
    x = x.float().contiguous()
    s1 = torch.empty((B, N, 3), dtype=torch.float32, device=x.device)
    s2 = torch.empty((B, N, 9), dtype=torch.float32, device=x.device)
    idx = (torch.empty((B, N, k), dtype=torch.int64, device=x.device)
           if return_indices else None)
    if B > 0:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(_lib().mlsp_knn_moments(
                x.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                None if idx is None else idx.data_ptr(), B, N, k, stream),
                "knn_moments")
        knn_moments_cuda.launches += 1
    return (s1, s2, idx) if return_indices else (s1, s2)


knn_moments_cuda.launches = 0
