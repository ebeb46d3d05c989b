"""Wrapper of the kNN kernel (`csrc/knn.cu`), the port of `knn_pallas`.

`knn_cuda` launches the kernel on a CUDA tensor or raises; it never falls
back. Its plain version is `ops.knn.knn_indices_torch`. With `rows=(q0,
nq)` it builds the graph of the queries [q0, q0 + nq) of every cloud
against the whole cloud: a points mesh's share (`parallel.points_rows`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlsp_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_K = 32  # the sorted top-k lives one key per lane of a warp
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("knn")
    lib.mlsp_knn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mlsp_knn.restype = _I
    lib.mlsp_knn_smem_bytes.argtypes = [_I]
    lib.mlsp_knn_smem_bytes.restype = ctypes.c_size_t
    return lib


def knn_cuda(x: torch.Tensor, k: int,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """kNN graph of x [B, N, C] on the card: int64 [B, N, k], or with
    `rows=(q0, nq)` int64 [B, nq, k], the rows [q0, q0 + nq) of it."""
    if not x.is_cuda:
        raise ValueError(f"knn_cuda: needs a CUDA tensor, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"knn_cuda: expected [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"knn_cuda: k={k} outside [1, min(N={N}, {MAX_K})]")
    q0, nq = (0, N) if rows is None else rows
    if not (0 <= q0 and 0 <= nq and q0 + nq <= N):
        raise ValueError(f"knn_cuda: rows [{q0}, {q0 + nq}) outside the "
                         f"cloud's [0, {N})")
    lib = _lib()
    if lib.mlsp_knn_smem_bytes(C) > _SMEM_LIMIT:
        raise ValueError(f"knn_cuda: C={C} channels exceed shared memory")
    x = x.float().contiguous()
    out = torch.empty((B, nq, k), dtype=torch.int64, device=x.device)
    if B == 0 or nq == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.mlsp_knn(x.data_ptr(), out.data_ptr(), B, N, C, k,
                                  q0, nq, stream), "knn")
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0
