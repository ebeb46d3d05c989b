"""Wrapper of the neighbourhood-statistics kernel (`csrc/edge_moments.cu`),
the port of the forward of `edge_pallas.edge_moments`.

`edge_moments_cuda` launches the kernel on CUDA tensors or raises; it never
falls back. Its plain version is `ops.edge.edge_moments_torch`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlsp_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("edge_moments")
    lib.mlsp_edge_moments.argtypes = [_P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P]
    lib.mlsp_edge_moments.restype = _I
    return lib


def edge_moments_cuda(u: torch.Tensor, idx: torch.Tensor,
                      want_moments: bool) -> tuple[torch.Tensor, ...]:
    """Max, min (and sum, sum of squares) of u [B, N, C] over the neighbours
    idx [B, N, k] (int64, from the kNN kernel), each float32 [B, N, C]."""
    if not (u.is_cuda and idx.device == u.device):
        raise ValueError(f"edge_moments_cuda: needs CUDA tensors on one "
                         f"device, got {u.device} and {idx.device}")
    if (u.ndim != 3 or idx.ndim != 3 or idx.shape[:2] != u.shape[:2]
            or idx.dtype != torch.int64):
        raise ValueError(f"edge_moments_cuda: expected u [B, N, C] and int64 "
                         f"idx [B, N, k], got {tuple(u.shape)} and "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if u.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "edge_moments_cuda has no backward kernel yet (K2-bwd, "
            "ROADMAP.md): run under torch.no_grad()")
    B, N, C = u.shape
    k = idx.shape[-1]
    if u.numel() == 0 or k == 0:
        raise ValueError("edge_moments_cuda: empty input")
    u = u.float().contiguous()
    idx = idx.contiguous()
    outs = tuple(torch.empty_like(u) for _ in range(4 if want_moments else 2))
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().mlsp_edge_moments(
            u.data_ptr(), idx.data_ptr(), *ptrs, B, N, C, k,
            int(want_moments), stream), "edge_moments")
    edge_moments_cuda.launches += 1
    return outs


edge_moments_cuda.launches = 0
