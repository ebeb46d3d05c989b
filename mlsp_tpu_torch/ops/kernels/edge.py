"""Wrappers of the neighbourhood-statistics kernels (`csrc/edge_moments.cu`):
the forward (K2-fwd) and the backward (K2-bwd) of `edge_pallas.edge_moments`.

Each launches its kernel on CUDA tensors or raises; neither falls back.
`ops.edge.edge_moments` ties them together as a `torch.autograd.Function`;
the plain version is `ops.edge.edge_moments_torch`, differentiated by
autograd.
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
    lib.mlsp_edge_moments_bwd.argtypes = [_P] * 9 + [_I, _I, _I, _I, _P]
    lib.mlsp_edge_moments_bwd.restype = _I
    return lib


def _check_graph(name: str, u: torch.Tensor, idx: torch.Tensor) -> None:
    if not (u.is_cuda and idx.device == u.device):
        raise ValueError(f"{name}: needs CUDA tensors on one device, got "
                         f"{u.device} and {idx.device}")
    if (u.ndim != 3 or idx.ndim != 3 or idx.shape[:2] != u.shape[:2]
            or idx.dtype != torch.int64):
        raise ValueError(f"{name}: expected u [B, N, C] and int64 idx "
                         f"[B, N, k], got {tuple(u.shape)} and {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if u.numel() == 0 or idx.shape[-1] == 0:
        raise ValueError(f"{name}: empty input")


def edge_moments_cuda(u: torch.Tensor, idx: torch.Tensor,
                      want_moments: bool) -> tuple[torch.Tensor, ...]:
    """Max, min (and sum, sum of squares) of u [B, N, C] over the neighbours
    idx [B, N, k] (int64, from the kNN kernel), each float32 [B, N, C].

    The outputs carry no gradient: a differentiable call goes through
    `ops.edge.edge_moments`, whose backward is `edge_moments_bwd_cuda`."""
    _check_graph("edge_moments_cuda", u, idx)
    if u.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "edge_moments_cuda does not record a gradient: call "
            "ops.edge.edge_moments, whose backward is the K2-bwd kernel")
    B, N, C = u.shape
    k = idx.shape[-1]
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


def edge_moments_bwd_cuda(u: torch.Tensor, idx: torch.Tensor,
                          mx: torch.Tensor, mn: torch.Tensor,
                          dmx: torch.Tensor | None, dmn: torch.Tensor | None,
                          ds1: torch.Tensor | None = None,
                          ds2: torch.Tensor | None = None) -> torch.Tensor:
    """du [B, N, C] float32 from the cotangents of (mx, mn, s1, s2), each
    [B, N, C] or None (no cotangent: its term is skipped); mx and mn are
    the forward's outputs for u and idx. Max and min cotangents are shared
    equally among tied neighbours."""
    _check_graph("edge_moments_bwd_cuda", u, idx)
    B, N, C = u.shape
    k = idx.shape[-1]

    def operand(t):
        if t is None:
            return None
        if t.shape != u.shape or t.device != u.device:
            raise ValueError(f"edge_moments_bwd_cuda: expected [B, N, C] = "
                             f"{tuple(u.shape)} on {u.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        return t.float().contiguous()

    u, mx, mn = operand(u), operand(mx), operand(mn)
    cots = [operand(t) for t in (dmx, dmn, ds1, ds2)]
    idx = idx.contiguous()
    du = torch.zeros_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().mlsp_edge_moments_bwd(
            u.data_ptr(), idx.data_ptr(), mx.data_ptr(), mn.data_ptr(),
            *[None if t is None else t.data_ptr() for t in cots],
            du.data_ptr(), B, N, C, k, stream), "edge_moments")
    edge_moments_bwd_cuda.launches += 1
    return du


edge_moments_bwd_cuda.launches = 0
