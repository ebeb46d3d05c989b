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
    lib.mlsp_knn_blocks.argtypes = [_I, _I, _I]
    lib.mlsp_knn_blocks.restype = ctypes.c_longlong
    lib.mlsp_knn_stats.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mlsp_knn_stats.restype = _I
    return lib


def _checked(x: torch.Tensor, k: int, rows, name: str):
    """(x as contiguous float32, q0, nq) after the wrappers' checks."""
    if not x.is_cuda:
        raise ValueError(f"{name}: needs a CUDA tensor, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"{name}: expected [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"{name}: k={k} outside [1, min(N={N}, {MAX_K})]")
    q0, nq = (0, N) if rows is None else rows
    if not (0 <= q0 and 0 <= nq and q0 + nq <= N):
        raise ValueError(f"{name}: rows [{q0}, {q0 + nq}) outside the "
                         f"cloud's [0, {N})")
    if _lib().mlsp_knn_smem_bytes(C) > _SMEM_LIMIT:
        raise ValueError(f"{name}: C={C} channels exceed shared memory")
    return x.float().contiguous(), q0, nq


def knn_cuda(x: torch.Tensor, k: int,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """kNN graph of x [B, N, C] on the card: int64 [B, N, k], or with
    `rows=(q0, nq)` int64 [B, nq, k], the rows [q0, q0 + nq) of it."""
    x, q0, nq = _checked(x, k, rows, "knn_cuda")
    B, N, C = x.shape
    out = torch.empty((B, nq, k), dtype=torch.int64, device=x.device)
    if B == 0 or nq == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().mlsp_knn(x.data_ptr(), out.data_ptr(), B, N, C,
                                     k, q0, nq, stream), "knn")
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0


def knn_cuda_stats(x: torch.Tensor, k: int,
                   rows: tuple[int, int] | None = None):
    """`knn_cuda`'s indices from the counting instance of the same kernel
    body (`knn_stats_kernel`), with what its register filter did: the
    candidates (query, point pairs) that passed it, their share of all
    candidates, and the buffer flushes a query took. Not a main-path
    launch: `knn_cuda.launches` does not count it."""
    x, q0, nq = _checked(x, k, rows, "knn_cuda_stats")
    B, N, C = x.shape
    out = torch.empty((B, nq, k), dtype=torch.int64, device=x.device)
    if B == 0 or nq == 0:
        return out, {"passed": 0, "pass_share": 0.0, "flushes": 0,
                     "flushes_per_query": 0.0}
    lib = _lib()
    stats = torch.zeros((lib.mlsp_knn_blocks(B, nq, C), 2), dtype=torch.int64,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.mlsp_knn_stats(
            x.data_ptr(), out.data_ptr(), stats.data_ptr(), B, N, C, k, q0,
            nq, stream), "knn")
    passed, flushes = (int(v) for v in stats.sum(0).tolist())
    return out, {"passed": passed, "pass_share": passed / (B * nq * N),
                 "flushes": flushes, "flushes_per_query": flushes / (B * nq)}
