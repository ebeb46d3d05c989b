"""Wrappers of the neighbourhood-statistics kernels (`csrc/edge_moments.cu`):
the forward (K2-fwd) and the backward (K2-bwd) of `edge_pallas.edge_moments`.

Each launches its kernel on CUDA tensors or raises; neither falls back.
`ops.edge.edge_moments` ties them together as a `torch.autograd.Function`;
the plain version is `ops.edge.edge_moments_torch`, differentiated by
autograd. `plan` picks each launch's shape and `fixed_point_split` is
K2-bwd's pre-pass in plain PyTorch; neither launches anything, so the CPU
tests call them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mlsp_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper
MAX_THREADS = 1024  # threads a block (`csrc`'s MAX_THREADS)
# Largest cloud: a block holds an [N, cs] slice of u (and, backward, of
# du) in shared memory, at least one channel wide. 4x PointSegDA's 2048.
N_MAX = 8192
BWD_MAX_EDGES = 1 << 28  # N k of one cloud in K2-bwd (`csrc`'s limit)
# The tiles' share; the index chunks get the rest. The backward's three
# tiles may take more: 16-channel slices at N = 1024, with index chunks,
# took 9.48 ms of K2-bwd an all-branch step on an H100 against 10.22 for
# 8-channel slices with the whole index at once (the paper step: 2.31 and
# 2.26, profiled).
_TILE_LIMIT, _TILE_LIMIT_BWD = 160 * 1024, 200 * 1024
_IDX_TARGET = 64 * 1024  # the index chunk's share, for the occupancy guess
# Used only to size the grid: the H100's SMs, shared memory per SM and
# the shared memory the runtime keeps per block.
_SMS, _SM_SMEM, _BLOCK_RESERVE = 132, 228 * 1024, 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: slices of `cs` channels (a power of two); the
    forward's `split` query ranges per (cloud, slice) (the backward's is 1);
    index chunks of `qc` queries by `kc` neighbours; `threads` a block;
    `smem` bytes of shared memory a block, in the layout the comment above
    each kernel in `csrc/edge_moments.cu` describes."""
    cs: int
    split: int
    qc: int
    kc: int
    threads: int
    smem: int


def _tile_bytes(rows: int, cs: int) -> int:
    return (rows * cs * 4 + 15) // 16 * 16


# The backward's block scratch after its tiles: 8 ints (`BWD_SCRATCH`)
_BWD_SCRATCH_BYTES = 32


def _tiles_bytes(N: int, cs: int, backward: bool) -> int:
    """The u tile, or (backward) the u tile and du's two 32-bit
    accumulator tiles, each with a spare row, and the block scratch."""
    if backward:
        return 3 * _tile_bytes(N + 1, cs) + _BWD_SCRATCH_BYTES
    return _tile_bytes(N, cs)


def _idx_row_bytes(kc: int, backward: bool) -> int:
    """One staged query: kc offsets at an odd stride, plus the forward's
    flag."""
    return 4 * ((kc | 1) + (0 if backward else 1))


@functools.lru_cache(maxsize=256)
def plan(B: int, N: int, C: int, k: int, backward: bool) -> Plan:
    """The launch shape of K2-fwd (`backward` False) or K2-bwd for u
    [B, N, C] and k neighbours. Raises ValueError for N outside
    [1, N_MAX]."""
    if not 1 <= N <= N_MAX:
        raise ValueError(f"edge_moments: N={N} points outside [1, {N_MAX}]: "
                         f"a block holds an [N, channels] slice of u in "
                         f"shared memory")
    if min(B, C, k) < 1:
        raise ValueError(f"edge_moments: empty input B={B}, C={C}, k={k}")
    if backward and N * k > BWD_MAX_EDGES:
        raise ValueError(f"edge_moments_bwd: N k = {N * k} edges a cloud "
                         f"above {BWD_MAX_EDGES}: its 32-bit sums could "
                         f"overflow")
    cs = min(16 if backward else 32, 1 << (C - 1).bit_length())

    def fits(cs: int) -> bool:
        tiles = _tiles_bytes(N, cs, backward)
        if not backward:
            return tiles <= _TILE_LIMIT
        # beside its tiles, a wave of whole index rows (kNN's k <= 32)
        wave_rows = MAX_THREADS // cs * _idx_row_bytes(min(k, 32), True)
        return tiles <= _TILE_LIMIT_BWD and tiles + wave_rows <= SMEM_LIMIT

    while cs > 1 and not fits(cs):
        cs //= 2
    tile = _tiles_bytes(N, cs, backward)
    slices = -(-C // cs)
    # blocks an SM holds at about this size, and threads to fill it
    per_sm = max(1, _SM_SMEM // (tile + _IDX_TARGET + _BLOCK_RESERVE))
    threads = {1: 1024, 2: 512}.get(per_sm, 256)
    # a forward item is 4 channels where the rows allow 16-byte loads
    per_item = 4 if not backward and C % 4 == 0 and cs % 4 == 0 else 1
    wave = threads * per_item // cs  # queries of one item per thread
    split = 1
    # forward: ranges until the blocks fill half the SMs' slots (on an
    # H100 more ranges cost more in copies of u than they gain)
    if not backward:
        while (2 * B * slices * split < _SMS * per_sm
               and -(-N // (2 * split)) >= wave):
            split *= 2
    qr = -(-N // split)
    budget = SMEM_LIMIT - tile
    wave = min(wave, qr)
    row = _idx_row_bytes(k, backward)
    kc = k
    # the whole range at once where it fits
    qc = qr if qr * row <= budget else max(wave, budget // row // wave * wave)
    qc = min(qc, qr)
    if qc * row > budget:  # a huge k: one wave, neighbour chunks
        qc = wave
        kc = min(k, budget // (4 * qc))
        while qc * _idx_row_bytes(kc, backward) > budget:
            kc -= 1
    return Plan(cs, split, qc, kc, threads,
                tile + qc * _idx_row_bytes(kc, backward))


def fixed_point_split(u: torch.Tensor, idx: torch.Tensor,
                      dmx: torch.Tensor | None, dmn: torch.Tensor | None,
                      ds1: torch.Tensor | None = None,
                      ds2: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2-bwd's pre-pass in plain PyTorch: its fixed point per (cloud,
    channel slice of `plan`), as (s int64 [B, slices], L int64 [B, 1]).
    K2-bwd adds every term as an integer q in units of 2^-s, split as
    q = h 2^L + l, 0 <= l < 2^L, into 32-bit sums of h and of l (the
    comment above the kernel in `csrc/edge_moments.cu`). With D a cloud's
    largest in-degree, L = 32 - bits(3D); s is the largest integer with
    D (|ds1| + 2 |ds2| U + |dmx| + |dmn|) 2^s < 2^(30 + L), each maximum
    over the slice's finite values and U the largest finite |u| of it.
    The arguments are those of `edge_moments_bwd_cuda`, on any device."""
    B, N, C = u.shape
    cs = plan(B, N, C, idx.shape[-1], True).cs
    slices = -(-C // cs)

    def slice_max(t, scale=1.0):
        if t is None:
            return torch.zeros(B, slices, dtype=torch.float64,
                               device=u.device)
        a = (t.float() * scale).abs()
        a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        a = torch.nn.functional.pad(a, (0, slices * cs - C))
        return a.reshape(B, N, slices, cs).amax((1, 3)).double()

    ok = (idx >= 0) & (idx < N)
    degree = torch.zeros(B, N + 1, dtype=torch.long, device=u.device)
    degree.scatter_add_(1, torch.where(ok, idx, N).reshape(B, -1),
                        torch.ones_like(idx).reshape(B, -1))
    d = degree[:, :N].amax(1, keepdim=True).clamp_min(1)
    lbits = torch.tensor([[32 - (3 * v).bit_length()] for v in d.flatten()
                          .tolist()], device=u.device)
    most = d.double() * (slice_max(ds1) + slice_max(ds2, 2.0) * slice_max(u)
                         + slice_max(dmx) + slice_max(dmn))
    _, e2 = torch.frexp(most)  # most < 2^e2; 0 for most == 0
    return 30 + lbits - e2.long(), lbits


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("edge_moments")
    lib.mlsp_edge_moments.argtypes = [_P] * 6 + [_I] * 11 + [_P]
    lib.mlsp_edge_moments.restype = _I
    lib.mlsp_edge_moments_bwd.argtypes = [_P] * 10 + [_I] * 9 + [_P]
    lib.mlsp_edge_moments_bwd.restype = _I
    return lib


def _plan_args(p: Plan, backward: bool) -> tuple[int, ...]:
    ranges = () if backward else (p.split,)
    return p.cs.bit_length() - 1, *ranges, p.qc, p.kc, p.threads, p.smem


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
    p = plan(B, N, C, k, False)
    u = u.float().contiguous()
    idx = idx.contiguous()
    outs = tuple(torch.empty_like(u) for _ in range(4 if want_moments else 2))
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().mlsp_edge_moments(
            u.data_ptr(), idx.data_ptr(), *ptrs, B, N, C, k,
            int(want_moments), *_plan_args(p, False), stream),
            "edge_moments")
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
    equally among tied neighbours. The kernel sums in fixed point: the same
    inputs give bit-equal du on every launch."""
    _check_graph("edge_moments_bwd_cuda", u, idx)
    B, N, C = u.shape
    k = idx.shape[-1]
    p = plan(B, N, C, k, True)

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
    du = torch.empty_like(u)  # the kernel writes every element
    degree = torch.empty(B, dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().mlsp_edge_moments_bwd(
            u.data_ptr(), idx.data_ptr(), mx.data_ptr(), mn.data_ptr(),
            *[None if t is None else t.data_ptr() for t in cots],
            degree.data_ptr(), du.data_ptr(), B, N, C, k,
            *_plan_args(p, True), stream), "edge_moments")
    edge_moments_bwd_cuda.launches += 1
    return du


edge_moments_bwd_cuda.launches = 0
