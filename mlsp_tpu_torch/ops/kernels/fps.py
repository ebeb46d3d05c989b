"""Wrapper of the farthest-point-sampling kernel (`csrc/fps.cu`, K4), the
port of `fps_pallas`.

`fps_cuda` launches the kernel on CUDA tensors or raises; it never falls
back. Its plain version is `ops.fps.fps_torch`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlsp_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fps")
    lib.mlsp_fps.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.mlsp_fps.restype = _I
    lib.mlsp_fps_max_points.argtypes = []
    lib.mlsp_fps_max_points.restype = _I
    return lib


def fps_cuda(xyz: torch.Tensor, npoint: int,
             start_idx: torch.Tensor) -> torch.Tensor:
    """Greedy FPS order of xyz [B, N, 3] from start_idx [B] on the card:
    int64 [B, npoint]. A start outside [0, N) gives a row of -1."""
    if not (xyz.is_cuda and start_idx.device == xyz.device):
        raise ValueError(f"fps_cuda: needs CUDA tensors on one device, got "
                         f"{xyz.device} and {start_idx.device}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3 or start_idx.shape != xyz.shape[:1]:
        raise ValueError(f"fps_cuda: expected xyz [B, N, 3] and start [B], "
                         f"got {tuple(xyz.shape)} and {tuple(start_idx.shape)}")
    B, N, _ = xyz.shape
    lib = _lib()
    if not 1 <= npoint <= N or N > lib.mlsp_fps_max_points():
        raise ValueError(f"fps_cuda: npoint={npoint}, N={N} outside "
                         f"1 <= npoint <= N <= {lib.mlsp_fps_max_points()}")
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    if B == 0:
        return out
    xyz = xyz.float().contiguous()
    start = start_idx.to(torch.int64).contiguous()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.mlsp_fps(xyz.data_ptr(), start.data_ptr(),
                                  out.data_ptr(), B, N, npoint, stream), "fps")
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0
