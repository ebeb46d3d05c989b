"""Farthest-point sampling (counterpart of `mlsp_tpu/ops/fps.py`).

`fps` runs the hand-written CUDA kernel (`ops/kernels/fps.py`, K4) on a
CUDA tensor and its plain PyTorch version, below, on a CPU tensor. The
greedy order is prefix-closed: the first m indices of an N-sample order
are the m-sample FPS from the same start, which PCM mixup uses.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.kernels.fps import fps_cuda
from mlsp_tpu_torch.ops.knn import use_kernel


def fps_torch(xyz: torch.Tensor, npoint: int,
              start_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the FPS kernel: the loop of the JAX package's XLA
    path, one [B, N] distance update and argmax per sample.

    The distance is dx*dx + dy*dy + dz*dz, left to right, one elementwise
    op (one rounding) at a time: the kernel computes exactly this, so the
    two give identical indices. `torch.argmax` returns the first maximum,
    which is the lowest-index tie rule.
    """
    B, N, _ = xyz.shape
    x = xyz.float()
    rows = torch.arange(B, device=x.device)
    mind = torch.full((B, N), float("inf"), device=x.device)
    far = start_idx.to(device=x.device, dtype=torch.int64)
    out = torch.empty((B, npoint), dtype=torch.int64, device=x.device)
    for i in range(npoint):
        out[:, i] = far
        diff = x - x[rows, far][:, None, :]
        dx, dy, dz = diff.unbind(-1)
        d = dx * dx + dy * dy + dz * dz
        mind = torch.minimum(mind, d)
        far = torch.argmax(mind, dim=-1)
    return out


def fps(xyz: torch.Tensor, npoint: int, start_idx: torch.Tensor,
        backend: str = "auto") -> torch.Tensor:
    """Greedy farthest-point sampling.

    Args:
      xyz: [B, N, 3] points.
      npoint: number of samples (<= N).
      start_idx: int [B] index of the first sample per cloud.
      backend: "auto" | "cuda" | "torch" (see `ops.knn.use_kernel`).

    Returns:
      int64 [B, npoint] indices; column 0 is start_idx, ties go to the
      lowest index.
    """
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: expected [B, N, 3], got {tuple(xyz.shape)}")
    if not 1 <= npoint <= xyz.shape[1]:
        raise ValueError(f"fps: npoint={npoint} outside [1, {xyz.shape[1]}]")
    if use_kernel(xyz, backend):
        return fps_cuda(xyz, npoint, start_idx)
    return fps_torch(xyz, npoint, start_idx)


def fps_gather(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sampled points: xyz [B, N, C], idx [B, S] -> [B, S, C]."""
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, xyz.shape[-1]))
