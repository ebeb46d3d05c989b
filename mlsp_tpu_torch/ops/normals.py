"""Surface normals by kNN-PCA (counterpart of `mlsp_tpu/ops/normals.py`).

Per point, the smallest eigenvector of the covariance of its k nearest
points (self included), in closed form, flipped toward the origin as PCL's
`flipNormalTowardsViewpoint(0, 0, 0)` does. On a CUDA tensor the
neighbourhood sums come from the kNN-moments kernel (K3) and the
covariance is s2/k − μμᵀ, as the JAX package's Pallas route forms it; on a
CPU tensor the plain route gathers the neighbours and takes their centred
covariance, as its XLA route does.
"""

from __future__ import annotations

import math

import torch

from mlsp_tpu_torch.ops.kernels.normals import knn_moments_cuda
from mlsp_tpu_torch.ops.knn import (
    knn_gather,
    knn_indices,
    knn_indices_torch,
    use_kernel,
)

_EPS = 1e-12


def knn_moments_torch(x: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the K3 kernel: (s1 [B, N, 3], s2 [B, N, 9]) sums of
    the k nearest points' coordinates and outer products (row-major)."""
    g = knn_gather(x.float(), knn_indices_torch(x, k))  # [B, N, k, 3]
    s2 = (g[..., :, None] * g[..., None, :]).sum(-3)
    return g.sum(-2), s2.reshape(*s2.shape[:-2], 9)


def _smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for the smallest eigenvalue of symmetric A [..., 3, 3]
    (trigonometric eigenvalues, then the null space of A − λI by cross
    products of its rows; degenerate neighbourhoods fall back to z)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, _EPS) / 6.0)

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    det_b = (b00 * (b11 * b22 - b12 * b12)
             - b01 * (b01 * b22 - b12 * b02)
             + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1, keepdim=True)
    n02 = (c02 * c02).sum(-1, keepdim=True)
    n12 = (c12 * c12).sum(-1, keepdim=True)
    v = torch.where(n01 >= n02, c01, c02)
    nbest = torch.maximum(n01, n02)
    v = torch.where(nbest >= n12, v, c12)
    nbest = torch.maximum(nbest, n12)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    degenerate = (p2[..., None] < 1e-10) | (nbest < _EPS)
    v = torch.where(degenerate, fallback, v)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(_EPS)


def estimate_normals(xyz: torch.Tensor, k: int = 20,
                     backend: str = "auto") -> torch.Tensor:
    """Per-point unit normals [B, N, 3] of xyz [B, N, 3] from kNN-PCA,
    flipped toward the origin.

    Args:
      xyz: [B, N, 3] points.
      k: neighbourhood size (the reference's `--near`; self included).
      backend: "auto" | "cuda" | "torch" (see `ops.knn.use_kernel`).
    """
    x = xyz.float()
    if use_kernel(x, backend):
        s1, s2 = knn_moments_cuda(x, k)
        mu = s1 / float(k)
        cov = (s2.reshape(*s2.shape[:-1], 3, 3) / float(k)
               - mu[..., :, None] * mu[..., None, :])
    else:
        neigh = knn_gather(x, knn_indices(x, k, backend=backend))
        centered = neigh - neigh.mean(-2, keepdim=True)
        cov = torch.einsum("...ki,...kj->...ij", centered, centered) / float(k)
    n = _smallest_eigvec_3x3(cov)
    return torch.where((n * x).sum(-1, keepdim=True) > 0.0, -n, n)
