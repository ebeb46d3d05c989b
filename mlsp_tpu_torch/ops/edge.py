"""EdgeConv neighbourhood statistics (counterpart of
`mlsp_tpu/ops/pallas/edge_pallas.py::edge_moments`).

For graph features xg and projected features u, each point's max, min and,
on request, sum and sum of squares of u over its k nearest neighbours in
xg. The TPU kernel rebuilt the kNN selection as a mask and reduced with
mask matmuls because Mosaic has no in-kernel gather; on the card the graph
comes from the kNN kernel (K1), a second kernel gathers the neighbour rows
(K2-fwd) and a third scatters the gradient back (K2-bwd), in fixed point so
that its sums do not depend on their order: the same inputs give the same
du on every run, as on the TPU. The three are tied together as a
`torch.autograd.Function`. The graph features get no gradient, as in the
JAX package: the selection is piecewise constant in xg.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.ops.kernels.edge import (
    edge_moments_bwd_cuda,
    edge_moments_cuda,
)
from mlsp_tpu_torch.ops.knn import knn_gather, knn_indices, use_kernel


def edge_moments_torch(u: torch.Tensor, idx: torch.Tensor,
                       want_moments: bool) -> tuple[torch.Tensor, ...]:
    """Plain version of the statistics kernel on given neighbour indices,
    differentiable by autograd: `amax`/`amin` share the gradient equally
    among tied neighbours, as `jnp.max` does and as K2-bwd does."""
    g = knn_gather(u.float(), idx)  # [B, N, k, C]
    outs = (g.amax(-2), g.amin(-2))
    if want_moments:
        outs += (g.sum(-2), (g * g).sum(-2))
    return outs


class EdgeMoments(torch.autograd.Function):
    """K1 + K2-fwd forward, K2-bwd backward."""

    @staticmethod
    def forward(ctx, xg, u, k, want_moments):
        idx = knn_indices(xg.detach(), k, backend="cuda")
        outs = edge_moments_cuda(u, idx, want_moments)
        ctx.save_for_backward(u, idx, outs[0], outs[1])
        # A cotangent that no loss reaches stays None and reaches the
        # kernel as a null pointer, which skips its term.
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *cots):
        u, idx, mx, mn = ctx.saved_tensors
        du = None
        if ctx.needs_input_grad[1] and any(c is not None for c in cots):
            du = edge_moments_bwd_cuda(u, idx, mx, mn, *cots)
        return None, du, None, None


def edge_moments(xg: torch.Tensor, u: torch.Tensor, k: int,
                 want_moments: bool = True,
                 backend: str = "auto") -> tuple[torch.Tensor, ...]:
    """kNN neighbourhood statistics of `u` over the graph of `xg`.

    Args:
      xg: [B, N, Cg] features the kNN graph is built on (no gradient).
      u: [B, N, C] features to aggregate (self included, like
        `knn_indices`); differentiable.
      k: neighbourhood size.
      want_moments: also return the sum and sum of squares.
      backend: "auto" | "cuda" | "torch" (see `ops.knn.use_kernel`).

    Returns:
      (mx, mn, s1, s2), each float32 [B, N, C], or (mx, mn) if not
      `want_moments`.
    """
    if use_kernel(u, backend):
        return EdgeMoments.apply(xg, u, k, want_moments)
    idx = knn_indices(xg.detach(), k, backend=backend)
    return edge_moments_torch(u, idx, want_moments)
