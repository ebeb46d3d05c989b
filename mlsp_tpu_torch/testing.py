"""Check helpers shared by the port's tests and `chip_smoke.py`.

The library does not use them. They say how far two routes (the kernels
and the plain versions, or the port and the JAX package) may differ, and
let a second run reuse the first run's discrete choices (kNN graphs, FPS
orders), so that only rounding separates the two runs.
"""

from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import torch

from mlsp_tpu_torch.ops.knn import knn_gather

_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_fps = importlib.import_module("mlsp_tpu_torch.ops.fps")
_normals = importlib.import_module("mlsp_tpu_torch.ops.normals")

U32 = 2.0 ** -24  # float32 unit roundoff


def knn_set_gap(x: torch.Tensor, got: torch.Tensor,
                want: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gap, tol), each [B, N], for two neighbour-index sets [B, N, k] of
    x [B, N, C]: the largest difference of the rows' sorted float64
    distances, and the float32 rounding bound of the distance formula,
    4 (C + 3) u (‖q‖² + max_j ‖x_j‖²). Two correct float32 programs may
    pick different near ties, so rows within tol hold the same
    neighbourhood."""
    xd = x.double()
    sq = xd.square().sum(-1)
    d = sq[:, :, None] + sq[:, None, :] - 2 * xd @ xd.transpose(1, 2)
    gap = (torch.sort(torch.gather(d, -1, got), -1).values
           - torch.sort(torch.gather(d, -1, want), -1).values).abs().amax(-1)
    tol = 4 * (x.shape[-1] + 3) * U32 * (sq + sq.amax(-1, keepdim=True))
    return gap, tol


def edge_grad_magnitude(u: torch.Tensor, idx: torch.Tensor,
                        cots) -> torch.Tensor:
    """Per element of du, the sum of the magnitudes of the terms the
    EdgeConv-statistics backward adds into it, |ds1_i| + |2 u_j ds2_i| +
    |dmx_i| / #ties + |dmn_i| / #ties over the points i that have j as a
    neighbour: the scale of du's rounding error. `cots` is (dmx, dmn) or
    (dmx, dmn, ds1, ds2)."""
    B, N, C = u.shape
    g = knn_gather(u.float(), idx)  # [B, N, k, C]
    per_edge = torch.zeros_like(g)
    for ext, cot in ((g.amax(-2, keepdim=True), cots[0]),
                     (g.amin(-2, keepdim=True), cots[1])):
        tie = g == ext
        per_edge += tie * (cot.abs()[:, :, None]
                           / tie.sum(-2, keepdim=True).clamp_min(1))
    if len(cots) == 4:
        per_edge += cots[2].abs()[:, :, None] + 2 * (g * cots[3][:, :, None]
                                                      ).abs()
    rows = (idx + N * torch.arange(B, device=u.device)[:, None, None]).flatten()
    out = torch.zeros(B * N, C, device=u.device)
    return out.index_add_(0, rows, per_edge.reshape(-1, C)).reshape(B, N, C)


def grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """Per gradient tensor, ‖got − want‖ over the larger of ‖want‖ and the
    norm a tensor of its size has at the RMS of all of `want`'s elements.
    The second term keeps a tensor whose exact gradient is 0 (a bias ahead
    of a train-mode BatchNorm: what is computed is rounding alone) from
    being held relative to its own rounding."""
    wd = {n: w.detach().double().cpu() for n, w in want.items()}
    count = sum(w.numel() for w in wd.values())
    rms = float((sum(w.square().sum() for w in wd.values()) / count).sqrt())
    gaps = {}
    for name, w in wd.items():
        scale = max(float(w.norm()), rms * w.numel() ** 0.5, 1e-30)
        gaps[name] = float((got[name].detach().double().cpu() - w).norm()
                           ) / scale
    return gaps


class Tape:
    """The discrete choices of one run, in call order: the kNN graphs it
    builds (K1's, K3's selection or the plain version's) and its FPS
    orders. `record()` takes them from a run; `replay()` hands them to a
    second run on the plain versions in the same order, and counts how
    many of that run's own choices differed."""

    def __init__(self, graphs=(), orders=()):
        self.graphs, self.orders = list(graphs), list(orders)
        self.own_graph_rows_differ = self.own_order_entries_differ = 0

    @contextlib.contextmanager
    def record(self):
        def keep(fn, into):
            def wrapped(*args):
                out = fn(*args)
                into.append(out)
                return out
            return wrapped

        moments_cuda = _normals.knn_moments_cuda

        def moments(x, k):
            s1, s2, idx = moments_cuda(x, k, return_indices=True)
            self.graphs.append(idx)
            return s1, s2

        with mock.patch.object(_knn, "knn_cuda",
                               keep(_knn.knn_cuda, self.graphs)), \
                mock.patch.object(_knn, "knn_indices_torch",
                                  keep(_knn.knn_indices_torch, self.graphs)), \
                mock.patch.object(_normals, "knn_moments_cuda", moments), \
                mock.patch.object(_fps, "fps_cuda",
                                  keep(_fps.fps_cuda, self.orders)), \
                mock.patch.object(_fps, "fps_torch",
                                  keep(_fps.fps_torch, self.orders)):
            yield self

    @contextlib.contextmanager
    def replay(self):
        graphs, orders = iter(self.graphs), iter(self.orders)
        knn_torch, fps_torch = _knn.knn_indices_torch, _fps.fps_torch

        def take(it, what, like):
            want = next(it, None)
            if want is None or want.shape != like.shape:
                raise RuntimeError(f"replay: the run asks for a {what} of "
                                   f"shape {tuple(like.shape)} that the "
                                   f"recorded run did not build")
            return want.to(device=like.device, dtype=like.dtype)

        def knn(x, k):
            own = knn_torch(x, k)
            want = take(graphs, "kNN graph", own)
            self.own_graph_rows_differ += int(
                (own.sort(-1).values != want.sort(-1).values).any(-1).sum())
            return want

        def fps(xyz, npoint, start_idx):
            own = fps_torch(xyz, npoint, start_idx)
            want = take(orders, "FPS order", own)
            self.own_order_entries_differ += int((own != want).sum())
            return want

        with mock.patch.object(_knn, "knn_indices_torch", knn), \
                mock.patch.object(_fps, "fps_torch", fps):
            yield self
        if next(graphs, None) is not None or next(orders, None) is not None:
            raise RuntimeError("replay: the run left recorded choices unused")
