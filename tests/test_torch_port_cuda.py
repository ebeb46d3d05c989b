"""Port CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a card. This file imports neither JAX nor
`mlsp_tpu`, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.ops import edge_moments, estimate_normals, knn_indices
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.edge import edge_moments_torch
from mlsp_tpu_torch.ops.fps import fps_torch
from mlsp_tpu_torch.ops.kernels import (
    edge_moments_bwd_cuda,
    edge_moments_cuda,
    fps_cuda,
    knn_cuda,
    knn_moments_cuda,
)
from mlsp_tpu_torch.ops.knn import knn_gather, knn_indices_torch
from mlsp_tpu_torch.testing import edge_grad_magnitude, knn_set_gap
from mlsp_tpu_torch.train import make_optimizer, pointda_train_step
from mlsp_tpu_torch.utils.config import PointDAConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x(seed, shape, device, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:
        x[:, 1::4] = x[:, 0::4][:, : x[:, 1::4].shape[1]]
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("B,N,C,k", [
    (2, 1024, 3, 20), (2, 1000, 64, 20), (1, 1024, 128, 20),
    (3, 37, 5, 4), (1, 64, 256, 32), (2, 50, 3, 1), (1, 33, 7, 9),
])
def test_knn_kernel_matches_plain(card, B, N, C, k):
    x = _x(N + C, (B, N, C), card)
    got = knn_cuda(x, k)
    torch.cuda.synchronize()
    want = knn_indices_torch(x, k)
    assert got.shape == (B, N, k) and got.dtype == torch.int64
    gap, tol = knn_set_gap(x, got, want)
    assert (gap <= tol).all()
    # distinct points: each is its own nearest (its distance is exactly 0)
    assert torch.equal(got[..., 0].cpu(), torch.arange(N).expand(B, N))


def test_knn_kernel_duplicates_lower_index_first(card):
    x = _x(0, (1, 64, 3), card, dup=True)
    got = knn_cuda(x, 4)[0, :, 0].cpu()
    assert torch.equal(got[1::4], torch.arange(0, 64, 4))
    assert torch.equal(got[0::4], torch.arange(0, 64, 4))


@pytest.mark.parametrize("want_moments", [True, False])
@pytest.mark.parametrize("C", [1, 64, 100, 256])
def test_edge_kernel_matches_plain(card, C, want_moments):
    xg, u = _x(1, (2, 300, 16), card), _x(2, (2, 300, C), card)
    idx = knn_cuda(xg, 20)
    got = edge_moments_cuda(u, idx, want_moments)
    want = edge_moments_torch(u, idx, want_moments)
    assert len(got) == len(want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_edge_kernel_bad_index_gives_nan(card):
    u = _x(3, (1, 8, 4), card)
    idx = torch.zeros(1, 8, 2, dtype=torch.int64, device=card)
    idx[0, 3, 1] = 8
    mx, mn = edge_moments_cuda(u, idx, False)
    assert mx[0, 3].isnan().all() and mn[0, 3].isnan().all()
    assert not mx[0, :3].isnan().any()


@pytest.mark.parametrize("want_moments", [True, False])
@pytest.mark.parametrize("C", [1, 64, 256])
def test_edge_gradient_matches_autograd(card, C, want_moments):
    """K2-bwd (through ops.edge.edge_moments) against autograd of the plain
    version on the same graph, with values tied at the max and min.
    Tolerance: the atomics add in a varying order, so du agrees only to
    rounding: 1e-5 of the summed magnitudes of its terms."""
    xg = _x(4, (2, 200, 8), card)
    u = _x(5, (2, 200, C), card)
    u[:, 1::3] = u[:, 0::3][:, : u[:, 1::3].shape[1]]  # ties
    cots = [_x(6 + i, (2, 200, C), card) for i in range(4 if want_moments
                                                         else 2)]
    idx = knn_cuda(xg, 20)

    def grad(fn):
        uu = u.clone().requires_grad_()
        outs = fn(uu)
        loss = sum((a * o).sum() for a, o in zip(cots, outs))
        return torch.autograd.grad(loss, uu)[0]

    edge_moments_bwd_cuda.launches = 0
    got = grad(lambda uu: edge_moments(xg, uu, 20, want_moments))
    assert edge_moments_bwd_cuda.launches == 1
    want = grad(lambda uu: edge_moments_torch(uu, idx, want_moments))
    tol = 1e-5 * edge_grad_magnitude(u, idx, cots)
    assert ((got - want).abs() <= tol).all()


def test_edge_kernel_wrapper_records_no_grad(card):
    u = _x(4, (1, 16, 4), card).requires_grad_()
    idx = knn_cuda(u.detach(), 4)
    with pytest.raises(ValueError, match="ops.edge.edge_moments"):
        edge_moments_cuda(u, idx, True)


@pytest.mark.parametrize("B,N,npoint", [(4, 1024, 1024), (3, 1000, 1000),
                                        (2, 2048, 2048), (5, 37, 20)])
def test_fps_kernel_equals_plain(card, B, N, npoint):
    x = _x(N, (B, N, 3), card)
    start = torch.randint(0, N, (B,), generator=torch.Generator().manual_seed(N)
                          ).to(card)
    got = fps_cuda(x, npoint, start)
    want = fps_torch(x, npoint, start)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], start)


def test_fps_kernel_refuses_clouds_over_2048_points(card):
    x = _x(0, (1, 2049, 3), card)
    with pytest.raises(ValueError, match="2048"):
        fps_cuda(x, 8, torch.zeros(1, dtype=torch.int64, device=card))


def test_fps_kernel_bad_start_gives_minus_one(card):
    x = _x(0, (2, 64, 3), card)
    got = fps_cuda(x, 8, torch.tensor([3, 64], device=card))
    assert (got[1] == -1).all() and (got[0] >= 0).all()


@pytest.mark.parametrize("B,N,k", [(4, 1024, 20), (2, 1000, 20), (3, 37, 9)])
def test_knn_moments_kernel_matches_plain(card, B, N, k):
    x = _x(N + k, (B, N, 3), card)
    s1, s2, idx = knn_moments_cuda(x, k, return_indices=True)
    want_idx = knn_indices_torch(x, k)
    gap, tol = knn_set_gap(x, idx, want_idx)
    assert (gap <= tol).all()
    g = knn_gather(x, idx)  # sums recomputed from the kernel's own graph
    w1 = g.sum(-2)
    w2 = (g[..., :, None] * g[..., None, :]).sum(-3).reshape(B, N, 9)
    assert ((s1 - w1).abs() <= 1e-5 * g.abs().sum(-2) + 1e-30).all()
    assert ((s2 - w2).abs() <= 1e-5 * (g[..., :, None] * g[..., None, :]
                                       ).abs().sum(-3).reshape(B, N, 9)
            + 1e-30).all()
    normals = estimate_normals(x, k)
    plain = estimate_normals(x, k, backend="torch")
    cos = (normals * plain).sum(-1).abs()
    assert (cos > 0.999).float().mean() >= 0.99


def test_dgcnn_kernels_match_plain_and_count(card):
    """The auto path launches K1 5 times and K2 4 times per forward."""
    g = torch.Generator().manual_seed(0)
    model = make_model("dgcnn", 10, device=card, generator=g)
    ref = make_model("dgcnn", 10, device=card, knn_backend="torch")
    ref.load_state_dict(model.state_dict())
    x = _x(5, (4, 1024, 3), card)
    knn_cuda.launches = edge_moments_cuda.launches = 0
    with torch.no_grad():
        got = model(x)
        assert (knn_cuda.launches, edge_moments_cuda.launches) == (5, 4)
        want = ref(x)
    assert (knn_cuda.launches, edge_moments_cuda.launches) == (5, 4)
    torch.testing.assert_close(got["cls"], want["cls"], rtol=0, atol=2e-2)
    assert knn_indices(x, 20).is_cuda


def test_train_step_launches_every_kernel(card):
    """One paper-recipe step at a small size: K1 10, K2-fwd 8, K2-bwd 8,
    K3 1 and K4 2 launches, finite losses."""
    cfg = PointDAConfig(batch_size=4, num_points=512).paper_recipe
    g = torch.Generator().manual_seed(0)
    model = make_model("dgcnn", 10, device=card, generator=g,
                       head_dtype=cfg.head_dtype).train()
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10)
    x, y = make_classification(8, 512, 10, seed=1)
    x = torch.from_numpy(x).to(card)
    kernels.reset_launches()
    m = pointda_train_step(model, opt, sched, x[:4],
                           torch.from_numpy(y[:4]).to(card), x[4:],
                           torch.Generator(device=card).manual_seed(0), cfg)
    assert kernels.launches() == {"knn": 10, "edge_moments": 8,
                                  "edge_moments_bwd": 8, "knn_moments": 1,
                                  "fps": 2}
    assert all(torch.isfinite(t) for t in m.values())
