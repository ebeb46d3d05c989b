"""Port CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a card. This file imports neither JAX nor
`mlsp_tpu`, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.ops import edge_moments, knn_indices
from mlsp_tpu_torch.ops.edge import edge_moments_torch
from mlsp_tpu_torch.ops.kernels import edge_moments_cuda, knn_cuda
from mlsp_tpu_torch.ops.knn import knn_indices_torch

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


def dist_tolerance(x):
    """Per-row bound on how far two float32 evaluations of
    ‖q‖² − 2q·x + ‖x‖² may differ: 4 (C + 3) u max_j(‖q‖² + ‖x_j‖²), u the
    float32 unit roundoff. Rows whose neighbour sets differ only by such
    near ties hold the same neighbourhood up to rounding."""
    xn = x.double()
    sq = xn.square().sum(-1)  # [B, N]
    scale = sq[:, :, None] + sq.amax(-1)[:, None, None]
    return 4 * (x.shape[-1] + 3) * 2.0 ** -24 * scale


def sorted_dists(x, idx):
    xn = x.double()
    d = torch.cdist(xn, xn).square()
    return torch.sort(torch.gather(d, -1, idx), -1).values


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
    gap = (sorted_dists(x, got) - sorted_dists(x, want)).abs()
    assert (gap <= dist_tolerance(x)).all()
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


def test_edge_kernel_refuses_grad(card):
    u = _x(4, (1, 16, 4), card).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        edge_moments(u.detach(), u, 4)


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
