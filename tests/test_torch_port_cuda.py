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
from mlsp_tpu_torch.ops.kernels import edge as edge_kernels
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


def _int_cloud(seed, shape, device):
    """Coordinates in {-2, ..., 2}: every kNN distance is an exact float32
    integer in any order of the sums, and many of them are equal."""
    x = np.random.default_rng(seed).integers(-2, 3, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("N", [33, 1000, 1024, 2048])
@pytest.mark.parametrize("C", [3, 64, 128, 256])
@pytest.mark.parametrize("k", [1, 4, 16, 20, 32])
def test_knn_kernel_exact_order_on_integer_points(card, k, C, N):
    """With exact distances two correct programs agree to the index: K1's
    (and at C = 3 K3's) indices equal the plain version's, tie order
    included."""
    x = _int_cloud(1000 * k + C + N, (2, N, C), card)
    want = knn_indices_torch(x, k)
    assert torch.equal(knn_cuda(x, k), want)
    if C == 3:
        assert torch.equal(knn_moments_cuda(x, k, return_indices=True)[2],
                           want)


@pytest.mark.parametrize("C", [3, 64])
def test_knn_kernel_one_repeated_point(card, C):
    """Every distance 0: each row is 0 .. k-1 (ties to the lower index)."""
    x = torch.full((2, 1000, C), 0.25, device=card)
    want = torch.arange(20, device=card).expand(2, 1000, 20)
    assert torch.equal(knn_indices_torch(x, 20), want)
    assert torch.equal(knn_cuda(x, 20), want)
    if C == 3:
        assert torch.equal(knn_moments_cuda(x, 20, return_indices=True)[2],
                           want)


def test_knn_kernel_duplicates_lower_index_first(card):
    x = _x(0, (1, 64, 3), card, dup=True)
    got = knn_cuda(x, 4)[0, :, 0].cpu()
    assert torch.equal(got[1::4], torch.arange(0, 64, 4))
    assert torch.equal(got[0::4], torch.arange(0, 64, 4))


def _sums_within(got, want, u, idx):
    """s1 and s2 within 1e-5 of the summed magnitudes of their terms."""
    scale = (edge_moments_torch(u.abs(), idx, True)[2], want[3])
    for g, w, m in zip(got[2:], want[2:], scale):
        assert ((g - w).abs() <= 1e-5 * m).all()


@pytest.mark.parametrize("want_moments", [True, False])
@pytest.mark.parametrize("C", [1, 64, 100, 256])
@pytest.mark.parametrize("N", [200, 300, 1000, 2048])
def test_edge_kernel_matches_plain(card, N, C, want_moments):
    """Ragged N (N = 200 also takes 512 threads a block, N = 1000 several
    query ranges) and C not a multiple of the channel slice: max and min
    bit-equal, sums within rtol = atol = 1e-5 and within 1e-5 of their
    summed magnitudes."""
    xg, u = _x(1, (2, N, 16), card), _x(2, (2, N, C), card)
    idx = knn_cuda(xg, 20)
    got = edge_moments_cuda(u, idx, want_moments)
    want = edge_moments_torch(u, idx, want_moments)
    assert len(got) == len(want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if want_moments:
        _sums_within(got, want, u, idx)


def _repeated_point_graph(B, N, device, k=20):
    """A cloud of one repeated point: every row's neighbours are the k
    lowest indices, each a neighbour of all N rows."""
    idx = knn_cuda(torch.full((B, N, 3), 0.5, device=device), k)
    assert torch.equal(idx, torch.arange(k, device=device).expand(B, N, k))
    return idx


@pytest.mark.parametrize("C", [3, 64])
def test_edge_kernel_repeated_point(card, C):
    u = _x(3, (2, 1024, C), card)
    idx = _repeated_point_graph(2, 1024, card)
    got = edge_moments_cuda(u, idx, True)
    want = edge_moments_torch(u, idx, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _sums_within(got, want, u, idx)


def test_edge_kernel_sums_repeat_bit_for_bit(card):
    """The forward has no atomics: two launches give the same bits."""
    u = _x(4, (4, 1000, 64), card)
    idx = knn_cuda(_x(5, (4, 1000, 8), card), 20)
    first = edge_moments_cuda(u, idx, True)
    second = edge_moments_cuda(u, idx, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("N,C,k", [(300, 5, 5000), (700, 24, 300)])
def test_edge_kernels_long_neighbour_rows(card, N, C, k):
    """k far beyond a kNN graph's (indices drawn at random, repeats
    allowed): the kernels stage the indices in chunks of neighbours."""
    u = _x(6, (1, N, C), card)
    idx = torch.randint(0, N, (1, N, k),
                        generator=torch.Generator().manual_seed(k)).to(card)
    got = edge_moments_cuda(u, idx, True)
    want = edge_moments_torch(u, idx, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _sums_within(got, want, u, idx)
    cots = [_x(7 + i, u.shape, card) for i in range(4)]
    du = edge_moments_bwd_cuda(u, idx, want[0], want[1], *cots)
    uu = u.clone().requires_grad_()
    ref = torch.autograd.grad(edge_moments_torch(uu, idx, True), uu, cots)[0]
    assert ((du - ref).abs() <= 1e-5 * edge_grad_magnitude(u, idx, cots)).all()


def test_edge_kernel_bad_index_gives_nan(card):
    u = _x(3, (1, 8, 4), card)
    idx = torch.zeros(1, 8, 2, dtype=torch.int64, device=card)
    idx[0, 3, 1] = 8
    idx[0, 5, 0] = -1
    mx, mn = edge_moments_cuda(u, idx, False)
    assert mx[0, 3].isnan().all() and mn[0, 3].isnan().all()
    assert mx[0, 5].isnan().all()
    assert not mx[0, :3].isnan().any()
    # the backward skips the two edges: du as if they were absent
    cot = _x(4, (1, 8, 4), card)
    du = edge_moments_bwd_cuda(u, idx, mx.nan_to_num(), mn.nan_to_num(), None,
                               None, cot, None)
    want = torch.zeros_like(u[0]).index_add_(
        0, idx[0][(idx[0] >= 0) & (idx[0] < 8)],
        cot[0][:, None].expand(8, 2, 4)[(idx[0] >= 0) & (idx[0] < 8)])
    torch.testing.assert_close(du[0], want)


@pytest.mark.parametrize("want_moments", [True, False])
@pytest.mark.parametrize("C", [1, 64, 100, 256])
@pytest.mark.parametrize("N", [200, 1000])
def test_edge_gradient_matches_autograd(card, N, C, want_moments):
    """K2-bwd (through ops.edge.edge_moments) against autograd of the plain
    version on the same graph, with values tied at the max and min.
    Tolerance: the shared-memory atomics add in a varying order, so du
    agrees only to rounding: 1e-5 of the summed magnitudes of its terms."""
    xg = _x(4, (2, N, 8), card)
    u = _x(5, (2, N, C), card)
    u[:, 1::3] = u[:, 0::3][:, : u[:, 1::3].shape[1]]  # ties
    cots = [_x(6 + i, (2, N, C), card) for i in range(4 if want_moments
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


@pytest.mark.parametrize("C", [3, 64])
def test_edge_gradient_repeated_point(card, C):
    """Every row's neighbours are the same k rows: the backward's additions
    all land on them (in-degree N), with ties in u."""
    u = _x(5, (2, 1024, C), card)
    u[:, 1::2] = u[:, 0::2]
    idx = _repeated_point_graph(2, 1024, card)
    mx, mn = edge_moments_torch(u, idx, False)
    cots = [_x(6 + i, u.shape, card) for i in range(4)]
    got = edge_moments_bwd_cuda(u, idx, mx, mn, *cots)
    uu = u.clone().requires_grad_()
    want = torch.autograd.grad(edge_moments_torch(uu, idx, True), uu, cots)[0]
    assert ((got - want).abs() <= 1e-5 * edge_grad_magnitude(u, idx, cots)
            ).all()


def test_edge_kernels_at_the_point_limit(card):
    """N = N_MAX runs, staging each block's indices in chunks smaller than
    its query range; one point more raises."""
    n = edge_kernels.N_MAX
    u = _x(8, (2, n, 100), card)
    idx = knn_cuda(_x(9, (2, n, 3), card), 20)
    got = edge_moments_cuda(u, idx, True)
    want = edge_moments_torch(u, idx, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cots = [_x(10 + i, u.shape, card) for i in range(4)]
    du = edge_moments_bwd_cuda(u, idx, want[0], want[1], *cots)
    uu = u.clone().requires_grad_()
    ref = torch.autograd.grad(edge_moments_torch(uu, idx, True), uu, cots)[0]
    assert ((du - ref).abs() <= 1e-5 * edge_grad_magnitude(u, idx, cots)).all()
    big = torch.zeros(1, n + 1, 4, device=card)
    big_idx = torch.zeros(1, n + 1, 4, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match=str(n)):
        edge_moments_cuda(big, big_idx, True)
    with pytest.raises(ValueError, match=str(n)):
        edge_moments_bwd_cuda(big, big_idx, big, big, big, big)


def test_edge_kernel_wrapper_records_no_grad(card):
    u = _x(4, (1, 16, 4), card).requires_grad_()
    idx = knn_cuda(u.detach(), 4)
    with pytest.raises(ValueError, match="ops.edge.edge_moments"):
        edge_moments_cuda(u, idx, True)


@pytest.mark.parametrize("B,N,npoint", [(4, 1024, 1024), (3, 1000, 1000),
                                        (2, 2048, 2048), (5, 37, 20),
                                        (64, 1024, 1024), (3, 2048, 700),
                                        (4, 1024, 300)])
def test_fps_kernel_equals_plain(card, B, N, npoint):
    x = _x(N, (B, N, 3), card)
    start = torch.randint(0, N, (B,), generator=torch.Generator().manual_seed(N)
                          ).to(card)
    got = fps_cuda(x, npoint, start)
    want = fps_torch(x, npoint, start)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], start)


@pytest.mark.parametrize("ties", ["duplicated", "integer"])
def test_fps_kernel_ties_to_lowest_index(card, ties):
    """Equal min-distances: every odd point repeats its predecessor, or
    integer coordinates in {-2, ..., 2}; at [2B, N] = [64, 1024] (PCM's
    one launch) the indices equal the plain version's."""
    if ties == "duplicated":
        x = _x(7, (64, 1024, 3), card)
        x[:, 1::2] = x[:, 0::2]
    else:
        x = _int_cloud(7, (64, 1024, 3), card)
    start = torch.randint(0, 1024, (64,),
                          generator=torch.Generator().manual_seed(7)).to(card)
    assert torch.equal(fps_cuda(x, 1024, start), fps_torch(x, 1024, start))


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
    K3 1 and K4 1 (both PCM batches in one launch), finite losses."""
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
                                  "fps": 1}
    assert all(torch.isfinite(t) for t in m.values())
