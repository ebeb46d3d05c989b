"""Port CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a card. This file imports neither JAX nor
`mlsp_tpu`, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.synthetic import (
    make_classification,
    make_segmentation,
)
from mlsp_tpu_torch.ops import edge_moments, estimate_normals, knn_indices
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.kernels import edge as edge_kernels
from mlsp_tpu_torch.ops.kernels import fps as fps_kernels
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
from mlsp_tpu_torch.testing import (
    SEG_METRIC_CASES,
    Tape,
    edge_grad_magnitude,
    grad_gaps,
    knn_set_gap,
    seg_metric_case,
)
from mlsp_tpu_torch.train import (
    make_optimizer,
    pointda_train_step,
    pointsegda_train_step,
)
from mlsp_tpu_torch.transforms.scan import draw_scan, scan_batch
from mlsp_tpu_torch.utils.config import PointDAConfig, PointSegDAConfig

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
    # PointSegDA: a B=16 train forward's C=3 and C=64 graphs, B=32 in eval
    (16, 2048, 3, 20), (16, 2048, 64, 20), (32, 2048, 64, 20),
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


# (N, q0, nq, k) of K1's query range (a points mesh rank's rows): halves
# and quarters of the DGCNN clouds, a q0 off the 32-query tile, a ragged
# last tile, nq below k and one query, the range ending at the cloud's end
KNN_RANGES = [(1024, 0, 512, 20), (1024, 512, 512, 20), (1024, 768, 256, 20),
              (1024, 45, 300, 20), (1000, 500, 500, 20), (1024, 1017, 7, 20),
              (2048, 33, 5, 20), (64, 63, 1, 32), (37, 19, 18, 9)]


@pytest.mark.parametrize("N,q0,nq,k", KNN_RANGES)
@pytest.mark.parametrize("C", [3, 64, 128])
@pytest.mark.parametrize("cloud", ["random", "integer", "zeros"])
def test_knn_kernel_query_range_equals_whole_rows(card, N, q0, nq, k, C,
                                                  cloud):
    """K1 on the queries [q0, q0 + nq) equals rows q0 .. q0 + nq - 1 of the
    whole launch, index for index, on random clouds, integer clouds (many
    exact ties) and clouds with a quarter of exact-zero points (a scan
    batch's ties); a range outside the cloud raises."""
    shape = (3, N, C)
    x = (_int_cloud(N + q0 + C, shape, card) if cloud == "integer"
         else _x(N + q0 + C, shape, card))
    if cloud == "zeros":
        x[:, ::4] = 0.0
    whole = knn_cuda(x, k)
    got = knn_cuda(x, k, (q0, nq))
    assert got.shape == (3, nq, k)
    assert torch.equal(got, whole[:, q0:q0 + nq])
    with pytest.raises(ValueError, match="outside"):
        knn_cuda(x, k, (q0, N - q0 + 1))


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
    Tolerance: K2-bwd sums in fixed point and the plain version in float,
    in another order, so du agrees only to rounding: 1e-5 of the summed
    magnitudes of its terms."""
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


def _bwd_inputs(kind, C, card, B=32, N=1024, k=20):
    """u [B, N, C], a kNN graph and K2-fwd's max and min: on a random cloud,
    on one repeated point (in-degree N, every neighbour tied) or on a
    cloud whose points are 56% (85%) exact zeros, as a `Scan_on_trgt`
    batch's: the zeros' neighbours are the lowest-index zeros, whose
    in-degree is about the number of zeros."""
    x = _x(11, (B, N, 3), card)
    if kind == "repeated point":
        x[:] = 0.5
    elif kind.endswith("% zeros"):
        share = float(kind.split("%")[0]) / 100
        x[torch.rand(B, N, generator=torch.Generator().manual_seed(12))
          .to(card) < share] = 0.0
    idx = knn_cuda(x, k)
    u = _x(13, (B, N, C), card)
    mx, mn = edge_moments_cuda(u, idx, False)
    return u, idx, mx, mn


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["random", "repeated point", "56% zeros"])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_edge_gradient_is_bit_equal_over_launches_and_replays(card, kind, C):
    """K2-bwd sums in fixed point: 10 launches on the same inputs, and 3
    replays of a CUDA graph that captured it, give bit-equal du."""
    u, idx, mx, mn = _bwd_inputs(kind, C, card)
    cots = [_x(14 + i, u.shape, card) for i in range(4)]
    runs = [edge_moments_bwd_cuda(u, idx, mx, mn, *cots) for _ in range(10)]
    static = [t.clone() for t in (u, idx, mx, mn, *cots)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        edge_moments_bwd_cuda(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = edge_moments_bwd_cuda(*static)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(out.clone())
    torch.cuda.synchronize()
    assert all(_same_bits(runs[0], r) for r in runs[1:] + replays)


@pytest.mark.parametrize("case", ["ties", "in-degree >= 800", "N <= k",
                                  "max only"])
def test_edge_gradient_within_tolerance_of_the_plain_version(card, case):
    """K2-bwd against autograd of the plain version, 1e-5 of the summed
    magnitudes of du's terms: on values tied at the max and min, on a
    cloud of 85% zeros (in-degree >= 800), on rows that hold every point
    (N = k = 16) and with the max's cotangent alone (a max over gathered
    u)."""
    if case == "N <= k":
        u = _x(15, (4, 16, 64), card)
        idx = knn_cuda(_x(16, (4, 16, 3), card), 16)
        mx, mn = edge_moments_cuda(u, idx, False)
    else:
        u, idx, mx, mn = _bwd_inputs(
            "85% zeros" if case == "in-degree >= 800" else "random", 64,
            card)
    if case == "ties":
        u[:, 1::2] = u[:, 0::2]
        mx, mn = edge_moments_cuda(u, idx, False)
    if case == "in-degree >= 800":
        assert int(torch.stack([torch.bincount(i.flatten(), minlength=1024)
                                for i in idx]).max()) >= 800
    cots = [_x(20 + i, u.shape, card) for i in range(4)]
    if case == "max only":
        cots = cots[:1] + [None] * 3
    got = edge_moments_bwd_cuda(u, idx, mx, mn, *cots)
    uu = u.clone().requires_grad_()
    used = [(o, c) for o, c in zip(edge_moments_torch(uu, idx, True), cots)
            if c is not None]
    want = torch.autograd.grad([o for o, _ in used], uu,
                               [c for _, c in used])[0]
    mag = edge_grad_magnitude(u, idx, [torch.zeros_like(u) if c is None
                                       else c for c in cots])
    assert ((got - want).abs() <= 1e-5 * mag).all()


def test_dgcnn_paper_step_is_bit_reproducible(card):
    """The DGCNN paper step taken twice from one state and generator seed,
    eagerly and as a chunk of 2 replays of its captured graph: each route's
    two runs bit-equal in losses, gradients, weights, BN statistics and
    Adam's state."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    cfg = dataclasses.replace(PointDAConfig().paper_recipe, batch_size=8,
                              num_points=512)
    x, y = make_classification(4 * cfg.batch_size, cfg.num_points, 10,
                               seed=3)
    x = torch.from_numpy(x).to(card).view(2, 2, cfg.batch_size,
                                          cfg.num_points, 3)
    y = torch.from_numpy(y).to(card).view(2, 2, cfg.batch_size)
    init = make_model("dgcnn", 10, device=card,
                      generator=torch.Generator().manual_seed(0)).state_dict()
    for route in ("eager", "graph"):
        runs = []
        for _ in range(2):
            model = make_model("dgcnn", 10, device=card).train()
            model.load_state_dict(init)
            opt, sched = make_optimizer(model, cfg.lr, cfg.wd, 1, 10)
            gen = torch.Generator(device=card).manual_seed(3)
            if route == "graph":
                m = pointda_train_scan(model, opt, sched, x[:, 0], y[:, 0],
                                       x[:, 1], gen, cfg, Graphs())
            else:
                steps = [pointda_train_step(model, opt, sched, x[i, 0],
                                            y[i, 0], x[i, 1], gen, cfg)
                         for i in range(2)]
                m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
            torch.cuda.synchronize()
            state = _train_state(model, opt, sched, gen)
            state.update({f"grad.{n}": p.grad.clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})
            runs.append((m, state))
        (m0, s0), (m1, s1) = runs
        assert any(k.startswith("grad.") for k in s0), route
        _assert_same_steps(m1, m0, s1, s0)


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
                                        (32, 2048, 2048),  # PointSegDA PCM
                                        (64, 1024, 1024), (3, 2048, 700),
                                        (4, 1024, 300), (3, 2049, 1024),
                                        (4, 4096, 1024), (2, 5000, 700),
                                        (4, 8192, 1024), (2, 9000, 1024),
                                        (3, 16384, 1024), (1, 16384, 16384)])
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


def test_fps_kernel_refuses_clouds_over_the_limit(card):
    """16384 points (the data pipeline's largest bucket) is the limit."""
    assert fps_kernels._lib().mlsp_fps_max_points() == 16384
    x = _x(0, (1, 16385, 3), card)
    with pytest.raises(ValueError, match="16384"):
        fps_cuda(x, 8, torch.zeros(1, dtype=torch.int64, device=card))


@pytest.mark.parametrize("N", [4096, 16384])
def test_fps_wide_kernel_ties_to_lowest_index(card, N):
    """The wide kernels on tiled clouds (the pipeline's padding repeats
    each cloud) and integer coordinates: indices equal the plain version's."""
    x = _x(N, (4, N // 4, 3), card).repeat(1, 4, 1).contiguous()
    x[2:] = _int_cloud(N, (2, N, 3), card)
    start = torch.tensor([0, 5, N - 1, 17], device=card)
    assert torch.equal(fps_cuda(x, 1024, start), fps_torch(x, 1024, start))


def test_fps_kernel_bad_start_gives_minus_one(card):
    x = _x(0, (2, 64, 3), card)
    got = fps_cuda(x, 8, torch.tensor([3, 64], device=card))
    assert (got[1] == -1).all() and (got[0] >= 0).all()


@pytest.mark.parametrize("B,N,k", [(4, 1024, 20), (2, 1000, 20), (3, 37, 9),
                                   (16, 2048, 10)])  # PointSegDA: k = near
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


def test_standardize_clouds_on_the_card_equals_the_plain_route(card):
    """Ragged clouds over every FPS bucket up to the pipeline's largest
    (16384 points): K4 and the plain loop give bitwise equal outputs."""
    from mlsp_tpu_torch.data.pipeline import standardize_clouds

    rng = np.random.default_rng(0)
    sizes = (700, 1024, 1025, 2048, 2049, 3000, 4096, 5000, 8192, 9000,
             16384, 12000)
    clouds = [rng.standard_normal((n, 3)).astype(np.float32) for n in sizes]
    kw = dict(rotate_axis="x", rotate_angle=-np.pi / 2, device=card)
    fps_cuda.launches = 0
    got = standardize_clouds(clouds, 1024, **kw)
    assert fps_cuda.launches == 4  # buckets 2048, 4096, 8192, 16384
    want = standardize_clouds(clouds, 1024, backend="torch", **kw)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="16384"):
        standardize_clouds([np.ones((16385, 3), np.float32)], 1024,
                           device=card)


def test_trainer_one_epoch_checkpoint_loads_on_the_cpu(card, tmp_path):
    from mlsp_tpu_torch.train.pointda_trainer import train_pointda
    from mlsp_tpu_torch.utils import checkpoint

    cfg = PointDAConfig(synthetic=True, epochs=1, num_points=256,
                        save_every=1, out_path=str(tmp_path), exp_name="c"
                        ).paper_recipe
    kernels.reset_launches()
    model, results = train_pointda(cfg)
    assert next(model.parameters()).is_cuda
    # 8 steps, 2 + 2 validation batches, 3 final-test batches
    assert kernels.launches() == {"knn": 115, "edge_moments": 92,
                                  "edge_moments_bwd": 64, "knn_moments": 8,
                                  "fps": 8}
    cpu = make_model("dgcnn", 10, device="cpu")
    epoch, metrics = checkpoint.load_train_state(
        str(tmp_path / "c" / "last.ckpt"), cpu)
    assert epoch == 0 and "src_val_acc" in metrics
    if (tmp_path / "c" / "model.ckpt").exists():  # epoch 0 was the best
        for k, v in model.state_dict().items():
            assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    assert np.isfinite(results["test"]["loss"])


def test_seg_model_kernels_match_plain_and_count(card):
    """A DGCNNSeg eval forward launches K1 4 times and no K2."""
    g = torch.Generator().manual_seed(0)
    model = make_model("dgcnn_seg", 8, device=card, generator=g)
    ref = make_model("dgcnn_seg", 8, device=card, knn_backend="torch")
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(make_segmentation(4, 2048, 8, seed=1)[0]).to(card)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x)["seg"]
        assert kernels.launches() == {**dict.fromkeys(kernels.WRAPPERS, 0),
                                      "knn": 4}
        want = ref(x)["seg"]
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    assert agree >= 0.99 and (got - want).abs().max() <= 2e-2 * (
        want.abs().max())


def test_seg_train_step_launches(card):
    """One MLSP-recipe seg step with PCM at a small size: K1 8, K3 1, K4 1
    (both PCM batches in one launch), no K2; finite losses."""
    cfg = PointSegDAConfig(batch_size=4, num_points=512, apply_PCM=True,
                           DefRec_on_trgt=False, Density_normal_viainput=True,
                           Normal_ondef=True, Density_ondef=True).resolved()
    g = torch.Generator().manual_seed(0)
    model = make_model("dgcnn_seg", 8, device=card, generator=g).train()
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10)
    x, y = make_segmentation(8, 512, 8, seed=1)
    x, y = torch.from_numpy(x).to(card), torch.from_numpy(y).to(card)
    kernels.reset_launches()
    m, (preds, labels) = pointsegda_train_step(
        model, opt, sched, x[:4], y[:4], x[4:],
        torch.Generator(device=card).manual_seed(0), cfg)
    assert kernels.launches() == {"knn": 8, "edge_moments": 0,
                                  "edge_moments_bwd": 0, "knn_moments": 1,
                                  "fps": 1}
    assert all(torch.isfinite(t) for t in m.values())
    assert preds.is_cuda and preds.shape == labels.shape == (4, 512)


def test_kernels_on_a_scan_batch(card):
    """K1 and K2-bwd on a simulated scan (`Scan_on_trgt`): about a quarter
    of the points are exact zeros, so K1 breaks hundreds of exact ties to
    the lowest index and the graph's in-degree runs to the hundreds, K2-bwd's
    heaviest load. K1 by equal sorted distance sets, K2-bwd by du within
    1e-5 of its terms' magnitudes."""
    x = torch.from_numpy(make_classification(4, 1024, 10, seed=3)[0]).to(card)
    g = torch.Generator(device=card).manual_seed(0)
    sx, smask = scan_batch(x, *draw_scan(g, 4))
    assert 0.1 < float((sx == 0).all(-1).float().mean()) < 0.5
    idx = knn_cuda(sx, 20)
    gap, tol = knn_set_gap(sx, idx, knn_indices_torch(sx, 20))
    assert (gap <= tol).all()
    indeg = torch.stack([torch.bincount(i.flatten(), minlength=1024)
                         for i in idx])
    assert int(indeg.max()) >= 100
    u = _x(7, (4, 1024, 64), card)
    cots = [_x(8 + i, (4, 1024, 64), card) for i in range(4)]

    def grad(fn):
        uu = u.clone().requires_grad_()
        loss = sum((a * o).sum() for a, o in zip(cots, fn(uu)))
        return torch.autograd.grad(loss, uu)[0]

    got = grad(lambda uu: edge_moments(sx, uu, 20, True))
    want = grad(lambda uu: edge_moments_torch(uu, idx, True))
    tol = 1e-5 * edge_grad_magnitude(u, idx, cots)
    assert ((got - want).abs() <= tol).all()


ALL_BRANCHES = dict(
    DefRec_on_src=True, apply_PCM=True, Density_normal_viainput_onsrc=True,
    DefRec_on_trgt=True, Norm_on_trgt=True, Scan_on_trgt=True,
    Density_on_trgt=True, Density_normal_viainput=True, Normal_ondef=True,
    Density_ondef=True, apply_SPL_v2=True, gamma_v2=2.31)


def test_all_branch_step_matches_the_plain_route(card):
    """One step of every PointDA branch at B=4, N=512 with eval-mode BN: 9
    forwards (K1 45, K2-fwd 36, K2-bwd 36), 3 normal estimates (K3) and one
    PCM (K4); then the same step through the plain versions on the kernel
    run's kNN graphs and FPS order: every loss term within 1e-4 relative,
    every gradient within 1e-4 (`testing.grad_gaps`)."""
    cfg = dataclasses.replace(PointDAConfig(batch_size=4, num_points=512),
                              debug_bn_eval=True, **ALL_BRANCHES)
    x, y = make_classification(8, 512, 10, seed=1)
    x, y = torch.from_numpy(x).to(card), torch.from_numpy(y[:4]).to(card)

    def step(backend):
        model = make_model("dgcnn", 10, device=card, knn_backend=backend,
                           generator=torch.Generator().manual_seed(0))
        c = dataclasses.replace(cfg, knn_backend=backend)
        opt, sched = make_optimizer(model, c.lr, c.wd, c.epochs, 10)
        m = pointda_train_step(model, opt, sched, x[:4], y, x[4:],
                               torch.Generator(device=card).manual_seed(0), c)
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None})

    tape = Tape()
    kernels.reset_launches()
    with tape.record():
        k_loss, k_grad = step("auto")
    assert kernels.launches() == {"knn": 45, "edge_moments": 36,
                                  "edge_moments_bwd": 36, "knn_moments": 3,
                                  "fps": 1}
    assert (len(tape.graphs), len(tape.orders)) == (48, 1)
    with tape.replay():
        p_loss, p_grad = step("torch")
    assert k_loss["trgt_SPL_selected"] == 1.0
    assert set(p_loss) == set(k_loss) and set(p_grad) == set(k_grad)
    for n, v in k_loss.items():
        assert p_loss[n] == pytest.approx(v, rel=1e-4, abs=1e-12), n
    assert max(grad_gaps(p_grad, k_grad).values()) <= 1e-4


# The other model families. Hengshuang's vector attentions build self-kNN
# graphs at N = 1024 / 4^i (seg: 2048 / 4^i) with k = min(16, N): below
# one 32-query block at N <= 32, where k = N makes every point a neighbour.
@pytest.mark.parametrize("N", [4, 8, 16, 32])
@pytest.mark.parametrize("C", [3, 64])
def test_knn_kernel_below_one_block(card, N, C):
    k = min(16, N)
    x = _x(N + C, (32, N, C), card)
    gap, tol = knn_set_gap(x, knn_cuda(x, k), knn_indices_torch(x, k))
    assert (gap <= tol).all()
    xi = _int_cloud(N + C, (32, N, C), card)
    assert torch.equal(knn_cuda(xi, k), knn_indices_torch(xi, k))


# (B, N, npoint) of the families' FPS launches: PointNet++ 512 of 1024 and
# 128 of 512, PointTransformer 64 of 1024, Hengshuang N/4 per level (seg
# from 2048), B=32 (seg 16)
FAMILY_FPS = [(32, 1024, 512), (32, 512, 128), (32, 1024, 64),
              (32, 1024, 256), (32, 256, 64), (32, 64, 16), (32, 16, 4),
              (16, 2048, 512), (16, 512, 128), (16, 128, 32), (16, 32, 8)]


@pytest.mark.parametrize("B,N,npoint", FAMILY_FPS)
def test_fps_kernel_at_the_family_shapes(card, B, N, npoint):
    x = _x(N + npoint, (B, N, 3), card)
    zero = torch.zeros(B, dtype=torch.int64, device=card)
    assert torch.equal(fps_cuda(x, npoint, zero), fps_torch(x, npoint, zero))
    xi = _int_cloud(N, (B, N, 3), card)
    assert torch.equal(fps_cuda(xi, npoint, zero), fps_torch(xi, npoint, zero))


# launches per forward: (K1, K4), the seg and DefRec heads decoding
FAMILY_FORWARD = {"pointnet": (1024, ("defrec",), 0, 0),
                  "pointnet2": (1024, (), 0, 2),
                  "point_transformer": (1024, ("defrec",), 0, 1),
                  "hengshuang": (1024, (), 5, 4),
                  "hengshuang_seg": (2048, ("seg",), 10, 4)}


@pytest.mark.parametrize("name", list(FAMILY_FORWARD))
def test_family_forward_matches_plain_and_counts(card, name):
    """A full-width eval forward at B=8 through the kernels against the
    same weights on the plain route: K1 and K4 launched as derived, logits
    within 2e-2 (the serving allowance: a near tie may take another
    neighbour)."""
    n, heads, k1, k4 = FAMILY_FORWARD[name]
    classes = 8 if name == "hengshuang_seg" else 10
    g = torch.Generator().manual_seed(0)
    model = make_model(name, classes, device=card, generator=g)
    ref = make_model(name, classes, device=card,
                     **({} if name == "pointnet" else {"knn_backend": "torch"}))
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(make_classification(8, n, 10, seed=3)[0]).to(card)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x, heads)
        launches = kernels.launches()
        want = ref(x, heads)
    assert (launches["knn"], launches["fps"]) == (k1, k4)
    assert kernels.launches() == launches  # the plain route launched none
    for key in want:
        assert torch.isfinite(got[key]).all()
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=2e-2)


# Point-ViT's DGCNN group embedder folds its 64 groups of 32 points into
# the batch: K1 at [B·G, 32, C] = [2048, 32, C] for B=32, k = 20.
@pytest.mark.parametrize("C", [3, 64, 128])
def test_knn_kernel_at_the_vit_embedder_shapes(card, C):
    x = _x(C, (2048, 32, C), card)
    gap, tol = knn_set_gap(x, knn_cuda(x, 20), knn_indices_torch(x, 20))
    assert (gap <= tol).all()
    xi = _int_cloud(C, (2048, 32, C), card)
    assert torch.equal(knn_cuda(xi, 20), knn_indices_torch(xi, 20))


def test_knn_kernels_launch_above_65535_clouds(card):
    """One flat grid axis: 65,543 clouds of 32 points (1,024 groups of a
    folded batch more than gridDim.y takes) launch once and agree index
    for index on integer coordinates, K1 and K3."""
    xi = _int_cloud(7, (65_536 + 7, 32, 3), card)
    want = knn_indices_torch(xi, 20)
    kernels.reset_launches()
    assert torch.equal(knn_cuda(xi, 20), want)
    assert torch.equal(knn_moments_cuda(xi, 20, return_indices=True)[2], want)
    assert kernels.launches()["knn"] == kernels.launches()["knn_moments"] == 1


# launches per vit forward: (K1, K4)
VIT_FORWARD = {"relative": (0, 1), "pointnet": (0, 1), "dgcnn": (5, 1),
               "pointnet_tnet": (0, 1)}


@pytest.mark.parametrize("enc", list(VIT_FORWARD))
def test_vit_forward_matches_plain_and_counts(card, enc):
    """A full-width vit eval forward (with its DefRec head) at B=8 with
    each group embedder, through the kernels against the same weights on
    the plain route: K1 and K4 launched as derived; outputs within 2e-2."""
    g = torch.Generator().manual_seed(0)
    model = make_model("vit", 10, device=card, generator=g,
                       encoder_type=enc)
    ref = make_model("vit", 10, device=card, encoder_type=enc,
                     knn_backend="torch")
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(make_classification(8, 1024, 10, seed=3)[0]).to(card)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x, ("defrec",))
        launches = kernels.launches()
        want = ref(x, ("defrec",))
    assert (launches["knn"], launches["fps"]) == VIT_FORWARD[enc]
    assert kernels.launches() == launches
    for key in want:
        assert torch.isfinite(got[key]).all()
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=2e-2)


def test_from_torch_dgcnn_forward_equals_the_ckpt_forward(card, tmp_path):
    """A DGCNN checkpoint exported to a reference model.pt and read back
    with from_torch gives the checkpoint's forward bit for bit."""
    from mlsp_tpu_torch.utils import checkpoint, reference_export

    g = torch.Generator().manual_seed(1)
    model = make_model("dgcnn", 10, device=card, generator=g)
    ckpt = str(tmp_path / "model.ckpt")
    checkpoint.save_train_state(ckpt, model)
    pt = str(tmp_path / "model.pt")
    reference_export.save(reference_export.export_state_dict(model), pt)
    a = checkpoint.load_model_weights(make_model("dgcnn", 10, device=card),
                                      ckpt)
    b = checkpoint.load_model_weights(make_model("dgcnn", 10, device=card),
                                      pt, from_torch=True)
    x = torch.from_numpy(make_classification(32, 1024, 10, seed=4)[0]).to(card)
    with torch.no_grad():
        assert torch.equal(a(x)["cls"], b(x)["cls"])


@pytest.mark.parametrize("name,N", [("dgcnn", 1024), ("dgcnn_seg", 2048)])
def test_aot_bundle_saved_on_the_cpu_serves_on_the_card(card, tmp_path, name,
                                                        N):
    """A `.pt2` bundle written on the CPU, moved to the card by
    `ServingModel` (`move_to_device_pass`): the plain route on the card,
    no kernel launched, its logits those of the CPU bundle (classes agree
    on >= 99%, max |dprob| <= 2e-2: the serving bounds, near-tie kNN
    edges may differ between the devices' rounding)."""
    from mlsp_tpu_torch import ServingModel, save_aot_bundle

    nc = 8 if name == "dgcnn_seg" else 10
    model = make_model(name, nc, device="cpu", knn_backend="torch",
                       generator=torch.Generator().manual_seed(2))
    save_aot_bundle(model, str(tmp_path / "b"), N, nc)
    x = make_classification(3, N, 10, seed=4)[0]
    want = ServingModel(str(tmp_path / "b"), device="cpu").predict(x)
    served = ServingModel(str(tmp_path / "b"), device=card)
    kernels.reset_launches()
    got = served.predict(x)
    torch.cuda.synchronize()
    assert sum(kernels.launches().values()) == 0
    assert got.shape == want.shape
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    prob = [torch.softmax(torch.from_numpy(a), -1) for a in (got, want)]
    assert float((prob[0] - prob[1]).abs().max()) <= 2e-2


@pytest.mark.parametrize("name,launches", [
    ("dgcnn_seg", {"knn": 4}), ("hengshuang_seg", {"knn": 10, "fps": 4})])
def test_seg_bundle_on_the_card_counts_its_kernels(card, tmp_path, name,
                                                   launches):
    """A seg weights bundle on the card: K1 4 launches a DGCNNSeg forward,
    K1 10 and K4 4 a HengshuangSeg one; per-point logits those of the
    plain route (classes >= 99%, max |dprob| <= 2e-2)."""
    from mlsp_tpu_torch import ServingModel, save_serving_bundle

    model = make_model(name, 8, device=card,
                       generator=torch.Generator().manual_seed(2))
    save_serving_bundle(model, str(tmp_path / "b"), 2048, 8)
    served = ServingModel(str(tmp_path / "b"), device=card)
    x = make_segmentation(4, 2048, 8, seed=3)[0]
    kernels.reset_launches()
    got = served.predict(x)
    want_launches = dict.fromkeys(kernels.launches(), 0)
    want_launches.update(launches)
    assert kernels.launches() == want_launches
    plain = make_model(name, 8, device=card, knn_backend="torch")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = plain(torch.from_numpy(x).to(card), ("seg",))["seg"]
    want = want.cpu().numpy()
    assert got.shape == (4, 2048, 8)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    prob = [torch.softmax(torch.from_numpy(a), -1) for a in (got, want)]
    assert float((prob[0] - prob[1]).abs().max()) <= 2e-2


def test_two_gloo_ranks_share_the_card(card):
    """A paper-recipe step at B=8, N=512 on 2 gloo ranks on the one card
    (NCCL refuses two ranks on one device), through the kernels: the ranks
    bit-equal to each other, each with the launches of a step on its 4
    rows (K1 10, K2-fwd 8, K2-bwd 8) and of the global batch's labels and
    PCM (K3 1, K4 1); one process on the plain route, replaying the ranks'
    graphs and FPS orders, with eval-mode BN and float32 heads, where
    rounding alone separates the runs: losses within 1e-4, gradients
    within 1e-3 (`chip_smoke.DDP_GRAD_RTOL`: weight gradients summed over
    each rank's rows and over all, in other orders, cancel in the early
    layers). Each K1 graph of a rank's rows is held against the plain kNN
    of its input (`Tape.knn_against_plain`). `chip_smoke.py`'s
    `ddp_ingest` holds the train-mode step."""
    from mlsp_tpu_torch.testing import (
        merge_rank_tapes,
        run_ranks,
        step_case,
    )

    cfg = dataclasses.replace(
        PointDAConfig(batch_size=8, num_points=512).paper_recipe,
        debug_bn_eval=True, head_dtype="f32")
    x, y = make_classification(16, 512, 10, seed=1)
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    case = {"kind": "pointda", "model": "dgcnn", "num_class": 10,
            "kwargs": {"head_dtype": "f32"}, "state": model.state_dict(),
            "cfg": cfg, "seed": 5, "device": "cuda:0",
            "batch": {"src_x": torch.from_numpy(x[:8]),
                      "src_y": torch.from_numpy(y[:8]),
                      "trgt_x": torch.from_numpy(x[8:])}}
    r0, r1 = run_ranks(2, step_case, case, backend="gloo", device="cuda:0",
                       timeout_s=120)
    assert r0["metrics"] == r1["metrics"]
    for k, g in r0["grads"].items():
        np.testing.assert_array_equal(g, r1["grads"][k])
    assert r0["launches"] == {"knn": 10, "edge_moments": 8,
                              "edge_moments_bwd": 8, "knn_moments": 1,
                              "fps": 1}
    for r in (r0, r1):  # each K1 graph of a rank's 4 rows against plain kNN
        assert len(r["knn_against_plain"]) == 10
        assert max(c["max_gap_over_tol"] for c in r["knn_against_plain"]
                   ) <= 1.0, r["knn_against_plain"]
    plain = {**case, "kwargs": {"head_dtype": "f32", "knn_backend": "torch"},
             "cfg": dataclasses.replace(cfg, knn_backend="torch")}
    one = step_case(None, plain, merge_rank_tapes((r0, r1), 8))
    assert sum(one["launches"].values()) == 0
    gaps = grad_gaps({k: torch.from_numpy(v) for k, v in r0["grads"].items()},
                     {k: torch.from_numpy(v) for k, v in one["grads"].items()})
    assert max(gaps.values()) <= 1e-3, max(gaps.items(), key=lambda kv: kv[1])
    for k, want in one["metrics"].items():
        assert abs(r0["metrics"][k] - want) <= 1e-4 * max(abs(want), 1e-3), k


# ------------------------------------------------- step graphs (scan_steps)


def _graph_setup(card, seed=0, n=256, b=8, lr=None, name="ADAM",
                 compute_dtype="f32"):
    cfg = PointDAConfig(num_points=n, batch_size=b).paper_recipe
    model = make_model("dgcnn", 10, device=card,
                       generator=torch.Generator().manual_seed(seed),
                       head_dtype="f32", compute_dtype=compute_dtype)
    opt, sched = make_optimizer(model, cfg.lr if lr is None else lr, cfg.wd,
                                2, 4, name)
    x, y = make_classification(3 * b, n, 10, seed=seed + 1)
    x = torch.from_numpy(x).to(card).view(3, b, n, 3)
    y = torch.from_numpy(y).to(card).view(3, b)
    return cfg, model, opt, sched, x, y


@pytest.fixture
def nccl_mesh(card):
    """An NCCL world of one on the card (the CLI's `--mesh_data 1`), torn
    down after the test."""
    import torch.distributed as dist

    from mlsp_tpu_torch import parallel

    parallel.init_local_world("nccl")
    try:
        yield parallel.make_mesh(1, device=card)
    finally:
        dist.destroy_process_group()


def _dgcnn_chunk_vs_eager(card, mesh=None, compute_dtype="f32"):
    """`test_chunk_replays_match_eager_steps`'s comparison, as a rank of
    `mesh` and at `compute_dtype`."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    runs = []
    for route in ("graph", "eager"):
        cfg, model, opt, sched, x, y = _graph_setup(
            card, lr=0.0, name="SGD", compute_dtype=compute_dtype)
        gen = torch.Generator(device=card).manual_seed(3)
        kernels.reset_launches()
        if route == "graph":
            m = pointda_train_scan(model, opt, sched, x, y, x.flip(1), gen,
                                   cfg, Graphs(), mesh)
        else:
            steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                        x[i].flip(0), gen, cfg, mesh)
                     for i in range(3)]
            m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        torch.cuda.synchronize()
        runs.append((m, model, gen.get_state(), kernels.launches(),
                     kernels.launches_in_graphs(), sched.last_epoch))
    (mg, model_g, gs_g, l_g, in_g, e_g), (me, model_e, gs_e, l_e, in_e,
                                         e_e) = runs
    assert torch.equal(gs_g, gs_e) and e_g == e_e == 3
    for k in me:
        torch.testing.assert_close(mg[k], me[k], rtol=1e-4, atol=1e-5)
    buffers = dict(model_e.named_buffers())
    for (n, a), b in zip(model_g.state_dict().items(),
                         model_e.state_dict().values()):
        if n in buffers:
            gap = float((a.double() - b.double()).norm()
                        / max(float(b.double().norm()), 1e-12))
            assert gap <= 1e-4, (n, gap)
        else:
            assert torch.equal(a, b), n
    per_step = {"knn": 10, "edge_moments": 8, "edge_moments_bwd": 8,
                "knn_moments": 1, "fps": 1}
    assert l_g == l_e == in_g == {k: 3 * v for k, v in per_step.items()}
    assert not any(in_e.values())


def test_chunk_replays_match_eager_steps(card):
    """A chunk of 3 replays of the captured paper step against 3 eager
    steps from the same weights and generator seed, SGD at LR 0: each
    replay must take its own batch and draws and give the eager step's
    losses (within 1e-4) and BN statistics (1e-4, relative); the
    generators end in the same state, the schedule took 3 steps, and the
    launches are counted through the replays. LR 0 keeps the weights as
    they are; the update at a nonzero LR is held on PointNet below and on
    DGCNN by `test_dgcnn_paper_step_is_bit_reproducible`."""
    _dgcnn_chunk_vs_eager(card)


def test_bf16_chunk_replays_match_eager_steps(card):
    """The same at `compute_dtype` bf16: the step graph of the bf16 trunk
    (K1 on the bf16 features upcast, K2 on u upcast) against its eager
    steps, with the launches of a float32 step."""
    _dgcnn_chunk_vs_eager(card, compute_dtype="bf16")


def test_nccl_chunk_replays_match_eager_mesh_steps(card, nccl_mesh):
    """An NCCL world of one: a chunk of 3 replays of the captured mesh
    step (global BatchNorm's, the gradients' and the loss terms'
    all-reduces inside the graph) against 3 eager mesh steps, as above."""
    _dgcnn_chunk_vs_eager(card, nccl_mesh)


def _pointnet_setup(card, name="ADAM", lr=1e-3, seed=0, n=256, b=8):
    """PointNet under PCM (K4) and DefRec on the target, 2 epochs of 3
    steps under the cosine."""
    cfg = dataclasses.replace(
        PointDAConfig(num_points=n, batch_size=b).resolved(),
        DefRec_on_trgt=True)
    model = make_model("pointnet", 10, device=card,
                       generator=torch.Generator().manual_seed(seed))
    opt, sched = make_optimizer(model, lr, cfg.wd, 2, 3, name)
    x, y = make_classification(6 * b, n, 10, seed=seed + 1)
    x = torch.from_numpy(x).to(card).view(6, b, n, 3)
    y = torch.from_numpy(y).to(card).view(6, b)
    return cfg, model, opt, sched, x, y


def _train_state(model, opt, sched, gen) -> dict:
    from mlsp_tpu_torch.train.state import lr_tensors

    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in st.items()
                    if torch.is_tensor(v)})
    return {**out, "lr": torch.stack(lr_tensors(opt)).cpu(),
            "gen": gen.get_state(), "sched": torch.tensor(sched.last_epoch)}


def _assert_same_steps(got, want, state_got, state_want) -> None:
    for k in want:
        assert torch.equal(got[k], want[k]), (k, got[k], want[k])
    assert state_got.keys() == state_want.keys()
    for k, v in state_want.items():
        assert torch.equal(state_got[k], v), k


def test_nccl_chunks_take_the_eager_mesh_updates(card, nccl_mesh):
    """An NCCL world of one at a nonzero LR on PointNet (bit-reproducible):
    two chunks of 3 replays of the captured mesh step against 6 eager mesh
    steps, everything bit-equal as in
    `test_chunk_replays_take_the_eager_updates`."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    runs = []
    for route in ("graph", "eager"):
        cfg, model, opt, sched, x, y = _pointnet_setup(card)
        gen = torch.Generator(device=card).manual_seed(3)
        if route == "graph":
            graphs = Graphs()
            chunks = [pointda_train_scan(model, opt, sched, x[c:c + 3],
                                         y[c:c + 3], x[c:c + 3].flip(1), gen,
                                         cfg, graphs, nccl_mesh)
                      for c in (0, 3)]
            assert len(graphs._graphs) == 1
            m = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        else:
            steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                        x[i].flip(0), gen, cfg, nccl_mesh)
                     for i in range(6)]
            m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        torch.cuda.synchronize()
        runs.append((m, _train_state(model, opt, sched, gen)))
    (mg, sg), (me, se) = runs
    _assert_same_steps(mg, me, sg, se)


@pytest.mark.parametrize("name,lr", [("ADAM", 1e-3), ("ADAMW", 1e-3),
                                     ("SGD", 1e-2)])
def test_chunk_replays_take_the_eager_updates(card, name, lr):
    """Two chunks of 3 replays, one an epoch (the cosine halves the LR
    between them), against 6 eager steps from the same weights and
    generator seed at a nonzero LR: the losses, the parameters, the BN
    statistics, the optimizer's state (Adam's moments and step counts,
    SGD's momentum), the LRs, the schedule's count and the generator are
    bit-equal. The optimizer state and LR that one replay leaves are what
    the next reads."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    runs = []
    for route in ("graph", "eager"):
        cfg, model, opt, sched, x, y = _pointnet_setup(card, name, lr)
        gen = torch.Generator(device=card).manual_seed(3)
        if route == "graph":
            graphs = Graphs()
            chunks = [pointda_train_scan(model, opt, sched, x[c:c + 3],
                                         y[c:c + 3], x[c:c + 3].flip(1), gen,
                                         cfg, graphs) for c in (0, 3)]
            m = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
            assert len(graphs._graphs) == 1
        else:
            steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                        x[i].flip(0), gen, cfg)
                     for i in range(6)]
            m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        torch.cuda.synchronize()
        runs.append((m, _train_state(model, opt, sched, gen)))
    (mg, sg), (me, se) = runs
    assert int(se["sched"]) == 6 and any(k.startswith("opt.") for k in se)
    _assert_same_steps(mg, me, sg, se)


def test_chunk_across_an_lr_change_is_refused(card):
    """A step graph reads one LR a chunk: a chunk the schedule would give
    two LRs (steps 2-4, across the first epoch's end) raises, before any
    capture."""
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    cfg, model, opt, sched, x, y = _pointnet_setup(card)
    gen = torch.Generator(device=card).manual_seed(3)
    for i in range(2):
        pointda_train_step(model, opt, sched, x[i], y[i], x[i], gen, cfg)
    with pytest.raises(ValueError, match="crosses a change of the LR"):
        pointda_train_scan(model, opt, sched, x[2:5], y[2:5], x[2:5], gen,
                           cfg)
    assert sched.last_epoch == 2


def test_graph_recaptures_after_load_state_dict(card, tmp_path):
    """A checkpoint written with capturable Adam state resumes into the
    graph route and the eager route alike: `load_train_state` gives the
    optimizer new state tensors, the kept graph no longer matches them and
    is captured again, and the resumed chunk takes the eager steps from
    the same checkpoint bit for bit (losses and state, as above)."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan
    from mlsp_tpu_torch.utils import checkpoint

    cfg, model, opt, sched, x, y = _pointnet_setup(card)
    gen = torch.Generator(device=card).manual_seed(1)
    graphs = Graphs()
    pointda_train_scan(model, opt, sched, x[:3], y[:3], x[:3].flip(1), gen,
                       cfg, graphs)
    first = graphs._graphs[next(iter(graphs._graphs))]
    path = str(tmp_path / "c.ckpt")
    checkpoint.save_train_state(path, model, opt, sched, 0)
    raw = torch.load(path, weights_only=True)
    assert torch.is_tensor(raw["optimizer"]["param_groups"][0]["lr"])
    checkpoint.load_train_state(path, model, opt, sched)
    assert opt.param_groups[0]["capturable"]
    state = gen.get_state()
    got = pointda_train_scan(model, opt, sched, x[3:], y[3:], x[3:].flip(1),
                             gen, cfg, graphs)
    assert graphs._graphs[next(iter(graphs._graphs))] is not first

    _, model_e, opt_e, sched_e, _, _ = _pointnet_setup(card, seed=5)
    checkpoint.load_train_state(path, model_e, opt_e, sched_e)
    gen_e = torch.Generator(device=card).manual_seed(1)
    gen_e.set_state(state)
    want = [pointda_train_step(model_e, opt_e, sched_e, x[3 + i], y[3 + i],
                               x[3 + i].flip(0), gen_e, cfg)
            for i in range(3)]
    _assert_same_steps(got, {k: torch.stack([w[k] for w in want])
                             for k in want[0]},
                       _train_state(model, opt, sched, gen),
                       _train_state(model_e, opt_e, sched_e, gen_e))


def test_adam_at_lr_0_leaves_the_parameters(card):
    """SPST's cosine reaches LR 0. An SPST chunk at LR 0 through the graph
    route (capturable Adam with coupled L2 decay) leaves every parameter
    bit for bit as it was, as torch's non-capturable Adam at LR 0 leaves
    it; among them an element whose value and gradient are 0, so that its
    second moment stays 0 (the capturable update adds eps before it
    divides by the LR)."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.spst import spst_train_scan, spst_train_step
    from mlsp_tpu_torch.train.state import (
        make_epoch_lr_optimizer,
        set_learning_rate,
    )
    from mlsp_tpu_torch.utils.config import SPSTConfig

    cfg = SPSTConfig(num_points=256, batch_size=8, apply_PCM=True)
    xs = [torch.from_numpy(make_classification(3 * 8, 256, 10, seed=s)[0]
                           ).to(card).view(3, 8, 256, 3) for s in (1, 2)]
    ys = [torch.from_numpy(np.random.default_rng(s).integers(0, 10, (3, 8))
                           ).to(card) for s in (1, 2)]
    models = []
    for route in ("graph", "eager"):
        model = make_model("dgcnn", 10, device=card,
                           generator=torch.Generator().manual_seed(0))
        w = next(model.parameters())
        mask = torch.ones_like(w)
        mask.view(-1)[0] = 0.0
        with torch.no_grad():
            w.view(-1)[0] = 0.0
        w.register_hook(lambda g, mask=mask: g * mask)
        before = [p.detach().clone() for p in model.parameters()]
        gen = torch.Generator(device=card).manual_seed(0)
        if route == "graph":
            opt = make_epoch_lr_optimizer(model, "ADAM", 1e-3, 5e-5, 0.9)
            set_learning_rate(opt, 0.0)
            assert opt.param_groups[0]["capturable"]
            m = spst_train_scan(model, opt, *xs[:1], *ys[:1], xs[1], ys[1],
                                0.9, 0.8, gen, cfg, Graphs())
            assert all(torch.isfinite(v).all() for v in m.values())
            v = opt.state[w]["exp_avg_sq"]
            assert float(v.view(-1)[0]) == 0.0 and bool((v.view(-1)[1:] > 0
                                                         ).all())
        else:
            opt = torch.optim.Adam(model.parameters(), lr=0.0,
                                   weight_decay=5e-5)
            for i in range(3):
                spst_train_step(model, opt, xs[0][i], ys[0][i], xs[1][i],
                                ys[1][i], 0.9, 0.8, gen, cfg)
        torch.cuda.synchronize()
        for p, b in zip(model.parameters(), before):
            assert torch.equal(p, b)
        models.append(model)
    for p, q in zip(*(m.parameters() for m in models)):
        assert torch.equal(p, q)


def test_eval_graph_matches_eager_forwards(card):
    """The scanned eval on the card (a captured eval forward, one replay a
    batch, a remainder chunk on the same graph) equals the eager forwards
    and counts K1 5 and K2-fwd 4 a batch."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import eval_scan, scan_in_chunks

    model = make_model("dgcnn", 10, device=card)
    xs = torch.from_numpy(make_classification(5 * 4, 256, 10, seed=2)[0]
                          ).to(card).view(5, 4, 256, 3)
    kernels.reset_launches()
    got = scan_in_chunks(eval_scan, model, xs, chunk=3, graphs=Graphs())
    assert kernels.launches_in_graphs()["knn"] == 25
    with torch.inference_mode():
        want = torch.stack([model(x)["cls"] for x in xs]).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def _paper_trainer(tmp_path, name, eager=False, **kw):
    """One paper-recipe trainer epoch at N=256 (8 steps of B=32, 2 + 2
    validation and 3 test batches) on the card: its metrics.jsonl record,
    run.log, launches and launches inside replays. `eager`: the steps on
    the eager route (`steps.replays_steps` refusing every recipe), the eval
    forwards replayed as ever."""
    from unittest import mock

    from mlsp_tpu_torch.train import steps as steps_mod
    from mlsp_tpu_torch.train.pointda_trainer import train_pointda

    cfg = dataclasses.replace(PointDAConfig(
        synthetic=True, epochs=1, num_points=256, out_path=str(tmp_path),
        exp_name=name).paper_recipe, **kw)
    kernels.reset_launches()
    with mock.patch.object(steps_mod, "replays_steps", lambda x, m: False) \
            if eager else contextlib.nullcontext():
        train_pointda(cfg)
    exp = tmp_path / name
    (rec,) = [json.loads(ln) for ln in (exp / "metrics.jsonl").open()]
    return {"rec": rec, "log": (exp / "run.log").read_text(),
            "launches": kernels.launches(),
            "in_graphs": kernels.launches_in_graphs()}


PAPER_EPOCH = {"knn": 115, "edge_moments": 92, "edge_moments_bwd": 64,
               "knn_moments": 8, "fps": 8}
PAPER_EPOCH_EVALS = {"knn": 35, "edge_moments": 28, "edge_moments_bwd": 0,
                     "knn_moments": 0, "fps": 0}


@pytest.mark.parametrize("scan_steps", [16, 1])
def test_trainer_tail_and_single_steps_replay(card, tmp_path, scan_steps):
    """An 8-step epoch at scan_steps 16 (one tail of 8 replays) and at 1
    (a replay a step): every K1-K4 launch inside graph replays, and the
    losses and validation metrics bit-equal to the eager steps'."""
    got = _paper_trainer(tmp_path, "g", scan_steps=scan_steps)
    want = _paper_trainer(tmp_path, "e", eager=True, scan_steps=scan_steps)
    assert got["launches"] == got["in_graphs"] == PAPER_EPOCH
    assert want["launches"] == PAPER_EPOCH
    assert want["in_graphs"] == PAPER_EPOCH_EVALS
    assert got["rec"]["step_graphs"]
    for k in ("train", "src_val", "trgt_val"):
        assert got["rec"][k] == want["rec"][k], k
    line = ("chunks of 16 steps and the epoch's tail replay one captured "
            "graph" if scan_steps > 1
            else "scan_steps 1: each step replays one captured graph")
    assert line in got["log"]


def test_mix_ratio_draws_replay_as_eager(card):
    """PCM's Beta(a, a) ratios at a = 1e-3, 0.4 and 2.0, 4,096 each,
    drawn inside one CUDA graph from a registered generator: a replay
    equals the same draws taken eagerly from the same state, bit for bit,
    and leaves the generator where they leave it; every λ is finite in
    [0, 1], with a variance within 5 sigma of 1/(4(2a + 1))."""
    from mlsp_tpu_torch.train.steps import draw_mix_ratio

    alphas, n = (1e-3, 0.4, 2.0), 4096

    def draws(gen):
        return [draw_mix_ratio(gen, a, (n,)) for a in alphas]

    gen = torch.Generator(device=card).manual_seed(9)
    state = gen.get_state()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = draws(gen)
    gen.set_state(state)
    graph.replay()
    replayed, after = [t.clone() for t in out], gen.get_state()
    gen.set_state(state)
    eager = draws(gen)
    assert torch.equal(gen.get_state(), after)
    for a, got, want in zip(alphas, replayed, eager):
        assert torch.equal(got, want), a
        lam = got.double().cpu().numpy()
        assert np.isfinite(lam).all() and lam.min() >= 0 and lam.max() <= 1
        # the variance of a sample variance: (mu4 - sigma^4) / n
        var = 1 / (4 * (2 * a + 1))
        mu4 = 3 / (16 * (2 * a + 1) * (2 * a + 3))
        assert abs(lam.var() - var) <= 5 * np.sqrt((mu4 - var ** 2) / n), a


@pytest.mark.parametrize("scan_steps", [1, 8])
def test_pcm_at_mixup_params_0_4_replays(card, tmp_path, scan_steps):
    """PCM at mixup_params 0.4 (its Beta ratio drawn on the card) at
    scan_steps 1 and 8: every K1-K4 launch inside graph replays, and the
    losses and validation metrics bit-equal to the eager steps'."""
    got = _paper_trainer(tmp_path, "m", scan_steps=scan_steps,
                         mixup_params=0.4)
    want = _paper_trainer(tmp_path, "e", eager=True, scan_steps=scan_steps,
                          mixup_params=0.4)
    assert got["launches"] == got["in_graphs"] == PAPER_EPOCH
    assert want["launches"] == PAPER_EPOCH
    assert want["in_graphs"] == PAPER_EPOCH_EVALS
    assert got["rec"]["step_graphs"]
    for k in ("train", "src_val", "trgt_val"):
        assert got["rec"][k] == want["rec"][k], k
    assert "step graphs: on (" in got["log"]


def test_nccl_rank_eval_replays_equal_eager_mesh_forwards(card, nccl_mesh):
    """An NCCL world of one: the eval logits of 5 batches of 5 through the
    rank's captured eval forward, gathered after the replays, bit-equal
    to the eager mesh forwards (`steps.captures` refusing the mesh) and
    to one process's replays, every launch inside the replays."""
    from unittest import mock

    from mlsp_tpu_torch.train import steps as steps_mod
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointda_trainer import (
        eval_batches,
        eval_logits,
    )

    model = make_model("dgcnn", 10, device=card,
                       generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(make_classification(23, 256, 10, seed=6)[0]
                         ).to(card)
    sels, _ = eval_batches(23, 5)
    kernels.reset_launches()
    got = eval_logits(model, x, sels, mesh=nccl_mesh, graphs=Graphs())
    assert kernels.launches() == kernels.launches_in_graphs() == {
        "knn": 25, "edge_moments": 20, "edge_moments_bwd": 0,
        "knn_moments": 0, "fps": 0}
    with mock.patch.object(steps_mod, "captures", lambda mesh: False):
        kernels.reset_launches()
        eager = eval_logits(model, x, sels, mesh=nccl_mesh)
        assert not any(kernels.launches_in_graphs().values())
    one = eval_logits(model, x, sels, graphs=Graphs())
    assert got.shape == (5, 5, 10)
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, one)


# ------------------------------------------------------------------ spans


def _spans_on_and_off(card, run):
    """`run()` with the profiler off, then on (CPU and CUDA activity), on
    fresh state each time: (off's output, on's output, the records, the
    profiler's "mlsp/..." host ranges as (name, start_ns, end_ns))."""
    from torch.profiler import ProfilerActivity, profile

    from mlsp_tpu_torch.utils import profiling

    profiling.clear_spans()
    off = run()
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = run()
    records = profiling.spans()
    profiling.clear_spans()
    ranges = sorted(
        (e.name()[5:], e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("mlsp/")
        and e.device_type() == torch.autograd.DeviceType.CPU)
    for name in {r[0] for r in records}:
        mine = [r for r in records if r[0] == name]
        theirs = [r for r in ranges if r[0] == name]
        assert len(mine) == len(theirs), name
        for (_, s, e, _), (_, ps, pe) in zip(mine, theirs):
            assert abs(s - ps) < 1_000_000 and abs(e - pe) < 1_000_000, (
                name, s - ps, e - pe)
    return off, on, records


def _span_tree(records):
    return [(n, None if p is None else records[p][0])
            for n, _, _, p in records]


def test_replayed_chunks_record_their_spans(card):
    """Two chunks (2 steps, then 1) of the paper step on one `Graphs`
    under the profiler: the first records its capture, then each
    its copy-in, replays, outputs and scheduler steps; the losses and the
    parameters are bit-equal to the same chunks with the profiler off."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    def run():
        cfg, model, opt, sched, x, y = _graph_setup(card)
        gen = torch.Generator(device=card).manual_seed(3)
        graphs = Graphs()
        outs = [pointda_train_scan(model, opt, sched, x[c], y[c],
                                   x[c].flip(1), gen, cfg, graphs)
                for c in (slice(0, 2), slice(2, 3))]
        torch.cuda.synchronize()
        return outs, [p.detach().clone() for p in model.parameters()]

    (outs_off, params_off), (outs_on, params_on), records = (
        _spans_on_and_off(card, run))
    chunk = [("run_chunk", None), ("copy_in", "run_chunk"),
             ("replay", "run_chunk"), ("outputs", "run_chunk"),
             ("scheduler", "run_chunk")]
    assert _span_tree(records) == [
        chunk[0], ("capture", "run_chunk"), *chunk[1:], *chunk]
    for a, b in zip(outs_off, outs_on):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))


def test_replayed_eval_records_its_spans(card):
    """`evaluate_seg` twice on one `Graphs` under the profiler: the first
    call's eval forward records its capture, both their copy-in, replay
    and outputs inside `eval_scan`; the (loss, mIoU, accuracy) are
    bit-equal to the calls with the profiler off."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg

    x, y = make_segmentation(20, 512, 8, seed=5)

    def run():
        model = make_model("dgcnn_seg", 8, device=card,
                           generator=torch.Generator().manual_seed(2))
        graphs = Graphs()
        return [evaluate_seg(model, torch.from_numpy(x).to(card), y, 16,
                             graphs=graphs) for _ in range(2)]

    off, on, records = _spans_on_and_off(card, run)
    assert off == on
    call = [("eval_logits", None), ("eval_index", "eval_logits"),
            ("eval_scan", "eval_logits"), ("copy_in", "eval_scan"),
            ("replay", "eval_scan"), ("outputs", "eval_scan"),
            ("fetch_logits", "eval_logits"), ("eval_metrics", None),
            ("fetch_stats", "eval_metrics")]
    capture = ("capture", "eval_scan")
    assert _span_tree(records) == [*call[:3], capture, *call[3:], *call]


def test_evaluate_seg_reduces_on_the_card(card):
    """`evaluate_seg` with its statistics reduced on the card, against the
    numpy metrics of the same split's logits fetched from the card
    (`eval_logits` on the same graph): mIoU and accuracy equal, the loss
    within 1e-6 of numpy's float32 loss and 1e-12 of its float64 one; ten
    calls on one `Graphs` return bit-equal (loss, mIoU, accuracy)."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointda_trainer import (
        eval_batches,
        eval_logits,
    )
    from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
    from mlsp_tpu_torch.utils import metrics

    x, y = make_segmentation(20, 512, 8, seed=7)
    model = make_model("dgcnn_seg", 8, device=card,
                       generator=torch.Generator().manual_seed(4))
    xs, graphs = torch.from_numpy(x).to(card), Graphs()
    got = [evaluate_seg(model, xs, y, 16, graphs=graphs) for _ in range(10)]
    assert all(g == got[0] for g in got)
    loss, miou, acc = got[0]

    sels, counts = eval_batches(20, 16)
    logits = eval_logits(model, xs, sels, "seg", graphs=graphs)
    want_m = want_a = 0.0
    for lg, sel, n in zip(logits, sels, counts):
        bm, ba = metrics.seg_metrics(y[sel][:n], lg[:n].argmax(-1))
        want_m += bm
        want_a += ba
    assert (miou, acc) == (float(want_m / 20), float(want_a / 20))
    lg = np.concatenate([lg[:n] for lg, n in zip(logits, counts)])
    for dtype, bound in ((np.float32, 1e-6), (np.float64, 1e-12)):
        want = -np.take_along_axis(metrics.log_softmax_np(lg.astype(dtype)),
                                   y[..., None], -1).mean()
        assert abs(loss - want) <= bound * abs(want), dtype


@pytest.mark.parametrize("case", SEG_METRIC_CASES)
def test_evaluate_seg_on_the_card_equals_the_numpy_metrics(card, case):
    """`evaluate_seg` on the card (the eval forward a replayed graph, the
    statistics reduced there) over `testing.seg_metric_case`'s split of
    fixed logits (ties, parts only predicted or only true, one part, a
    padded batch): mIoU and accuracy equal to numpy's `seg_metrics` on
    the same logits and to the same split's on the CPU, the loss within
    1e-12 of numpy's float64 one and of the CPU's; two calls on one
    `Graphs` bit-equal."""
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
    from mlsp_tpu_torch.utils import metrics

    model, x, y, logits, B = seg_metric_case(case, card)
    graphs = Graphs()
    got = [evaluate_seg(model, torch.from_numpy(x).to(card), y, B,
                        graphs=graphs) for _ in range(2)]
    assert got[0] == got[1]
    loss, miou, acc = got[0]
    on_cpu = evaluate_seg(seg_metric_case(case)[0], x, y, B)
    assert (miou, acc) == on_cpu[1:]
    assert abs(loss - on_cpu[0]) <= 1e-12 * abs(on_cpu[0])

    M = len(y)
    want_m = want_a = 0.0
    for s in range(0, M, B):
        bm, ba = metrics.seg_metrics(y[s:s + B], logits[s:s + B].argmax(-1))
        want_m += bm
        want_a += ba
    assert (miou, acc) == (float(want_m / M), float(want_a / M))
    want = -np.take_along_axis(metrics.log_softmax_np(
        logits.astype(np.float64)), y[..., None], -1).mean()
    assert abs(loss - want) <= 1e-12 * abs(want)
