"""The yardstick's counts: each configuration's operation count against a
hand sum at a small shape, and the frozen kernel cost functions against
`chip_smoke.py`'s, where they were copied from."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, costs  # noqa: E402


def small(cell, B, N, k):
    cfg = dict(cell.ref_cfg)
    cfg.update(batch_size=B, num_points=N, k=k)
    return cfg


def test_dgcnn_step_ops_hand_sum():
    cell = core.load_cell("pointda_dgcnn.train_paper")
    B, N, k = 2, 8, 4
    cfg = small(cell, B, N, k)
    P, E = B * N, B * N * k
    # one trunk forward, by hand: transform net (conv2d1 per point as u, v;
    # conv2d2 per edge; conv2d3; fc1, fc2, fc3), the EdgeConv layers per
    # point (u and v: 3->64, 64->64, 64->128, 128->256), conv5, classifier
    transform = (2 * P * (3 * 64) * 2 + 2 * E * (64 * 128) + 2 * P * 128 * 1024
                 + 2 * B * (1024 * 512 + 512 * 256 + 256 * 9))
    edge = 2 * P * 2 * (3 * 64 + 64 * 64 + 64 * 128 + 128 * 256)
    conv5 = 2 * P * 512 * 1024
    cls = 2 * B * (1024 * 512 + 512 * 256 + 256 * 10)
    trunk = transform + edge + conv5 + cls
    heads = (2 * 2 * P * (512 * 256 + 256 * 256 + 256 * 128 + 128 * 3)
             + 2 * 2 * B * 1024 * 256
             + 2 * P * (512 * 512 + 512 * 256 + 256 * 256 + 256 * 16 + 16)
             + 2 * B * 1024 * 512)
    ops = cell.ref.train_step_ops(cfg)
    assert ops["f32"] == 3 * 2 * trunk
    assert ops["bf16"] == 3 * heads
    assert cell.ref.eval_cloud_ops(small(cell, 1, N, k))["f32"] == (
        2 * N * 3 * 64 * 2 + 2 * N * k * 64 * 128 + 2 * N * 128 * 1024
        + 2 * (1024 * 512 + 512 * 256 + 256 * 9)
        + 2 * N * 2 * (3 * 64 + 64 * 64 + 64 * 128 + 128 * 256)
        + 2 * N * 512 * 1024 + 2 * (1024 * 512 + 512 * 256 + 256 * 10))


def test_dgcnn_seg_step_ops_hand_sum():
    cell = core.load_cell("pointsegda_dgcnnseg.train_mlsp_pcm")
    B, N, k = 2, 8, 4
    cfg = small(cell, B, N, k)
    P, E = B * N, B * N * k
    transform = (2 * P * (3 * 64) * 2 + 2 * E * (64 * 128) + 2 * P * 128 * 1024
                 + 2 * B * (1024 * 512 + 512 * 256 + 256 * 9))
    blocks = 2 * P * 2 * (3 * 64 + 64 * 64 + 64 * 64 + 64 * 64 + 64 * 64)
    conv6 = 2 * P * 192 * 1024
    trunk = transform + blocks + conv6

    def head(out):
        return (2 * P * (192 * 256 + 256 * 256 + 256 * 128 + 128 * out)
                + 2 * B * 1024 * 256)

    density = (2 * P * (192 * 512 + 512 * 256 + 256 * 256 + 256 * 16 + 16)
               + 2 * B * 1024 * 512)
    fwd = 2 * trunk + head(8) + head(3) + head(3) + density
    assert cell.ref.train_step_ops(cfg) == {"f32": 3 * fwd, "bf16": 0.0}
    one = small(cell, 1, N, k)
    assert cell.ref.eval_cloud_ops(one)["f32"] == (
        2 * N * 3 * 64 * 2 + 2 * N * k * 64 * 128 + 2 * N * 128 * 1024
        + 2 * (1024 * 512 + 512 * 256 + 256 * 9)
        + 2 * N * 2 * (3 * 64 + 4 * 64 * 64) + 2 * N * 192 * 1024
        + 2 * N * (192 * 256 + 256 * 256 + 256 * 128 + 128 * 8)
        + 2 * 1024 * 256)


def test_graph_lists():
    da = core.load_cell("pointda_dgcnn.train_paper")
    seg = core.load_cell("pointsegda_dgcnnseg.eval_split")
    assert da.ref.train_knn_graphs(da.ref_cfg) == 2 * [
        (32, 1024, 3), (32, 1024, 3), (32, 1024, 64), (32, 1024, 64),
        (32, 1024, 128)]
    assert da.ref.train_edge_backwards(da.ref_cfg) == 2 * [
        (32, 1024, 64), (32, 1024, 64), (32, 1024, 128), (32, 1024, 256)]
    assert seg.ref.knn_graphs(seg.ref_cfg, 32) == [
        (32, 2048, 3), (32, 2048, 3), (32, 2048, 64), (32, 2048, 64)]
    assert seg.ref.train_edge_backwards(seg.ref_cfg) == []


@pytest.mark.parametrize("b,n,c,k", [(32, 1024, 64, 20), (3, 100, 7, 5)])
def test_costs_match_chip_smoke(b, n, c, k):
    import chip_smoke as cs

    x = torch.zeros(b, n, c)
    assert costs.knn_cost(b, n, c, k) == cs.knn_cost(x, k)
    assert costs.knn_cost(b, n, c, k, nq=n // 2) == cs.knn_cost(x, k, n // 2)
    idx = torch.zeros(b, n, cs.K, dtype=torch.long)
    for moments in (False, True):
        assert costs.edge_cost(b, n, c, cs.K, moments) == cs.edge_cost(
            x, idx, moments)
    assert costs.edge_bwd_cost(b, n, c, k) == cs.edge_bwd_cost(x, k)
    assert costs.fps_cost(b, n) == cs.fps_cost(b, n)
    assert costs.fps_cost(b, n, n // 2) == cs.fps_cost(b, n, n // 2)
    assert costs.knn_moments_cost(b, n, k) == cs.knn_moments_cost(b, n, k)
    flops, nbytes = costs.knn_cost(b, n, c, k)
    assert costs.bound(flops, nbytes) * 1e3 == cs.bound(flops, nbytes)[0]
    assert (costs.PEAK_F32_FLOPS, costs.PEAK_BYTES) == (cs.PEAK_F32_FLOPS,
                                                        cs.PEAK_BYTES)


def test_least_step_seconds_per_precision():
    assert costs.least_step_seconds({"f32": 67e12, "bf16": 989e12}) == 2.0
