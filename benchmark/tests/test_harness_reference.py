"""The plain references against the port's plain route on the CPU at small
sizes (N <= 256): the same weights, clouds and generator state give the
same outputs, losses and draws."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, data, train, weights  # noqa: E402

CPU = torch.device("cpu")


def small_cell(name, n=128, b=4, head_dtype=None):
    cell = core.load_cell(name)
    h = cell.config["hyper"]
    h.update(num_points=n, batch_size=b, test_batch_size=b)
    if head_dtype:
        h["head_dtype"] = head_dtype
    cell.config["data"].update(source_train=2 * b, target_train=2 * b)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(cell, seed=3):
    cfg = train.port_config(cell, CPU)
    src_x, src_y, trgt_x, _, _ = train.make_data(cell, seed, CPU)
    w0 = weights.make(cell.ref.spec(cell.ref_cfg), seed, CPU,
                      cell.ref_cfg["pergroup"])
    return cfg, train.make_model(cell, cfg, CPU, w0), w0, src_x, src_y, trgt_x


@pytest.mark.parametrize("name", ["pointda_dgcnn.serve_mix",
                                  "pointsegda_dgcnnseg.eval_split"])
def test_eval_forward_matches_port(name):
    cell = small_cell(name)
    _, model, w0, x, _, _ = setup(cell)
    model.eval()
    with torch.no_grad():
        got = model(x[:4], ("seg",) if "seg" in name else ())
    got = got["seg" if "seg" in name else "cls"]
    ref = cell.ref.eval_logits(w0, x[:4], cell.ref_cfg)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,head_dtype,tol", [
    ("pointda_dgcnn.train_paper", "f32", 1e-6),
    ("pointda_dgcnn.train_paper", "bf16", 1e-3),
    ("pointsegda_dgcnnseg.train_mlsp_pcm", None, 1e-6)])
def test_train_step_matches_port(name, head_dtype, tol):
    """One step's loss and draws: the port's eager step and the reference
    from the same generator state; the reference leaves the generator
    where the port's step leaves it."""
    from mlsp_tpu_torch.train import seg_steps, steps

    cell = small_cell(name, head_dtype=head_dtype)
    cfg, model, w0, src_x, src_y, trgt_x = setup(cell)
    b = slice(0, cfg.batch_size)
    g = torch.Generator().manual_seed(5)
    sx = steps.augment_batch(src_x[b], *steps.draw_augment(g, src_x[b]))
    tx = steps.augment_batch(trgt_x[b], *steps.draw_augment(g, trgt_x[b]))
    if "seg" in name:
        draws = {}
        pcm = steps.draw_pcm(g, cfg.batch_size, cfg.num_points, 1.0)
        draws["mixed"], draws["mixed_y"] = steps.pcm_mix_segmentation(
            sx, src_y[b], pcm)
        draws["dx_via"], draws["dmask_via"] = steps.deform_dispatch(
            tx, steps.draw_deform_dispatch(g, tx, cfg), cfg)
        total = seg_steps.pointsegda_losses(
            model, cfg, {"src_x": sx, "src_y": src_y[b], "trgt_x": tx},
            draws, g)[0]
    else:
        draws = steps.draw_step(g, sx, src_y[b], tx, cfg)
        total = steps.pointda_losses(
            model, cfg, {"src_x": sx, "src_y": src_y[b], "trgt_x": tx},
            draws, g)[0]
    g2 = torch.Generator().manual_seed(5)
    W = copy.deepcopy(w0)
    ref = cell.ref.train_loss(W, src_x[b], src_y[b], trgt_x[b], g2,
                              cell.ref_cfg)
    assert torch.equal(g.get_state(), g2.get_state())
    assert abs(float(total.detach()) - float(ref.detach())) <= tol * abs(float(ref))


def test_reference_steps_follow_the_trainer():
    """Three seg steps through the port's trainer functions on the CPU,
    two an epoch, so that step 3 opens epoch 1 (its batches, its draws'
    seed, its LR), against the reference's three: the first loss and
    gradient agree to rounding, and the change over the three steps
    within the cell's committed limit."""
    cell = small_cell("pointsegda_dgcnnseg.train_mlsp_pcm", n=64, b=4)
    cell.config["hyper"]["scan_steps"] = 4
    committed = cell.limits
    cell.limits = {}
    notes = []
    _, _, got = core.execute(cell, 11, 0.0, False, CPU, 0.0,
                             note=notes.append)
    assert any("(2 steps an epoch)" in n for n in notes), notes
    assert got["loss1_gap"] < 1e-5 and got["grad_gap"] < 1e-4, got
    assert got["median_change_gap"] <= committed["median_change_gap"], got


def test_weights_fill_every_state_entry():
    for name in ("pointda_dgcnn.train_paper",
                 "pointsegda_dgcnnseg.eval_split"):
        cell = small_cell(name)
        cfg, model, w0, *_ = setup(cell)
        assert set(w0) == set(model.state_dict())
        assert all(w0[k].shape == v.shape
                   for k, v in model.state_dict().items())


def test_data_are_seeded_surfaces():
    x1, y1 = data.classification(7, 20, 256, 0.0, 10, CPU)
    x2, y2 = data.classification(7, 20, 256, 0.0, 10, CPU)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    r = x1[y1 == 0].norm(dim=-1)  # spheres: a surface (a ball: ~0.2)
    assert (r.std(dim=1) < 0.1).all() and (r.amax(dim=1) == 1).all()
    s, lab = data.segmentation(2**31 + 5, 3, 512, 8, CPU)
    assert lab.min() == 0 and lab.max() == 7 and s.shape == (3, 512, 3)
