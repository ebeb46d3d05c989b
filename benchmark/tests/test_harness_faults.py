"""A run with the timed path broken underneath comes out not correct.

Each cell is driven on the CPU at a small size, past the harness's look
for a card, through its driver, the port's own entry points and the
comparison, with the committed limits: once sound (correct), then once
for each fault the cell can have (`harness/faults.py`): a train step
that leaves the state unchanged, half of the batch left out with the
mean taken over the rest, an answer altered where it is produced, and
in serving, answers altered at a minority of the batch sizes. One
card holds these cells, so none can lose an exchange between chips.
The control, the reference in TF32 in the program's place, needs the
card (`test_control_comes_out_not_correct`); on the CPU, which has no
TF32, the reference in the program's place has to come out correct."""

import contextlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, faults  # noqa: E402

CPU = torch.device("cpu")
CELLS = {
    # epochs of 4 steps, and of 1 as adobe's 29 clouds give at batch 16
    "pointda_dgcnn.train_paper": dict(n=256, b=8, steps=4, src=4),
    "pointsegda_dgcnnseg.train_mlsp_pcm": dict(n=256, b=4, steps=4, src=1),
    "pointda_dgcnn.serve_mix": dict(n=256, b=8),
    "pointsegda_dgcnnseg.eval_split": dict(n=256, b=4),
}
FAULTS = {"train": ("unchanged", "half", "altered"),
          "serve": ("half", "altered", "some_sizes"),
          "eval_split": ("half", "altered")}
CASES = [(c, f) for c in CELLS
         for f in (None, *FAULTS[core.load_cell(c).traffic["kind"]])]


def small(name):
    cell = core.load_cell(name)
    p, h = CELLS[name], cell.config["hyper"]
    h.update(num_points=p["n"], batch_size=p["b"], test_batch_size=p["b"])
    if "steps" in p:
        h["scan_steps"] = p["steps"]
        cell.config["data"].update(source_train=p["src"] * p["b"] + 1,
                                   target_train=4 * p["b"])
    t = cell.traffic
    if t["kind"] == "serve":
        t.update(pool=2 * p["b"], batch_max=p["b"])
    if t["kind"] == "eval_split":
        t["clouds"] = 3 * p["b"] - 1
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """The CPU has none of the card's kernels: their plain versions stand in
    with the arithmetic the kernels document and the reference follows on
    the card: K1's distances (`plain.knn`), K2-fwd's and K3's sums in
    neighbour order (`plain.neighbour_sums`, `plain.knn_moments`), and
    each EdgeConv layer on the kernels' route ("fused")."""
    from mlsp_tpu_torch.ops import edge, knn, normals
    from mlsp_tpu_torch.utils import chipcal

    from benchmark.reference import plain

    def knn_like(x, k, rows=None):
        assert rows is None
        return plain.knn(x, k)

    def k2_like(u, idx, want_moments):
        g = knn.knn_gather(u.float(), idx)
        outs = (g.amax(-2), g.amin(-2))
        return outs + plain.neighbour_sums(g) if want_moments else outs

    def k3_like(x, k):
        s1, s2 = plain.knn_moments(x, k)
        return s1, s2.reshape(*s2.shape[:-2], 9)

    monkeypatch.setattr(knn, "knn_indices_torch", knn_like)
    monkeypatch.setattr(edge, "edge_moments_torch", k2_like)
    monkeypatch.setattr(chipcal, "edge_impl", lambda n, c, device: "fused")
    monkeypatch.setattr(normals, "use_kernel", lambda t, backend: True)
    monkeypatch.setattr(normals, "knn_moments_cuda", k3_like)


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_comes_out_not_correct(name, fault, kernels_on_cpu):
    cell = small(name)
    # serve: a window long enough for a whole block of sizes 1..8
    seconds = {"train": 0.0, "serve": 3.0}.get(cell.traffic["kind"], 0.5)
    plant = (faults.plant(cell.traffic["kind"], fault) if fault
             else contextlib.nullcontext())
    with plant:
        result, checks, _ = core.execute(cell, 2**31 + 77, seconds, False,
                                         CPU, 0.0, note=lambda s: None)
    assert result["correct"] is (fault is None), checks


@pytest.mark.parametrize("name", list(CELLS))
def test_reference_in_the_programs_place_comes_out_correct(name,
                                                           kernels_on_cpu):
    """The control's plumbing on the CPU: the reference put in the
    program's place, at full precision (the CPU has no TF32), reads as
    the program does."""
    import benchmark.control as control

    cell = small(name)
    seconds = 0.0 if cell.traffic["kind"] == "train" else 0.5
    result, readings = control.run_mode(cell, "control", 2**31 + 78,
                                        seconds, CPU, note=lambda s: None)
    assert result["correct"] is True, readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_control_comes_out_not_correct(name):
    """On the card at the cell's own size: the reference in TF32 in the
    program's place, through the cell's driver and comparison, comes out
    not correct at the committed limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import benchmark.control as control

    cell = core.load_cell(name)
    result, readings = control.run_mode(cell, "control", 2**31 + 79, 0.5,
                                        torch.device("cuda", 0),
                                        note=lambda s: None)
    assert result["correct"] is False, readings
