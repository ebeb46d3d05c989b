"""The idle split of `harness/spans.py` and the readers built on it, on
synthetic windows: each idle interval between the first and the last
device operation goes to the innermost program span open at each
instant, the rest to "outside", and the parts add up; a reader divides
its spans' part by the window's steps, requests or calls; every reader
reads nothing where the program records no spans."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, spans  # noqa: E402
from benchmark.harness.trace import Reading  # noqa: E402
from mlsp_tpu_torch.utils import profiling  # noqa: E402

MS = 1_000_000  # ns
NEW = ["trainer_idle_ms.train", "step_idle_ms.train", "graph_captures.train",
       "forward_idle_ms.serve", "copy_idle_ms.serve",
       "forward_idle_ms.eval", "metrics_idle_ms.eval"]

# device operations (name, start, duration): idle [10, 30), [50, 100),
# [110, 200), [210, 220) ms between the first start and the last end
OPS = [("a", 0, 10), ("b", 30, 10), ("c", 35, 15), ("d", 100, 10),
       ("e", 200, 10), ("f", 220, 10)]
# (name, start, end, parent): nested spans, one gap across two
# spans, parts of gaps and a whole gap under none
TRAIN = [("train_epoch", 5, 150, None), ("gather", 12, 20, 0),
         ("run_chunk", 25, 90, 0), ("replay", 60, 80, 2),
         ("fetch_metrics", 160, 180, None)]


def _ms(ops, records):
    return ([(n, s * MS, d * MS) for n, s, d in ops],
            [(n, s * MS, e and e * MS, p) for n, s, e, p in records])


def _ctx(ops, counts):
    return core.Context(cell=None, reading=Reading(ops=ops), counts=counts)


def test_idle_goes_to_the_innermost_span_and_adds_up():
    ops, records = _ms(OPS, TRAIN)
    assert spans.idle_intervals(ops) == [
        (10 * MS, 30 * MS), (50 * MS, 100 * MS), (110 * MS, 200 * MS),
        (210 * MS, 220 * MS)]
    by, outside, total = spans.split(ops, records)
    assert spans.by_name(records, by, outside) == {
        "train_epoch": 57 * MS, "gather": 8 * MS, "run_chunk": 25 * MS,
        "replay": 20 * MS, "fetch_metrics": 20 * MS, "outside": 40 * MS}
    assert total == 170 * MS == sum(by.values()) + outside


def test_a_child_opened_with_its_parent_is_innermost():
    ops, records = _ms([("a", 0, 1), ("b", 10, 1)],
                       [("run_chunk", 1, 10, None),
                        ("copy_in", 1, 4, 0), ("replay", 4, 4, 0),
                        ("open", 2, None, 0)])
    by, outside, total = spans.split(ops, records)
    assert spans.by_name(records, by, outside) == {
        "copy_in": 3 * MS, "run_chunk": 6 * MS, "outside": 0}
    assert total == 9 * MS


def test_train_readers(monkeypatch):
    ops, records = _ms(OPS, TRAIN + [("capture", 2, 3, None)])
    monkeypatch.setattr(profiling, "spans", lambda: records)
    ctx = _ctx(ops, {"steps": 4})
    assert core.reader("trainer_idle_ms.train").read(ctx) == 85 / 4
    assert core.reader("step_idle_ms.train").read(ctx) == 45 / 4
    assert core.reader("graph_captures.train").read(ctx) == 1.0


def test_serve_readers(monkeypatch):
    ops, records = _ms(
        [("a", 0, 1), ("b", 4, 1), ("c", 10, 1)],
        [("request", 0, 12, None),
         ("request_copy_in", 0, 2, 0),
         ("request_forward", 2, 8, 0),
         ("request_copy_out", 8, 11, 0)])
    monkeypatch.setattr(profiling, "spans", lambda: records)
    ctx = _ctx(ops, {"requests": 2})
    # idle [1, 4), [5, 10): copy-in 1, forward 2 + 3, copy-out 2
    assert core.reader("forward_idle_ms.serve").read(ctx) == 5 / 2
    assert core.reader("copy_idle_ms.serve").read(ctx) == 3 / 2


def test_eval_readers(monkeypatch):
    ops, records = _ms(
        [("a", 0, 1), ("b", 6, 1), ("c", 20, 1)],
        [("eval_logits", 0, 8, None), ("eval_index", 1, 2, 0),
         ("eval_scan", 2, 7, 0), ("replay", 3, 5, 2),
         ("eval_metrics", 9, 19, None)])
    monkeypatch.setattr(profiling, "spans", lambda: records)
    ctx = _ctx(ops, {"calls": 5})
    # idle [1, 6): index 1, scan 1 + 1, replay 2; [7, 20): logits 1,
    # outside 1 + 1, metrics 10
    assert core.reader("forward_idle_ms.eval").read(ctx) == 6 / 5
    assert core.reader("metrics_idle_ms.eval").read(ctx) == 10 / 5


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("program", ["no spans", "empty record"])
def test_readers_read_nothing_without_spans(monkeypatch, name, program):
    if program == "no spans":  # a port without the recorder
        monkeypatch.delattr(profiling, "spans")
    else:
        monkeypatch.setattr(profiling, "spans", lambda: [])
    ops, _ = _ms(OPS, [])
    ctx = _ctx(ops, {"steps": 4, "requests": 4, "calls": 4})
    assert core.reader(name).read(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_units(monkeypatch, name):
    ops, records = _ms(OPS, TRAIN)
    monkeypatch.setattr(profiling, "spans", lambda: records)
    got = core.reader(name).read(_ctx(ops, {}))
    assert got is None or name == "graph_captures.train"
