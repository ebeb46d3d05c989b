"""The port's span recorder (`mlsp_tpu_torch.utils.profiling`) on the CPU.

Without a profiler `span` is one shared null context and the trainer's
chunks, `predict` and `evaluate_seg` record nothing; under
`torch.profiler.profile` they record their spans, nested as the module
docstrings say, on the profiler's clock; the outputs
are bit-equal either way; the record stays bounded. The card's side (a
capture, then copy-in, replays and outputs) is in
`test_torch_port_cuda.py`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mlsp_tpu_torch import ServingModel, make_model, save_serving_bundle
from mlsp_tpu_torch.data.synthetic import make_segmentation
from mlsp_tpu_torch.train.pointda_trainer import (
    epoch_pairs,
    fetch_metrics,
    seed_epoch,
    train_epoch,
)
from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
from mlsp_tpu_torch.train.state import make_optimizer
from mlsp_tpu_torch.train.steps import pointda_train_scan
from mlsp_tpu_torch.utils import config, profiling

N, B, S = 32, 4, 2


@pytest.fixture(autouse=True)
def fresh_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(threads)


class _Split:
    def __init__(self, m):
        self.m, self.train_ind = m, np.arange(m)

    def __len__(self):
        return self.m


def _clouds(seed, m):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (m, N, 3)).astype(np.float32))


def _train_epoch():
    """One epoch of three steps as the trainer takes it (a chunk of S = 2
    and a tail of 1, eager on the CPU), from fixed weights and seeds;
    returns (per-step losses, fetched losses, the parameters after)."""
    cfg = config.PointDAConfig(num_points=N, batch_size=B, epochs=2,
                               scan_steps=S).paper_recipe
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 3)
    src_x, trgt_x = _clouds(1, 3 * B), _clouds(2, 3 * B)
    src_y = torch.from_numpy(np.random.default_rng(3).integers(0, 10, 3 * B))
    gen = torch.Generator()

    def gather(s, t):
        return src_x[s], src_y[s], trgt_x[t]

    def scan(*chunk):
        return pointda_train_scan(model, opt, sched, *chunk, gen, cfg)

    pairs = epoch_pairs(_Split(3 * B), _Split(3 * B), B, 5, 0)
    seed_epoch(gen, 5, 0)
    steps = train_epoch(torch.from_numpy(np.asarray(pairs)), gather, scan, S)
    return (steps, fetch_metrics(steps),
            [p.detach().clone() for p in model.parameters()])


def _served(tmp_path):
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(7))
    save_serving_bundle(model, str(tmp_path / "b"), num_points=N)
    x = _clouds(8, 3).numpy()
    return ServingModel(str(tmp_path / "b"), device="cpu").predict(x)


def _evaluated():
    model = make_model("dgcnn_seg", 8, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    x, y = make_segmentation(5, N, 8, seed=5)
    return evaluate_seg(model, x, y, B)


def _traced(fn):
    """fn() under the profiler: (its output, the records, the profiler's
    "mlsp/..." events as (name, start_ns, end_ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name()[5:], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mlsp/")]
    return out, profiling.spans(), events


def _tree(records):
    """Each record as (name, its parent's name)."""
    return [(n, None if p is None else records[p][0])
            for n, _, _, p in records]


def test_span_is_one_null_context_without_a_profiler(tmp_path):
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("c"):
        pass
    _train_epoch()
    _served(tmp_path)
    _evaluated()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_train_epoch_records_its_spans():
    _, records, _ = _traced(_train_epoch)
    assert _tree(records) == [
        ("epoch_pairs", None),
        ("train_epoch", None),
        ("gather", "train_epoch"),
        ("run_chunk", "train_epoch"),
        ("eager_steps", "run_chunk"),
        ("gather", "train_epoch"),
        ("run_chunk", "train_epoch"),
        ("eager_steps", "run_chunk"),
        ("fetch_metrics", None),
    ]
    for _, s, e, p in records:
        assert s <= e
        if p is not None:
            assert records[p][1] <= s and e <= records[p][2]


def test_predict_records_a_request(tmp_path):
    _, records, _ = _traced(lambda: (_served(tmp_path), _served(tmp_path)))
    assert _tree(records) == [
        ("request", None),
        ("request_copy_in", "request"),
        ("request_forward", "request"),
        ("request_copy_out", "request"),
    ] * 2  # two servers, each one request


def test_evaluate_seg_records_its_spans():
    _, records, _ = _traced(_evaluated)
    assert _tree(records) == [
        ("eval_logits", None),
        ("eval_index", "eval_logits"),
        ("eval_scan", "eval_logits"),
        ("fetch_logits", "eval_logits"),
        ("eval_metrics", None),
        ("fetch_stats", "eval_metrics"),
    ]


@pytest.mark.parametrize("what", ["train", "evaluate_seg", "predict"])
def test_spans_share_the_profilers_clock(tmp_path, what):
    fn = {"train": _train_epoch, "evaluate_seg": _evaluated,
          "predict": lambda: _served(tmp_path)}[what]
    _, records, events = _traced(fn)
    assert len(events) == len(records)
    for name in {r[0] for r in records}:
        mine = [r for r in records if r[0] == name]
        theirs = sorted(e for e in events if e[0] == name)
        assert len(mine) == len(theirs), name
        for (_, s, e, _), (_, ps, pe) in zip(mine, theirs):
            assert abs(s - ps) < 1_000_000 and abs(e - pe) < 1_000_000, (
                name, s - ps, e - pe)


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(tmp_path):
    off = _train_epoch(), _evaluated(), _served(tmp_path)
    on = _traced(_train_epoch)[0], _traced(_evaluated)[0], _traced(
        lambda: _served(tmp_path))[0]
    (steps_off, losses_off, params_off), seg_off, y_off = off
    (steps_on, losses_on, params_on), seg_on, y_on = on
    for a, b in zip(steps_off, steps_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert [list(m.values()) for m in losses_off] == [
        list(m.values()) for m in losses_on]
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
    assert seg_off == seg_on
    assert np.array_equal(y_off, y_on) and y_off.dtype == y_on.dtype


def test_the_record_stays_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                with profiling.span("d"):  # beyond the bound
                    with profiling.span("e"):
                        pass
        for _ in range(5):
            with profiling.span("f"):
                pass
    assert _tree(profiling.spans()) == [("a", None), ("b", "a"), ("c", "a")]
    assert profiling.dropped() == 7
    assert all(r[2] is not None for r in profiling.spans())
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped() == 0
