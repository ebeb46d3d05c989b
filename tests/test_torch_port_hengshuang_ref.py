"""The Hengshuang Point Transformer of the port against the benchmark's plain
reference (`benchmark/reference/pointda_hengshuang.py`) on the CPU, on the
reference's seeded weights (`benchmark.harness.weights.make` over its
`spec`): the eval forward (classifier and DefRec head), one step of PCM on
the source and DefRec on the deformed target (its loss and every
gradient), its vector attentions against the reference's list (the
edges `va_ns_per_edge.train` divides by), its spans, and the width
that `transformer_dim` gives the model through `models.model_kwargs`.

Small: B 2, N 256, 2 levels (256, 64, 16 points), k 8, d_model 32. N is
256, not less, so that DefRec's voxel deformation can find a voxel of 40
points to collapse (at N 64 none can: its mask is empty and the decoder's
gradients are all zero); the seed's target clouds give it one, which the
step's test asserts.
"""

import copy
import statistics
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import data, weights  # noqa: E402
from benchmark.reference import pointda_hengshuang as R  # noqa: E402
from mlsp_tpu_torch.models import (  # noqa: E402
    _MODELS,
    make_model,
    model_kwargs,
)
from mlsp_tpu_torch.train import evaluation, steps  # noqa: E402
from mlsp_tpu_torch.utils import checkpoint, config, profiling  # noqa: E402
from mlsp_tpu_torch.utils.logging import IOStream  # noqa: E402

B, N, K, D, NBLOCKS = 2, 256, 8, 32, 2
CPU = torch.device("cpu")
REF = {"num_class": 10, "num_points": N, "batch_size": B, "k": K,
       "nblocks": NBLOCKS, "d_model": D, "base_dim": 32, "dropout": 0.5,
       "DefRec_weight": 0.5}
HENGSHUANG = ("hengshuang", "hengshuang_seg")
# The port computes the reference's float32 operations in the reference's
# order; only the self-kNN's distances take another form (the K1 kernel's
# chain on the reference's side, the matmul form on the port's CPU
# route), which leaves these clouds' neighbour sets equal. What is left
# is a library reordering a reduction between the two calls: 1e-6 of the
# loss, 1e-5 of a gradient leaf's norm (or the median leaf's).
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=3):
    w0 = weights.make(R.spec(REF), seed, CPU, 2.0)
    model = make_model("hengshuang", 10, device="cpu", nblocks=NBLOCKS,
                       nneighbor=K, d_model=D)
    model.load_state_dict(copy.deepcopy(w0), strict=True)
    x, y = data.classification(seed + 1, 2 * B, N, 0.02, 10, CPU)
    return w0, model, x[:B], y[:B], x[B:]


def _port_cfg():
    return config.PointDAConfig(model="hengshuang", num_points=N,
                                batch_size=B, transformer_dim=D,
                                DefRec_on_trgt=True).resolved()


def _port_step(model, sx, sy, tx, g):
    """The port's step from the trainer's functions, its update left out:
    (total, the deformed target's mask, {name: gradient})."""
    cfg = _port_cfg()
    src = steps.augment_batch(sx, *steps.draw_augment(g, sx))
    trgt = steps.augment_batch(tx, *steps.draw_augment(g, tx))
    draws = steps.draw_step(g, src, sy, trgt, cfg)
    total, _ = steps.pointda_losses(
        model, cfg, {"src_x": src, "src_y": sy, "trgt_x": trgt}, draws, g)
    total.backward()
    return total, draws["trgt_dmask"], {
        n: p.grad for n, p in model.named_parameters()}


def test_weights_fill_every_state_entry():
    w0, model, *_ = _setup()
    assert set(w0) == set(model.state_dict())
    assert model.k == K and model.config["d_model"] == D


@pytest.mark.parametrize("heads", [(), ("defrec",)])
def test_eval_forward_matches_the_reference(heads):
    w0, model, x, _, _ = _setup()
    model.eval()
    with torch.no_grad():
        got = model(x, heads)
    want = R.forward(w0, x, heads, None, False, REF)
    assert set(want) == set(heads) | {"cls"}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_step_loss_and_every_gradient_match_the_reference():
    w0, model, sx, sy, tx = _setup()
    g = torch.Generator().manual_seed(5)
    total, mask, got = _port_step(model, sx, sy, tx, g)
    assert mask.sum() > 0  # a voxel collapsed: DefRec's loss is live
    W = copy.deepcopy(w0)
    names = weights.trainable(R.spec(REF))
    for n in names:
        W[n].requires_grad_(True)
    g2 = torch.Generator().manual_seed(5)
    loss = R.train_loss(W, sx, sy, tx, g2, REF)
    want = dict(zip(names, torch.autograd.grad(loss, [W[n] for n in names],
                                               allow_unused=True)))
    assert torch.equal(g.get_state(), g2.get_state())  # the same draws
    total, loss = float(total.detach()), float(loss.detach())
    assert abs(total - loss) <= LOSS_TOL * abs(loss)
    assert set(got) == set(want)
    med = statistics.median(float(v.norm()) for v in want.values())
    assert med > 0
    for n in names:
        assert got[n] is not None and want[n] is not None, n
        gap = float((got[n] - want[n]).norm()) / max(float(want[n].norm()),
                                                     med)
        assert gap <= GRAD_TOL, (n, gap)


def test_vector_attentions_are_the_reference_list():
    """The (B, N, k, C, d_model) of each vector attention the port's step
    runs, in its order, are the reference's `train_vector_attentions`."""
    from mlsp_tpu_torch.models.hengshuang import VectorAttention

    _, model, sx, sy, tx = _setup()
    ran = []

    def note(mod, args):
        xyz, feats = args
        b, n, c = feats.shape
        ran.append((b, n, min(mod.k, n), c, mod.fc1.out_features))

    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, VectorAttention)]
    try:
        _port_step(model, sx, sy, tx, torch.Generator().manual_seed(5))
    finally:
        for h in hooks:
            h.remove()
    assert ran == R.train_vector_attentions(REF)
    assert len(ran) == 9


def test_outputs_are_bit_equal_with_the_spans_on_and_off():
    def run():
        _, model, sx, sy, tx = _setup()
        total, _, grads = _port_step(model, sx, sy, tx,
                                     torch.Generator().manual_seed(5))
        return total, grads

    profiling.clear_spans()
    off = run()
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    names = [r[0] for r in profiling.spans()]
    profiling.clear_spans()
    # the source's backbone, then the target's backbone and decoder
    assert names.count("vector_attention") == 9
    assert names.count("transition_down") == 2 * NBLOCKS
    assert names.count("transition_up") == NBLOCKS
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(off[1][n], on[1][n]) for n in off[1])


@pytest.mark.parametrize("cls", [config.PointDAConfig, config.EvalConfig,
                                 config.PointSegDAConfig, config.SPSTConfig])
def test_model_kwargs_give_the_width_to_the_hengshuang_models_only(cls):
    has = any(f.name == "transformer_dim"
              for f in config.dataclasses.fields(cls))
    assert has == (cls in (config.PointDAConfig, config.EvalConfig))
    cfg = cls(transformer_dim=48) if has else cls()
    for name in _MODELS:
        kw = model_kwargs(cfg, name)
        assert ("d_model" in kw) == (has and name in HENGSHUANG), name
        if "d_model" in kw:
            assert kw["d_model"] == 48
            assert make_model(name, 10, device="cpu", **kw).config[
                "d_model"] == 48


def test_eval_builds_a_checkpoint_at_its_width(tmp_path):
    """A checkpoint of a hengshuang at transformer_dim 48 loads through
    eval's `_load_model` at that width; at the default width it is
    refused."""
    cfg = config.PointDAConfig(model="hengshuang", transformer_dim=48)
    model = make_model("hengshuang", 10, device="cpu", **model_kwargs(cfg))
    path = str(tmp_path / "model.ckpt")
    checkpoint.save_train_state(path, model)
    ev = config.EvalConfig(model="hengshuang", transformer_dim=48,
                           model_file=path, device="cpu", out_path=str(
                               tmp_path), exp_name="e")
    io = IOStream(ev.out_path, ev.exp_name)
    got = evaluation._load_model(ev, io)
    assert got.config["d_model"] == 48
    assert all(torch.equal(a, b) for a, b in zip(
        got.state_dict().values(), model.state_dict().values()))
    with pytest.raises(ValueError, match="does not match"):
        evaluation._load_model(config.dataclasses.replace(
            ev, transformer_dim=128), io)


@pytest.mark.parametrize("k1_a_step", [15, 14])
def test_edge_metric_reads_the_listed_edges_where_k1_agrees(k1_a_step):
    """`va_ns_per_edge.train` divides the device time outside K1-K4 by the
    edges of the configuration's vector attentions times the steps, and
    reads nothing where the window's K1 launches are not one a listed
    attention."""
    from benchmark.harness import core
    from benchmark.harness.trace import Reading

    cell = core.load_cell("pointda_hengshuang.train_defrec_pcm")
    reader = core.reader("va_ns_per_edge.train")
    listed = cell.ref.train_vector_attentions(cell.ref_cfg)
    assert len(listed) == 15
    edges = sum(b * n * k for b, n, k, _, _ in listed)
    assert edges == 2_090_496
    knn = ("(anonymous namespace)::knn_kernel(float)", 0, 100_000)
    reading = Reading(ops=[("sm80_xmma_gemm_f32f32", 0, 3_000_000),
                           ("elementwise_kernel", 0, 1_000_000)]
                      + [knn] * (2 * k1_a_step))
    ctx = core.Context(cell=cell, reading=reading, counts={"steps": 2})
    got = reader.read(ctx)
    if k1_a_step == len(listed):
        assert got == pytest.approx(4e6 / (2 * edges))
    else:
        assert got is None
