"""The precision and EdgeConv-route knobs of the port's DGCNN and DGCNNSeg
(`compute_dtype`, `gather_dtype`, `edge_impl`) held against the JAX
package on the CPU.

Weights go across with `jax_weights`, the inputs come from numpy seeds,
and JAX runs on the port's kNN graphs (`testing.Tape`): bf16 features
tie and near-tie often, and the two packages' distances round apart, so
only rounding may separate the outputs. Dropout is 0 on both sides.

Bounds: at float32, 1e-4 (train-mode BN: plus 3 times JAX's own change
under a 1e-6 input shift); at bf16, max |port - JAX| <= 2^-6 max |JAX| per
output, losses within 1e-2 relative and gradients with a cosine of at
least 0.999 per tensor; and the port's bf16 output lies at least twice as
near JAX's bf16 output as JAX's float32 one (the rounding is taken).
"""

import contextlib
import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.models import DGCNN as JaxDGCNN
from mlsp_tpu.models import DGCNNSeg as JaxDGCNNSeg
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.models import model_kwargs
from mlsp_tpu_torch.testing import Tape
from mlsp_tpu_torch.train import pointda_losses
from mlsp_tpu_torch.utils import chipcal
from mlsp_tpu_torch.utils.config import (
    EvalConfig,
    PointDAConfig,
    PointSegDAConfig,
)
from mlsp_tpu_torch.utils.jax_weights import (
    dgcnn_grads_from_jax,
    dgcnn_seg_state_dict_from_jax,
    dgcnn_state_dict_from_jax,
)

B, N = 4, 128
HEADS = ("defrec", "normal", "scan", "density")
SEG_HEADS = ("seg", "defrec", "normal", "density")
BF16_SCALE = 2.0 ** -6
BF16 = jnp.bfloat16
_jdgcnn = importlib.import_module("mlsp_tpu.models.dgcnn")
_jdseg = importlib.import_module("mlsp_tpu.models.dgcnn_seg")
_jnormals = importlib.import_module("mlsp_tpu.ops.normals")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small CPU forwards here run several times
    faster than with a thread per core beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_on_graphs(graphs):
    """JAX's kNN graphs (both models', the normals') replaced in call order
    by `graphs`, the port's, while the block traces."""
    it = iter(graphs)

    def knn(x, k, *args, **kwargs):
        g = next(it)
        assert tuple(g.shape) == (*x.shape[:2], k)
        return jnp.asarray(g.numpy().astype(np.int32))

    with mock.patch.object(_jdgcnn, "knn_indices", knn), \
            mock.patch.object(_jdseg, "knn_indices", knn), \
            mock.patch.object(_jnormals, "knn_indices", knn):
        yield
    assert next(it, None) is None


def _randomised(v, seed):
    """`v` with randomised BatchNorm (gamma of both signs: a negative gamma
    turns the moments form's max into a min), biases and running
    statistics."""
    rng = np.random.default_rng(seed)

    def param(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "scale":
            sign = rng.choice([-1.0, 1.0], a.shape)
            return (sign * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v["batch_stats"])}


@pytest.fixture(scope="module")
def dgcnn_variables():
    """Randomised variables of both JAX EdgeConv layouts ("moments": the
    EdgeConvM blocks, "direct": the EdgeConv ones), float32 parameters at
    any compute dtype."""
    out = {}
    for form in ("moments", "direct"):
        jm = JaxDGCNN(num_classes=10, k=20, edge_impl=form, knn_backend="xla")
        v = jax.jit(lambda r, x, jm=jm: jm.init({"params": r}, x, train=False,
                                                heads=HEADS))(
            jax.random.key(0), jnp.zeros((1, N, 3), jnp.float32))
        out[form] = _randomised(v, 1)
    return out


def _cloud(seed, shape=(B, N, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_dgcnn(v, **kw):
    model = make_model("dgcnn", 10, device="cpu", **{"k": 20, "dropout": 0.0,
                                                     **kw})
    model.load_state_dict(dgcnn_state_dict_from_jax(v), strict=True)
    return model


def _jax_apply(jm, v, x, train, heads, graphs):
    """JAX's outputs (and updated batch_stats in train mode) on the port's
    graphs."""
    with _jax_on_graphs(graphs):
        if train:
            out, mut = jm.apply(v, jnp.asarray(x), train=True, heads=heads,
                                mutable=["batch_stats"])
        else:
            out, mut = jm.apply(v, jnp.asarray(x), train=False,
                                heads=heads), None
    return {k: np.asarray(t, np.float32) for k, t in out.items()}, mut


def _assert_bf16_outputs(got, want, want_f32, shifted=()):
    """Each output within 2^-6 of its scale, plus 3 times JAX's own largest
    change over the `shifted` runs (train-mode BN: see
    `TestDGCNNForward`); and nearer JAX's bf16 output than JAX's float32
    one, by at least 2x in mean |Δ| over all outputs."""
    for k, w in want.items():
        gap = np.abs(got[k] - w).max()
        floor = max((np.abs(s[k] - w).max() for s in shifted), default=0.0)
        assert gap <= BF16_SCALE * np.abs(w).max() + 3.0 * floor, (
            k, gap, np.abs(w).max(), floor)
    near = np.mean([np.abs(got[k] - w).mean() for k, w in want.items()])
    far = np.mean([np.abs(got[k] - want_f32[k]).mean() for k in want])
    assert 2.0 * near <= far, (near, far)


# (case, JAX DGCNN keywords, port keywords)
DGCNN_CASES = [
    ("bf16", dict(dtype=BF16, edge_impl="moments"),
     dict(compute_dtype="bf16", edge_impl="moments")),
    ("gather_bf16", dict(gather_dtype=BF16, edge_impl="moments"),
     dict(gather_dtype="bf16", edge_impl="moments")),
    ("moments", dict(edge_impl="moments"), dict(edge_impl="moments")),
    ("direct", dict(edge_impl="direct"), dict(edge_impl="direct")),
]


class TestDGCNNForward:
    @pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
    @pytest.mark.parametrize("case,jkw,pkw", DGCNN_CASES,
                             ids=[c[0] for c in DGCNN_CASES])
    def test_matches_jax(self, dgcnn_variables, case, jkw, pkw, train):
        """The forward at each knob against the JAX DGCNN with the same
        settings on the port's graphs: outputs, and in train mode the
        running statistics (float32 cases). Train-mode BN over B=4 is
        chaotic: JAX's own bf16 outputs move by 3-13% of their scale when
        its input moves by 1e-6 (a rounding flip before a BN over a few
        rows reaches every point), so there, as at float32, each output
        may also differ by 3 times JAX's own largest change under a shift
        of +-1e-6; the control against float32 still holds."""
        form = "direct" if jkw["edge_impl"] == "direct" else "moments"
        v = dgcnn_variables[form]
        x = _cloud(2)
        model = _port_dgcnn(v, **pkw).train(train)
        assert model.edge_routes(N, "cpu") == (pkw["edge_impl"],) * 4
        tape = Tape()
        with tape.record(), torch.no_grad():
            out = model(torch.from_numpy(x), heads=HEADS)
        got = {k: t.numpy() for k, t in out.items()}
        assert all(t.dtype == np.float32 for t in got.values())
        jm = JaxDGCNN(num_classes=10, k=20, dropout=0.0, knn_backend="xla",
                      **jkw)
        want, mut = _jax_apply(jm, v, x, train, HEADS, tape.graphs)
        shifted = [_jax_apply(jm, v, x + d, train, HEADS, tape.graphs)[0]
                   for d in ((1e-6, -1e-6) if train else ())]
        if case in ("bf16", "gather_bf16"):
            f32 = JaxDGCNN(num_classes=10, k=20, dropout=0.0,
                           knn_backend="xla", edge_impl="moments")
            want_f32, _ = _jax_apply(f32, v, x, train, HEADS, tape.graphs)
            _assert_bf16_outputs(got, want, want_f32, shifted)
            return
        for k, w in want.items():
            floor = max((np.abs(s[k] - w).max() for s in shifted),
                        default=0.0)
            np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                       atol=1e-4 + 3.0 * floor, err_msg=k)
        if train:
            sd = dgcnn_state_dict_from_jax({"params": v["params"],
                                            "batch_stats": mut["batch_stats"]})
            state = model.state_dict()
            for k, w in sd.items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(state[k].numpy(), w.numpy(),
                                               rtol=1e-4, atol=1e-5,
                                               err_msg=k)


class TestSegForward:
    @pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
    def test_bf16_matches_jax(self, train):
        """DGCNNSeg at `compute_dtype` bf16 (the seg trainer's `dtype`)
        against the JAX model with `dtype=bf16` on the port's graphs."""
        jm = JaxDGCNNSeg(num_classes=8, dropout=0.0, knn_backend="xla",
                         dtype=BF16)
        v = _randomised(jax.jit(lambda r, x: jm.init(
            {"params": r}, x, train=False, heads=SEG_HEADS))(
                jax.random.key(0), jnp.zeros((1, N, 3), jnp.float32)), 2)
        x = _cloud(3)
        model = make_model("dgcnn_seg", 8, device="cpu", dropout=0.0,
                           compute_dtype="bf16").train(train)
        model.load_state_dict(dgcnn_seg_state_dict_from_jax(v), strict=True)
        tape = Tape()
        with tape.record(), torch.no_grad():
            got = {k: t.numpy() for k, t in model(
                torch.from_numpy(x), heads=SEG_HEADS).items()}
        want, _ = _jax_apply(jm, v, x, train, SEG_HEADS, tape.graphs)
        f32 = JaxDGCNNSeg(num_classes=8, dropout=0.0, knn_backend="xla")
        want_f32, _ = _jax_apply(f32, v, x, train, SEG_HEADS, tape.graphs)
        _assert_bf16_outputs(got, want, want_f32)


def _cosines(model, jax_grads) -> dict:
    """Per trainable tensor, the cosine between the port's gradient and
    JAX's. Tensors whose JAX gradient is under 1e-3 of the largest norm
    (biases ahead of a train-mode BatchNorm: 0 in exact arithmetic, the
    rest rounding) must be as small on the port's side, and get no
    cosine."""
    want = dgcnn_grads_from_jax(jax_grads)
    named = dict(model.named_parameters())
    top = max(float(w.norm()) for w in want.values())
    out = {}
    for name, w in want.items():
        g = named[name].grad
        if g is None:
            np.testing.assert_array_equal(w.numpy(), 0.0, err_msg=name)
            continue
        g = g.double()
        w = w.double()
        if float(w.norm()) < 1e-3 * top:
            assert float(g.norm()) < 2e-3 * top, name
            continue
        out[name] = float((g * w).sum() / (g.norm() * w.norm()))
    return out


class TestBf16Step:
    N = 128

    def test_losses_and_grads_match_jax(self, dgcnn_variables):
        """One paper-recipe iteration at `compute_dtype` bf16 (B=4, N=128,
        k=20, heads bf16 as JAX's fall back to `dtype`), fed the JAX
        step's own draws (`debug_aux`), JAX then traced again on the
        port's kNN graphs, once at bf16 and once at float32: each loss
        term within 1e-2 relative of JAX's bf16 one, and each gradient
        with 1 - cosine <= 1e-3 plus 3 times JAX's own bf16 rounding in
        that tensor (1 - cosine between its bf16 and float32 gradients;
        1-2% in the first layers, where the port's bf16 gradients lie
        nearer the float32 ones than JAX's do, so a cosine of 0.999
        against JAX's bf16 gradients would hold the port to JAX's rounding
        noise). Eval-mode BN (`debug_bn_eval`): with train-mode BN over
        B=4 at bf16, JAX's own loss terms move by several percent under a
        1e-6 input shift; the train-mode forwards are held above."""
        n = self.N
        cfg_j = dataclasses.replace(
            JaxConfig(batch_size=B, num_points=n, dropout=0.0,
                      knn_backend="xla", edge_impl="moments",
                      compute_dtype="bf16").paper_recipe,
            debug_aux=True, debug_bn_eval=True)
        cfg = dataclasses.replace(
            PointDAConfig(batch_size=B, num_points=n, dropout=0.0,
                          edge_impl="moments",
                          compute_dtype="bf16").paper_recipe,
            debug_bn_eval=True)
        v = dgcnn_variables["moments"]
        rng = np.random.default_rng(3)
        src, trgt = (_cloud(s, (B, n, 3)) for s in (4, 5))
        src /= np.abs(src).max()
        trgt /= np.abs(trgt).max()
        src_y = rng.integers(0, 10, B)

        def jax_step(dtype):
            jm = JaxDGCNN(num_classes=10, k=20, dropout=0.0,
                          knn_backend="xla", edge_impl="moments",
                          dtype=dtype, head_dtype=BF16)
            state = jstate.TrainState.create(
                apply_fn=jm.apply, params=v["params"],
                batch_stats=v["batch_stats"], tx=jstate.make_optimizer(
                    "ADAM", cfg.lr, cfg.wd, 0.9, cfg.epochs, 10,
                    decay_mask=jstate.untrained_decay_mask({"RecScan"})))
            return jsteps.pointda_train_step(
                state, jnp.asarray(src), jnp.asarray(src_y),
                jnp.asarray(trgt), jax.random.key(4), cfg_j)[1]

        m = jax_step(BF16)  # the draws, which no model graph moves
        aux = {k: torch.from_numpy(np.array(a)) for k, a in m.items()
               if k.startswith("aux_") and k != "aux_grads"}
        assert float(aux["aux_dmask"].sum(-1).min()) >= 40  # a region each
        model = _port_dgcnn(v, **model_kwargs(cfg))
        assert model.dtype == torch.bfloat16
        tape = Tape()
        with tape.record():
            total, got = pointda_losses(
                model, cfg,
                {"src_x": aux["aux_src"], "src_y": torch.from_numpy(src_y),
                 "trgt_x": aux["aux_trgt"]},
                {"mixed": aux["aux_mixed"], "ya": aux["aux_ya"].long(),
                 "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"],
                 "dx": aux["aux_dx"], "dmask": aux["aux_dmask"]}, None)
        total.backward()
        want = {}
        for dtype in (BF16, None):
            jax.clear_caches()  # trace the step again, on the port's graphs
            with _jax_on_graphs(tape.graphs):
                want[dtype] = jax_step(dtype)
        m = want[BF16]
        assert set(got) == {k for k in m if not k.startswith("aux_")}
        for name, t in got.items():
            w = float(m[name])
            assert abs(t.item() / w - 1.0) <= 1e-2, (name, t.item(), w)
        cos = _cosines(model, m["aux_grads"])
        bf16, f32 = (dgcnn_grads_from_jax(want[d]["aux_grads"])
                     for d in (BF16, None))
        assert len(cos) >= 40
        for name, c in cos.items():
            own = 1.0 - float((bf16[name].double() * f32[name].double()).sum()
                              / (bf16[name].double().norm()
                                 * f32[name].double().norm()))
            assert 1.0 - c <= 1e-3 + 3.0 * own, (name, c, own)


class TestResolution:
    def test_auto_is_moments_off_the_card(self):
        model = make_model("dgcnn", 10, device="cpu")
        assert model.edge_impl == "auto"
        assert model.edge_routes(1024, "cpu") == ("moments",) * 4
        assert chipcal.edge_impl(2048, 64, torch.device("cpu")) == "moments"

    def test_auto_takes_the_records_winner_per_layer_shape(self):
        """A synthetic record (nothing measured): each layer takes the
        winner of the measured shape nearest its (N, output width), in log
        space, ties to the larger width (the JAX rule)."""
        records = {"n1024_c64": {"moments_ms": 2.0, "fused_ms": 1.0,
                                 "winner": "fused"},
                   "n1024_c256": {"moments_ms": 1.0, "fused_ms": 2.0,
                                  "winner": "moments"},
                   "n2048_c64": {"moments_ms": 1.0, "fused_ms": 2.0,
                                 "winner": "moments"}}
        assert chipcal.nearest_shape_key(1024, 128) == "n1024_c256"
        assert chipcal.resolve_shape(records, 4096, 64) is records[
            "n2048_c64"]
        with mock.patch.object(torch.cuda, "get_device_name",
                               lambda *a: "synthetic card"), \
                mock.patch.dict(chipcal._RECORDS,
                                {"synthetic card": records}):
            model = make_model("dgcnn", 10, device="cpu")
            assert model.edge_routes(1024, "cuda") == (
                "fused", "fused", "moments", "moments")
            assert model.edge_routes(2048, "cuda") == ("moments",) * 4
            assert chipcal.edge_impl(1000, 70, "cuda") == "fused"
            pinned = make_model("dgcnn", 10, device="cpu", edge_impl="direct")
            assert pinned.edge_routes(1024, "cuda") == ("direct",) * 4

    @pytest.mark.parametrize("kw,match", [
        ({"edge_impl": "xla"}, "edge_impl"),
        ({"compute_dtype": "fp16"}, "compute_dtype"),
        ({"compute_dtype": ""}, "compute_dtype"),
        ({"gather_dtype": "bfloat16"}, "gather_dtype"),
        ({"head_dtype": "f16"}, "head_dtype")])
    def test_unknown_values_raise(self, kw, match):
        """JAX reads an unknown dtype as float32 and an unknown edge_impl as
        the direct form; the port refuses them."""
        with pytest.raises(ValueError, match=match):
            make_model("dgcnn", 10, device="cpu", **kw)

    def test_model_kwargs_follow_the_jax_builders(self):
        """DGCNN takes every knob the config has (JAX's
        `dgcnn_dtype_kwargs`); DGCNNSeg the seg trainer's compute_dtype
        but not eval's (JAX's eval passes the dtypes to dgcnn alone)."""
        kw = model_kwargs(PointDAConfig(compute_dtype="bf16",
                                        gather_dtype="bf16",
                                        edge_impl="direct"))
        assert {k: kw[k] for k in ("compute_dtype", "gather_dtype",
                                   "edge_impl", "head_dtype")} == {
            "compute_dtype": "bf16", "gather_dtype": "bf16",
            "edge_impl": "direct", "head_dtype": "bf16"}
        seg = PointSegDAConfig(compute_dtype="bf16")
        assert model_kwargs(seg)["compute_dtype"] == "bf16"
        ev = EvalConfig(task="pointsegda", compute_dtype="bf16").resolved()
        assert "compute_dtype" not in model_kwargs(ev)
        ev = EvalConfig(compute_dtype="bf16")
        assert make_model("dgcnn", 10, device="cpu",
                          **model_kwargs(ev)).dtype == torch.bfloat16
