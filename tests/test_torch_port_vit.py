"""The port's Point-ViT (`mlsp_tpu_torch/models/vit.py`) against the JAX
package's `mlsp_tpu.models.vit.PointViT` on the CPU, with each of the four
group embedders, at small widths: trans_dim 64, encoder_dims 48, depth 4,
taps (1, 2, 3), 8 groups of 8 points (the "dgcnn" embedder 8 groups of 24,
so that its k = 20 neighbours are a true subset of a group), B = 4, N = 128.

Weights go across with `utils.jax_weights.vit_state_dict_from_jax`
(randomised BatchNorm, as in `test_torch_port_families.py`), every leaf
of the flax tree read; gradients come back with `vit_grads_from_jax`.
Dropout is 0 on both sides. Bounds, as for the other families: eval
outputs rtol 1e-4 / atol 1e-4, gradients 1e-4 relative L2
(`testing.grad_gaps`), the train forward and its BatchNorm statistics
(atol 1e-5) each plus 3 times JAX's own change under a 1e-6 input shift.
Each side builds its own kNN graphs and FPS orders on standard-normal
clouds, but for the "dgcnn" embedder's self-kNN graphs, which JAX takes
from the port's run (`_port_graphs`), as the DGCNN tests replay them.
The gradients are held with JAX on the port's ReLU signs where JAX applies
ReLU through `layers.act_fn` (`_jax_on_kinks`, as PointNet++'s tests do):
the DefRec head's ~1e5 ReLU inputs hold one within rounding of 0 (|z| ~
4e-8, "dgcnn" embedder, seed 1), which flips between the packages and
moves the head's gradients by ~2e-3 of their norm.

Then the vit-only behaviour: the `fetch_idx` and `encoder_type` errors,
one PointDA step under `configs/pointda_vit.yaml`'s recipe (PCM, DefRec on
the target) against the JAX step, `vit` refused as a segmenter, a serving
bundle, and the `trainer`, `eval`, `infer` and `spst` CLIs with `--model
vit` in a process that imports no JAX (a narrow `vit`: the CLI has no
width flags, as JAX's has none).
"""

import contextlib
import dataclasses
import functools
import importlib
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_port_families import randomised

from mlsp_tpu.models.vit import PointViT as JaxViT
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
from mlsp_tpu_torch import ServingModel, make_model, save_serving_bundle
from mlsp_tpu_torch.models.dgcnn import EdgeConv
from mlsp_tpu_torch.models.layers import DenseBN, FlaxDenseBN, PointMLPHead
from mlsp_tpu_torch.models.transformer import GroupEncoder
from mlsp_tpu_torch.testing import grad_gaps
from mlsp_tpu_torch.train import pointda_losses
from mlsp_tpu_torch.train.seg_steps import check_seg_recipe
from mlsp_tpu_torch.train.steps import check_recipe
from mlsp_tpu_torch.utils import jax_weights as jw
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    load_yaml_dict,
    model_heads,
)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
B, N = 4, 128
KW = dict(trans_dim=64, encoder_dims=48, depth=4, heads=2, num_group=8,
          group_size=8, fetch_idx=(1, 2, 3))
ENCODERS = {"relative": {}, "relative_absolute": {"use_absolute": True},
            "pointnet": {}, "dgcnn": {"group_size": 24},
            "pointnet_tnet": {}}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}
_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_jknn = importlib.import_module("mlsp_tpu.ops.knn")
_jlayers = importlib.import_module("mlsp_tpu.models.layers")
_jdgcnn = importlib.import_module("mlsp_tpu.models.dgcnn")
_jtransformer = importlib.import_module("mlsp_tpu.models.transformer")
_jvit = importlib.import_module("mlsp_tpu.models.vit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(enc: str) -> dict:
    extra = dict(ENCODERS[enc])
    return {**KW, "encoder_type": enc.removesuffix("_absolute"), **extra}


@functools.cache
def jax_model(enc: str):
    return JaxViT(num_classes=10, dropout=0.0, knn_backend="xla", **_kw(enc))


@functools.cache
def _jax_init(enc: str):
    return jax.jit(lambda r: jax_model(enc).init(
        {"params": r}, jnp.zeros((1, N, 3)), train=False, heads=("defrec",)))


def variables(enc: str, seed: int) -> dict:
    return randomised(_jax_init(enc)(jax.random.key(seed)), seed)


def port(enc: str, v: dict) -> torch.nn.Module:
    model = make_model("vit", 10, device="cpu", dropout=0.0, **_kw(enc))
    model.load_state_dict(jw.vit_state_dict_from_jax(v), strict=True)
    return model


def clouds(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, n, 3)).astype(np.float32)


@contextlib.contextmanager
def _port_graphs():
    """The port's self-kNN graphs, in call order."""
    graphs, plain = [], _knn.knn_indices_torch

    def knn(x, k):
        out = plain(x, k)
        graphs.append(out.numpy().astype(np.int32))
        return out

    with mock.patch.object(_knn, "knn_indices_torch", knn):
        yield graphs


@contextlib.contextmanager
def _jax_on_graphs(graphs):
    """JAX's self-kNN (the "dgcnn" embedder's; its grouping's cross-set
    kNN passes `y`) takes the port's graphs, in call order."""
    it, own = iter(graphs), _jknn.knn_indices

    def knn(x, k, y=None, **kw):
        return own(x, k, y=y, **kw) if y is not None else jnp.asarray(next(it))

    with mock.patch.object(_jknn, "knn_indices", knn):
        yield
    assert next(it, None) is None


@contextlib.contextmanager
def _port_kinks(model):
    """The port's kinks, in call order: the signs of its inputs to every
    ReLU and LeakyReLU that JAX applies through an `act_fn` (the outputs
    of the BatchNorms ahead of them: the DefRec head, the T-nets, the
    PointNet and DGCNN embedders' Denses and EdgeConvs), and for every max
    (`amax`) the mask of the elements that reach the maximum."""
    bns = []
    for m in model.modules():
        if isinstance(m, PointMLPHead):
            bns += [m.bn1, m.bn2, m.bn3]
        elif isinstance(m, GroupEncoder):
            bns.append(m.first_conv[1])
        elif isinstance(m, (FlaxDenseBN, EdgeConv)):
            bns.append(m.BatchNorm_0)
        elif isinstance(m, DenseBN):
            bns.append((m.conv if hasattr(m, "conv") else m.fc)[1])
    kinks = {"signs": [], "max": []}
    hooks = [bn.register_forward_hook(
        lambda m, i, out: kinks["signs"].append(out.detach().numpy() > 0))
        for bn in bns]
    amax = torch.Tensor.amax

    def recording_amax(t, dim, keepdim=False):
        out = amax(t, dim, keepdim)
        kinks["max"].append((t == amax(t, dim, True)).detach().numpy())
        return out

    try:
        with mock.patch.object(torch.Tensor, "amax", recording_amax):
            yield kinks
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _jax_on_kinks(kinks):
    """JAX's `act_fn`s (of `layers`, and of `dgcnn` for its `EdgeConv`)
    take the port's signs, and its maxima (`jnp.max` in the model modules)
    the port's maximal elements, shared evenly as both packages share a
    tie, in call order. An activation input or a runner-up within rounding
    of the maximum can otherwise flip between the two packages and move a
    layer's gradient by ~1e-3 of its norm."""
    signs, picks = iter(kinks["signs"]), iter(kinks["max"])

    def act_fn(name):
        slope = {"relu": 0.0, "leakyrelu": 0.2}[name]
        return lambda x: jnp.where(jnp.asarray(next(signs)).reshape(x.shape),
                                   x, slope * x)

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def max(g, axis, keepdims=False):
            w = jnp.asarray(next(picks), g.dtype).reshape(g.shape)
            return ((g * w).sum(axis, keepdims=keepdims)
                    / w.sum(axis, keepdims=keepdims))

    with contextlib.ExitStack() as stack:
        for mod in (_jlayers, _jdgcnn):
            stack.enter_context(mock.patch.object(mod, "act_fn", act_fn))
        for mod in (_jlayers, _jdgcnn, _jtransformer, _jvit):
            stack.enter_context(mock.patch.object(mod, "jnp", Jnp()))
        yield
    assert next(signs, None) is None and next(picks, None) is None


class _Tracked(dict):
    """A flax tree that records the path of every leaf read from it."""

    def __init__(self, tree, seen, path=()):
        super().__init__({k: _Tracked(v, seen, path + (k,))
                          if isinstance(v, dict) else v
                          for k, v in tree.items()})
        self.seen, self.path = seen, path

    def __getitem__(self, key):
        v = super().__getitem__(key)
        if not isinstance(v, dict):
            self.seen.add(self.path + (key,))
        return v


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,)


class TestWeights:
    @pytest.mark.parametrize("enc", list(ENCODERS))
    def test_every_flax_leaf_carries_over(self, enc):
        """The converter reads every leaf of the params and batch_stats
        trees and fills every tensor of the port's state_dict."""
        v = jax.tree_util.tree_map(np.asarray, variables(enc, 0))
        seen_p, seen_s = set(), set()
        sd = jw.vit_state_dict_from_jax(
            {"params": _Tracked(v["params"], seen_p),
             "batch_stats": _Tracked(v["batch_stats"], seen_s)})
        assert seen_p == set(_leaves(v["params"]))
        assert seen_s == set(_leaves(v["batch_stats"]))
        model = make_model("vit", 10, device="cpu", **_kw(enc))
        assert set(sd) == set(model.state_dict())
        grads = jw.vit_grads_from_jax(v["params"])
        assert set(grads) == {n for n, _ in model.named_parameters()}

    def test_shared_parts_keep_the_point_transformer_names(self):
        """The "pointnet" embedder, the tokens, the pos embed (flax Dense_1
        then Dense_0, by creation order), the blocks and the shared final
        LayerNorm carry PointTransformer's names."""
        v = variables("pointnet", 1)
        sd = jw.vit_state_dict_from_jax(v)
        p = v["params"]
        np.testing.assert_array_equal(sd["pos_embed.0.weight"].numpy(),
                                      np.asarray(p["Dense_1"]["kernel"]).T)
        np.testing.assert_array_equal(sd["pos_embed.2.weight"].numpy(),
                                      np.asarray(p["Dense_0"]["kernel"]).T)
        np.testing.assert_array_equal(sd["norm.weight"].numpy(),
                                      np.asarray(p["LayerNorm_0"]["scale"]))
        assert {"encoder.first_conv.0.weight", "cls_token", "cls_pos",
                "blocks.blocks.3.attn.qkv.bias", "head_fc1.weight",
                "head_fc2.bias", "DefRec.conv4.weight"} <= set(sd)

    def test_init_follows_flax(self):
        """cls_token zeros, cls_pos a standard normal."""
        m = make_model("vit", 10, device="cpu", **KW)
        assert not m.cls_token.any()
        assert 0.5 < float(m.cls_pos.detach().std()) < 1.5


def _jax_eval_grads(enc: str):
    def loss(params, bstats, x, w):
        o = jax_model(enc).apply({"params": params, "batch_stats": bstats},
                                 x, train=False, heads=("defrec",))
        return sum((w[n] * o[n]).sum() for n in w), o

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


class TestForward:
    @pytest.mark.parametrize("enc", list(ENCODERS))
    def test_eval_outputs_and_grads_match_jax(self, enc):
        """Eval-mode BN: cls, feat and defrec at rtol 1e-4 / atol 1e-4 and
        the gradient of every parameter of sum(w * outputs) within 1e-4
        relative L2. The gradient of the shared LayerNorm sums its two
        uses (the final tokens and the DefRec taps)."""
        v = variables(enc, 1)
        x = clouds(2)
        model = port(enc, v)
        with _port_graphs() as graphs, _port_kinks(model) as kinks:
            out = model(torch.from_numpy(x), heads=("defrec",))
        assert len(graphs) == (5 if enc == "dgcnn" else 0)
        rng = np.random.default_rng(7)
        w = {n: rng.standard_normal(t.shape).astype(np.float32)
             for n, t in out.items()}
        sum((torch.from_numpy(w[n]) * out[n]).sum() for n in w).backward()
        with _jax_on_graphs(graphs), _jax_on_kinks(kinks):
            (_, want), grads = _jax_eval_grads(enc)(
                v["params"], v["batch_stats"], jnp.asarray(x), w)
        assert set(out) == set(want) == {"cls", "feat", "defrec"}
        for key in want:
            np.testing.assert_allclose(out[key].detach().numpy(),
                                       np.asarray(want[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=key)
        want_g = jw.vit_grads_from_jax(grads)
        named = dict(model.named_parameters())
        assert set(want_g) == set(named)
        got_g = {n: (named[n].grad if named[n].grad is not None
                     else torch.zeros_like(named[n])) for n in want_g}
        bad = {n: g for n, g in grad_gaps(got_g, want_g).items() if g > 1e-4}
        assert not bad, bad

    @pytest.mark.parametrize("enc", list(ENCODERS))
    def test_train_outputs_and_stats_match_jax(self, enc):
        """Train-mode BN: the outputs and every updated running statistic,
        each within its bound plus 3 times JAX's own change under a 1e-6
        input shift (a train-mode BN over a small batch amplifies float32
        rounding, as in the other families' tests)."""
        v = variables(enc, 5)
        x = clouds(6)
        model = port(enc, v).train()
        with torch.no_grad(), _port_graphs() as graphs:
            out = model(torch.from_numpy(x), heads=("defrec",))
        fwd = jax.jit(lambda v, x: jax_model(enc).apply(
            v, x, train=True, heads=("defrec",), mutable=["batch_stats"]))
        with _jax_on_graphs(graphs):  # one trace: both runs on the graphs
            want, mut = fwd(v, jnp.asarray(x))
            moved, moved_mut = fwd(v, jnp.asarray(x + 1e-6))
        for n in out:
            a = np.asarray(want[n])
            floor = np.abs(np.asarray(moved[n]) - a).max()
            np.testing.assert_allclose(out[n].numpy(), a, rtol=1e-4,
                                       atol=1e-4 + 3.0 * floor, err_msg=n)

        def running(m):
            return {k: t for k, t in jw.vit_state_dict_from_jax(
                {"params": v["params"], "batch_stats": m["batch_stats"]}
            ).items() if k.endswith(("running_mean", "running_var"))}

        sd, moved_stats = model.state_dict(), running(moved_mut)
        stats = running(mut)
        assert stats
        for k, t in stats.items():
            floor = float((moved_stats[k] - t).abs().max())
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-5 + 3.0 * floor, err_msg=k)


class TestStep:
    @pytest.mark.parametrize("enc", ["relative", "pointnet", "dgcnn",
                                     "pointnet_tnet"])
    def test_losses_and_grads_match_jax(self, enc):
        """One PointDA iteration under `configs/pointda_vit.yaml`'s recipe
        (PCM, DefRec on the target at 0.5) at B=4, N=128, fed the JAX
        step's own draws (`debug_aux`; the deformed target re-derived from
        the step's key split), eval-mode BN: every loss term within rtol
        1e-4 and every gradient within 1e-4 relative L2. The DefRec
        gradients reach the shared LayerNorm through both of its uses."""
        yaml = load_yaml_dict(str(ROOT / "configs" / "pointda_vit.yaml"))
        flags = dict(batch_size=B, num_points=N, dropout=0.0, model="vit",
                     apply_PCM=yaml["apply_PCM"],
                     DefRec_on_trgt=yaml["DefRec_on_trgt"],
                     DefRec_weight=yaml["DefRec_weight"])
        assert flags["apply_PCM"] and flags["DefRec_on_trgt"]
        cfg_j = dataclasses.replace(JaxConfig(knn_backend="xla", **flags),
                                    debug_aux=True, debug_bn_eval=True)
        cfg = dataclasses.replace(PointDAConfig(**flags), debug_bn_eval=True)
        check_recipe(cfg)
        v = variables(enc, 8)
        src, trgt = clouds(9), clouds(10)
        src /= np.abs(src).max()
        trgt /= np.abs(trgt).max()
        src_y = np.random.default_rng(11).integers(0, 10, B)
        key = jax.random.key(12)
        # the step's draws (from a stand-in model); then the ViT's step on
        # the port's self-kNN graphs and kinks
        stub = _Stub()
        m0 = _jax_step(stub, stub.init(jax.random.key(0), jnp.zeros((1, N, 3)),
                                       heads=("defrec",)),
                       cfg_j, src, src_y, trgt, key)
        aux = {k: torch.from_numpy(np.array(a)) for k, a in m0.items()
               if k.startswith("aux_") and k != "aux_grads"}
        draws = {"mixed": aux["aux_mixed"], "ya": aux["aux_ya"].long(),
                 "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"]}
        keys = jax.random.split(key, 17)
        dx, mask = jsteps.deform_dispatch(
            keys[8], jnp.asarray(aux["aux_trgt"].numpy()), cfg_j)
        assert float(mask.sum(-1).min()) >= 40  # a region each
        draws.update(trgt_dx=torch.from_numpy(np.array(dx)),
                     trgt_dmask=torch.from_numpy(np.array(mask)))
        model = port(enc, v)
        with _port_graphs() as graphs, _port_kinks(model) as kinks:
            total, got = pointda_losses(
                model, cfg, {"src_x": aux["aux_src"],
                             "src_y": torch.from_numpy(src_y),
                             "trgt_x": aux["aux_trgt"]}, draws, None)
        total.backward()
        with _jax_on_graphs(graphs), _jax_on_kinks(kinks):
            m = _jax_step(jax_model(enc), v, cfg_j, src, src_y, trgt, key)
        assert set(got) == {k for k in m if not k.startswith("aux_")}
        assert set(got) == {"src_mixup", "trgt_DefRec", "total"}
        for n, t in got.items():
            assert abs(t.item() / float(m[n]) - 1.0) <= 1e-4, (
                n, t.item(), float(m[n]))
        want_g = jw.vit_grads_from_jax(m["aux_grads"])
        named = dict(model.named_parameters())
        got_g = {n: (named[n].grad if named[n].grad is not None
                     else torch.zeros_like(named[n])) for n in want_g}
        bad = {n: g for n, g in grad_gaps(got_g, want_g).items() if g > 1e-4}
        assert not bad, bad


class _Stub(nn.Module):
    """A stand-in model for the JAX step's draws, which depend on no
    weight: it compiles in a fraction of the ViT's time."""

    @nn.compact
    def __call__(self, x, train=False, heads=()):
        out = {"cls": nn.Dense(10)(x.mean(1))}
        if "defrec" in heads:
            out["defrec"] = nn.Dense(3)(x)
        return out


def _jax_step(model, v, cfg_j, src, src_y, trgt, key):
    """The JAX step's metrics (with `debug_aux`), traced afresh so that
    `_jax_on_graphs` and `_jax_on_kinks` reach it."""
    state = jstate.TrainState.create(
        apply_fn=model.apply, params=v["params"],
        batch_stats=v.get("batch_stats", {}),
        tx=jstate.make_optimizer("ADAM", cfg_j.lr, cfg_j.wd, 0.9,
                                 cfg_j.epochs, 10))
    step = jax.jit(functools.partial(jsteps._pointda_step_inner, cfg=cfg_j))
    return step(state, jnp.asarray(src), jnp.asarray(src_y),
                jnp.asarray(trgt), key)[1]


class TestRefusals:
    def test_fetch_idx_out_of_range_raises_as_jax(self):
        msg = ("fetch_idx [4] out of range for depth=4; set fetch_idx "
               "explicitly when reducing depth")
        bad = {**KW, "fetch_idx": (1, 4)}
        with pytest.raises(ValueError) as jax_err:
            JaxViT(**bad).init(jax.random.key(0), jnp.zeros((1, 64, 3)))
        with pytest.raises(ValueError) as port_err:
            make_model("vit", 10, device="cpu", **bad)
        assert str(jax_err.value) == str(port_err.value) == msg

    def test_unknown_encoder_type_raises_as_jax(self):
        bad = {**KW, "encoder_type": "resnet"}
        with pytest.raises(ValueError) as jax_err:
            JaxViT(**bad).init(jax.random.key(0), jnp.zeros((1, 64, 3)))
        with pytest.raises(ValueError) as port_err:
            make_model("vit", 10, device="cpu", **bad)
        assert str(jax_err.value) == str(port_err.value)

    def test_vit_is_a_pointda_classifier_only(self):
        assert model_heads("vit") == ("defrec",)
        check_recipe(PointDAConfig(model="vit", DefRec_on_trgt=True))
        with pytest.raises(ValueError, match="not a PointSegDA segmenter"):
            check_seg_recipe(PointSegDAConfig(model="vit"))
        with pytest.raises(ValueError, match="unknown heads"):
            make_model("vit", 10, device="cpu", **KW)(
                torch.zeros(1, 64, 3), heads=("normal",))


def test_serving_bundle_rebuilds_a_vit(tmp_path):
    """The bundle records `encoder_type` and `use_absolute` with the
    widths; `ServingModel` rebuilds the same model."""
    kw = {**KW, "encoder_type": "relative", "use_absolute": True}
    model = make_model("vit", 10, device="cpu", dropout=0.0,
                       generator=torch.Generator().manual_seed(3), **kw)
    meta = save_serving_bundle(model, str(tmp_path / "b"), num_points=64)
    assert meta["model"] == "vit" and meta["model_kwargs"] == model.config
    served = ServingModel(str(tmp_path / "b"), device="cpu")
    assert served.model.config == model.config
    x = clouds(3, 64)
    with torch.no_grad():
        want = model(torch.from_numpy(x))["cls"].numpy()
    np.testing.assert_allclose(served.predict(x), want, rtol=1e-6, atol=1e-6)


_CLI = """
import functools, sys
from mlsp_tpu_torch import models
from mlsp_tpu_torch.cli import main
from mlsp_tpu_torch.models.vit import PointViT
# a narrow vit: the CLI has no width flags
models._MODELS["vit"] = functools.partial(
    PointViT, trans_dim=32, encoder_dims=32, depth=2, heads=2, num_group=8,
    group_size=8, fetch_idx=(0, 1), encoder_type=%r)
rc = main(sys.argv[1:])
loaded = {m.split('.')[0] for m in sys.modules}
assert not loaded & %r, loaded & %r
sys.exit(rc)
"""


def test_clis_run_a_vit(tmp_path):
    """`trainer --config configs/pointda_vit.yaml` (PCM, DefRec on the
    target) for one epoch at N=64, then `eval` and `infer --model vit`
    from its checkpoint (equal accuracies, 80 rows of probabilities), then
    one `spst` round of one epoch with PCM from it, each in a process that
    imports no JAX; the "dgcnn" embedder, whose graphs `--knn_backend`
    reaches."""
    code = _CLI % ("dgcnn", FORBIDDEN, FORBIDDEN)

    def run(*argv):
        r = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert r.returncode == 0, r.stderr
        return r.stdout

    common = ["--synthetic", "True", "--device", "cpu", "--num_points", "64",
              "--out_path", str(tmp_path), "--model", "vit"]
    out = run("trainer", "--config", "configs/pointda_vit.yaml", "--epochs",
              "1", "--batch_size", "16", "--test_batch_size", "16",
              "--exp_name", "vit", *common)
    assert "target test accuracy" in out
    with open(tmp_path / "vit" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert {"src_mixup", "trgt_DefRec", "total"} <= set(rec["train"])
    assert all(np.isfinite(v) for v in rec["train"].values())
    ckpt = str(tmp_path / "vit" / "model.ckpt")
    res = {}
    for cmd in ("eval", "infer"):
        out = run(cmd, "--model_file", ckpt, "--test_batch_size", "16",
                  "--exp_name", cmd, *common)
        res[cmd] = json.loads(out.strip().splitlines()[-1].split(": ", 1)[1])
    assert res["eval"]["acc"] == res["infer"]["acc"]
    assert np.load(res["infer"]["output"])["prob"].shape == (80, 10)
    run("spst", "--model_file", ckpt, "--rounds", "1", "--epochs", "1",
        "--threshold", "2.31", "--apply_PCM", "True", "--batch_size", "16",
        "--test_batch_size", "16", "--exp_name", "spst", *common)
    assert (tmp_path / "spst" / "model.ckpt").exists()
