"""The port's PointSegDA slice held against the JAX package on the CPU:
config, YAML and head tables, metrics and summary, data, the weight carry,
the segmentation DGCNN (eval and train forwards, gradients, BatchNorm
statistics), PCM for segmentation and the seg losses (the seg train step:
`test_torch_port_seg_step.py`).

The same numpy inputs go through both packages. Weights go across with
`dgcnn_seg_state_dict_from_jax`, gradients come back with
`dgcnn_seg_grads_from_jax`. Dropout is 0 on both sides (the one random
stream that cannot be shared). Near ties: the two programs share their
kNN graphs (JAX runs on the port's, or the port replays JAX's through
`testing.Tape`), so only rounding separates them.
"""

import argparse
import contextlib
import dataclasses
import importlib
import pathlib
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu import cli as jcli
from mlsp_tpu.data import synthetic as jsynthetic
from mlsp_tpu.data.pointsegda import load_pointsegda as jax_load_pointsegda
from mlsp_tpu.models import DGCNNSeg as JaxDGCNNSeg
from mlsp_tpu.models.dgcnn_seg import LinearEdgeBlock as JaxLinearEdgeBlock
from mlsp_tpu.train import seg_steps as jseg
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils import config as jconfig
from mlsp_tpu.utils import metrics as jmetrics
from mlsp_tpu.utils.summary import model_summary as jax_model_summary
from mlsp_tpu.utils.torch_export import export_dgcnn_seg
from mlsp_tpu_torch import cli, make_model
from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.data.pointsegda import load_pointsegda
from mlsp_tpu_torch.models.dgcnn_seg import LinearEdgeBlock
from mlsp_tpu_torch.testing import Tape, grad_gaps
from mlsp_tpu_torch.train import seg_steps, steps
from mlsp_tpu_torch.utils import config, metrics
from mlsp_tpu_torch.utils.config import PointDAConfig, PointSegDAConfig
from mlsp_tpu_torch.utils.jax_weights import (
    dgcnn_seg_grads_from_jax,
    dgcnn_seg_state_dict_from_jax,
)
from mlsp_tpu_torch.utils.summary import model_summary

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEG_YAMLS = sorted(str(p.relative_to(ROOT)) for p in
                   [*ROOT.glob("configs/pointsegda*.yaml"),
                    *ROOT.glob("configs/pointsegda/*.yaml")])
HEADS = ("seg", "defrec", "normal", "density")
OUTPUTS = ("feat", "seg", "defrec", "normal", "density", "density_mse")
_jdseg = importlib.import_module("mlsp_tpu.models.dgcnn_seg")
_jnormals = importlib.import_module("mlsp_tpu.ops.normals")


def _t(a):
    return torch.from_numpy(np.array(a))


def _shared(port_cfg, jax_cfg) -> tuple[dict, dict]:
    p = dataclasses.asdict(port_cfg)
    j = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    names = set(p) & set(j)
    return {k: p[k] for k in names}, {k: j[k] for k in names}


def _unit_clouds(rng, B, N):
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x -= x.mean(1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(-1)[:, None, None]


# ---------------------------------------------------------------- config


class TestSegConfig:
    def test_fields_are_the_jax_fields_but_the_left_out(self):
        p = {f.name: f.default for f in dataclasses.fields(PointSegDAConfig)}
        j = {f.name: f.default
             for f in dataclasses.fields(jconfig.PointSegDAConfig)}
        assert set(j) - set(p) == {"debug_aux"}
        assert set(p) - set(j) == {"device"}
        assert {k: p[k] for k in j if k in p} == {k: j[k] for k in j
                                                   if k in p}
        assert config.POINTSEGDA_RADIUS == jconfig.POINTSEGDA_RADIUS

    @pytest.mark.parametrize("path", SEG_YAMLS)
    def test_yaml_loads_to_the_same_values(self, path):
        got = config.load_yaml(PointSegDAConfig, str(ROOT / path))
        want = jconfig.load_yaml(jconfig.PointSegDAConfig, str(ROOT / path))
        g, w = _shared(got, want)
        assert g == w
        g, w = _shared(got.resolved(), want.resolved())
        assert g == w

    @pytest.mark.parametrize("d", [{"gather_dtype": "bf16"},
                                   {"debug_aux": True},
                                   {"compute_dtype": "bf16"}])
    def test_left_out_keys_are_refused(self, d):
        """Keys JAX's seg config lacks (`gather_dtype`) and the left-out
        `debug_aux` are refused; `compute_dtype` loads as JAX's does."""
        try:
            want = jconfig.from_dict(jconfig.PointSegDAConfig, d)
        except (ValueError, TypeError):
            want = None
        if want is None or "debug_aux" in d:
            with pytest.raises(ValueError, match="unknown|test-only"):
                config.from_dict(PointSegDAConfig, d)
        else:
            g, w = _shared(config.from_dict(PointSegDAConfig, d), want)
            assert g == w

    @pytest.mark.parametrize("recipe", [
        {}, {"DefRec_on_trgt": False, "Density_normal_viainput": True,
             "Normal_ondef": True, "Density_ondef": True},
        {"Density_normal_viainput": True},
        {"Norm_on_trgt": True, "Density_on_trgt": True},
        {"model": "hengshuang_seg"},
        {"model": "hengshuang_seg", "Norm_on_trgt": True}])
    def test_heads(self, recipe):
        got = PointSegDAConfig(**recipe)
        want = jconfig.PointSegDAConfig(**recipe)
        assert config.seg_model_heads(got.model) == \
            jconfig.seg_model_heads(want.model)
        assert config.trained_seg_heads(got) == jconfig.trained_seg_heads(want)
        try:
            w = jconfig.validate_seg_heads(want)
        except ValueError:
            with pytest.raises(ValueError, match="head"):
                config.validate_seg_heads(got)
        else:
            assert config.validate_seg_heads(got) == w

    def test_cli_merge_equals_the_jax_cli(self):
        """defaults < YAML < flags, as `mlsp_tpu.cli._to_config` merges."""
        argv = ["--config", str(ROOT / "configs/pointsegda/adobe2faust.yaml"),
                "--epochs", "3", "--apply_PCM", "yes", "--lr", "0.01"]
        jparser = argparse.ArgumentParser()
        jcli._add_config_args(jparser, jconfig.PointSegDAConfig)
        want = jcli._to_config(jconfig.PointSegDAConfig,
                               jparser.parse_args(argv))
        got = cli._to_config(PointSegDAConfig,
                             cli.build_parser().parse_args(["seg", *argv]))
        g, w = _shared(got, want)
        assert g == w and got.epochs == 3 and got.apply_PCM
        assert got.exp_name == "MLSP_adobe2faust"


# ---------------------------------------------------- metrics and summary


class TestSegMetrics:
    def test_equal_to_the_jax_metrics(self):
        rng = np.random.default_rng(3)
        y = rng.integers(0, 8, (5, 64))
        p = rng.integers(0, 8, (5, 64))
        y[0][y[0] == 2] = 3  # a label absent from one truth
        p[1] = y[1]
        assert metrics.seg_metrics(y, p) == jmetrics.seg_metrics(y, p)
        for b in range(5):
            assert metrics.jaccard_macro(y[b], p[b]) == \
                jmetrics.jaccard_macro(y[b], p[b])
        assert metrics.jaccard_macro([], []) == jmetrics.jaccard_macro([], [])

    def test_summary_total_equals_the_jax_total(self, seg_variables):
        model = make_model("dgcnn_seg", 8, device="cpu")
        got = model_summary(model).splitlines()
        want = jax_model_summary(seg_variables["params"]).splitlines()
        total = [ln for ln in got if ln.startswith("Total params")]
        assert total == [ln for ln in want if ln.startswith("Total params")]
        assert "shared_layers" in "\n".join(got)


# -------------------------------------------------------------------- data


class TestSegData:
    def test_make_segmentation_bitwise(self):
        for args in ((3, 64, 8, 5), (2, 2048, 8, 40)):
            for got, want in zip(synthetic.make_segmentation(*args),
                                 jsynthetic.make_segmentation(*args)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("name,partition", [
        ("adobe", "train"), ("faust", "val"), ("mit", "test"),
        ("scape", "train")])
    def test_synthetic_fallback_bitwise(self, tmp_path, name, partition):
        got = load_pointsegda(name, str(tmp_path), partition, True, 64)
        want = jax_load_pointsegda(name, str(tmp_path), partition, True, 64)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.label, want.label)
        assert len(got) == {"train": 48, "val": 16, "test": 16}[partition]

    def test_npy_shards(self, tmp_path):
        """[N, 4] shards (xyz, label 1-8) -> labels 0-7, as the JAX loader;
        no fallback without the files."""
        d = tmp_path / "faust" / "train"
        d.mkdir(parents=True)
        rng = np.random.default_rng(4)
        for i in range(3):
            np.save(d / f"shape_{i}.npy", np.concatenate(
                [rng.standard_normal((32, 3)),
                 rng.integers(1, 9, (32, 1))], 1).astype(np.float64))
        got = load_pointsegda("faust", str(tmp_path), "train")
        want = jax_load_pointsegda("faust", str(tmp_path), "train")
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.label, want.label)
        assert got.data.dtype == np.float32 and got.label.dtype == np.int64
        assert got.label.min() >= 0 and got.label.max() <= 7
        with pytest.raises(FileNotFoundError):
            load_pointsegda("faust", str(tmp_path), "test")


# ----------------------------------------------------------------- weights


def _jax_model(dropout=0.0):
    return JaxDGCNNSeg(num_classes=8, k=20, dropout=dropout, knn_backend="xla")


@jax.jit
def _init(key):
    return _jax_model().init({"params": key}, jnp.zeros((1, 64, 3)),
                             train=False, heads=HEADS)


def _randomised(seed):
    """Initialised variables with randomised BatchNorm (gamma of both
    signs, beta, running statistics) and biases."""
    v = _init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def param(path, a):
        if path[-1].key == "scale":
            sign = rng.choice([-1.0, 1.0], a.shape)
            return (sign * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a, np.float32)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v["batch_stats"])}


@pytest.fixture(scope="module")
def seg_variables():
    return _randomised(0)


def _port(variables):
    model = make_model("dgcnn_seg", 8, device="cpu", dropout=0.0)
    model.load_state_dict(dgcnn_seg_state_dict_from_jax(variables),
                          strict=True)
    return model


class TestSegWeights:
    def test_carry_equals_export_and_jax_edge_params(self, seg_variables):
        """Every name the reference layout shares with the port holds
        `export_dgcnn_seg`'s array; the linear edge blocks hold JAX's
        w_diff/w_center kernels, transposed."""
        v = seg_variables
        got = dgcnn_seg_state_dict_from_jax(v)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the pseudo-inverse residual
            want = export_dgcnn_seg(v)
        shared = set(got) & set(want)
        edge = {k for k in got if ".edge" in k}
        assert set(got) - shared == edge and len(edge) == 15
        assert set(want) - shared == {f"shared_layers.conv{i}.{p}"
                                      for i in range(1, 6)
                                      for p in ("weight", "bias")}
        for name in shared:
            np.testing.assert_array_equal(got[name].numpy(), want[name],
                                          err_msg=name)
        for i, j, kind in (("1", 1, "w_diff"), ("2", 0, "w_center"),
                           ("3", 0, "w_diff")):
            leaf = v["params"][f"LinearEdgeBlock_{int(i) - 1}"][f"{kind}{j}"]
            np.testing.assert_array_equal(
                got[f"shared_layers.edge{i}.{kind}{j}.weight"].numpy(),
                np.asarray(leaf["kernel"]).T)
        # the gradient mapping is the weight mapping
        grads = dgcnn_seg_grads_from_jax(v["params"])
        for name, t in grads.items():
            assert torch.equal(t, got[name]), name
        model = make_model("dgcnn_seg", 8, device="cpu")
        assert set(grads) == {n for n, p in model.named_parameters()
                              if p.requires_grad}

    def test_missing_head_names_it(self, seg_variables):
        params = {k: v for k, v in seg_variables["params"].items()
                  if k != "NormPred"}
        with pytest.raises(ValueError, match="NormPred"):
            dgcnn_seg_state_dict_from_jax({"params": params})


# ------------------------------------------------------------------- model


@contextlib.contextmanager
def _jax_on_graphs(graphs):
    """JAX's kNN graphs, the seg model's and the normals', replaced in call
    order by `graphs` (the port's, recorded by `testing.Tape`) while the
    block traces."""
    it = iter(graphs)

    def knn(x, k, *args, **kwargs):
        g = next(it)
        assert tuple(g.shape) == (*x.shape[:2], k)
        return jnp.asarray(np.asarray(g).astype(np.int32))

    with mock.patch.object(_jdseg, "knn_indices", knn), \
            mock.patch.object(_jnormals, "knn_indices", knn):
        yield
    assert next(it, None) is None


def _assert_seg_grads(model, jax_grads, bound, floor_grads=None):
    """Every trainable parameter's gradient within `bound` of JAX's
    (`testing.grad_gaps`: relative L2, the gradients' RMS as the floor of
    the scale), plus, with `floor_grads`, 3 times the JAX gradient's own
    change under a 1e-6 input perturbation (its chaos floor: train-mode BN
    carries a ReLU or max kink that float32 rounding flips to every
    point). A parameter no loss reaches has grad None in the port and an
    all-zero gradient in JAX. Returns the names with a gradient."""
    want = dgcnn_seg_grads_from_jax(jax_grads)
    named = dict(model.named_parameters())
    assert set(want) == {n for n, p in named.items() if p.requires_grad}
    got = {}
    for name, w in want.items():
        if named[name].grad is None:
            np.testing.assert_array_equal(w.numpy(), 0.0, err_msg=name)
        else:
            got[name] = named[name].grad
    want = {n: want[n] for n in got}
    gaps = grad_gaps(got, want)
    floor = (grad_gaps({n: t for n, t in dgcnn_seg_grads_from_jax(
        floor_grads).items() if n in got}, want)
             if floor_grads is not None else dict.fromkeys(got, 0.0))
    bad = {n: (g, floor[n]) for n, g in gaps.items()
           if g > bound + 3.0 * floor[n]}
    assert not bad, bad
    return set(got)


class TestDGCNNSeg:
    @pytest.mark.parametrize("B,N,seed", [(2, 128, 1), (4, 256, 2)])
    def test_eval_forward_matches_jax(self, seg_variables, B, N, seed):
        """Eval mode, every head, on JAX's own kNN graphs and again on the
        port's: rtol 1e-4, atol 1e-4 of each output's largest magnitude."""
        x = _unit_clouds(np.random.default_rng(seed), B, N)
        model = _port(seg_variables)
        tape = Tape()
        with tape.record(), torch.no_grad():
            out = model(torch.from_numpy(x), heads=HEADS)
        assert len(tape.graphs) == 4

        def fwd(xx):
            return _jax_model().apply(seg_variables, xx, train=False,
                                      heads=HEADS)

        own = jax.jit(fwd)(jnp.asarray(x))
        with _jax_on_graphs(tape.graphs):  # a new function: a new trace
            shared = jax.jit(lambda xx: fwd(xx))(jnp.asarray(x))
        for name in OUTPUTS:
            for want in (own, shared):
                w = np.asarray(want[name])
                np.testing.assert_allclose(
                    out[name].numpy(), w, rtol=1e-4,
                    atol=1e-4 * np.abs(w).max(), err_msg=name)

    @pytest.mark.parametrize("B,N,seed", [(2, 128, 3), (4, 256, 4)])
    def test_train_forward_grads_and_stats_match_jax(self, seg_variables, B,
                                                     N, seed):
        """Train mode (batch statistics), every head, JAX on the port's kNN
        graphs: outputs within rtol 1e-4, every gradient of a random
        projection of the outputs within 1e-4 relative L2 plus 3 times
        JAX's own change under a 1e-6 input shift on the same graphs
        (`_assert_seg_grads`), and the updated running statistics within
        rtol 1e-4."""
        rng = np.random.default_rng(seed)
        x = _unit_clouds(rng, B, N)
        shapes = {"feat": (B, 1024), "seg": (B, N, 8), "defrec": (B, N, 3),
                  "normal": (B, N, 3), "density": (B, N, 16),
                  "density_mse": (B, N)}
        w = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        model = _port(seg_variables).train()
        tape = Tape()
        with tape.record():
            out = model(torch.from_numpy(x), heads=HEADS)
        sum((torch.from_numpy(w[n]) * out[n]).sum() for n in OUTPUTS
            ).backward()

        def loss(p, xx):
            o, mut = _jax_model().apply(
                {"params": p, "batch_stats": seg_variables["batch_stats"]},
                xx, train=True, heads=HEADS, mutable=["batch_stats"])
            return sum((w[n] * o[n]).sum() for n in OUTPUTS), (o, mut)

        with _jax_on_graphs(tape.graphs):
            grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
            (_, (want, mut)), grads = grad_fn(seg_variables["params"],
                                              jnp.asarray(x))
        # the same program, so the same graphs
        _, floor = grad_fn(seg_variables["params"], jnp.asarray(x + 1e-6))
        for name in OUTPUTS:
            wn = np.asarray(want[name])
            np.testing.assert_allclose(
                out[name].detach().numpy(), wn, rtol=1e-4,
                atol=1e-4 * np.abs(wn).max(), err_msg=name)
        assert len(_assert_seg_grads(model, grads, 1e-4, floor)) == len(
            dgcnn_seg_grads_from_jax(grads))
        stats = dgcnn_seg_state_dict_from_jax(
            {"params": seg_variables["params"],
             "batch_stats": mut["batch_stats"]})
        got = model.state_dict()
        for name, t in stats.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=name)

    def test_linear_edge_block_shares_tied_gradients(self):
        """Every odd point repeats its predecessor, so each point's max
        over its neighbours is tied: the port's amax shares the gradient
        equally among the tied neighbours, as JAX's max does."""
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 64, 16)).astype(np.float32)
        x[:, 1::2] = x[:, 0::2]
        jb = JaxLinearEdgeBlock((32, 32))
        idx = jnp.asarray(np.sort(rng.integers(0, 64, (2, 64, 8)), -1))
        idx = idx.at[:, :, 0].set(jnp.arange(64))
        idx = idx.at[:, :, 1].set(jnp.arange(64) ^ 1)  # the twin point
        params = jb.init(jax.random.key(0), jnp.asarray(x), idx, False)
        cot = rng.standard_normal((2, 64, 32)).astype(np.float32)
        dx = jax.grad(lambda xx: (jb.apply(params, xx, idx, False) * cot
                                  ).sum())(jnp.asarray(x))

        block = LinearEdgeBlock(16, (32, 32))
        p = params["params"]
        with torch.no_grad():
            for name, leaf in p.items():
                getattr(block, name).weight.copy_(_t(leaf["kernel"]).T)
                if "bias" in leaf:
                    getattr(block, name).bias.copy_(_t(leaf["bias"]))
        xt = torch.from_numpy(x).requires_grad_()
        y = block(xt, _t(idx).long())
        (y * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(
            y.detach().numpy(), np.asarray(jb.apply(params, jnp.asarray(x),
                                                    idx, False)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx),
                                   rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------- steps


class TestSegOps:
    @pytest.mark.parametrize("a,seed", [(1.0, 6), (0.4, 7)])
    def test_pcm_mix_segmentation_matches_jax(self, a, seed):
        """The port's PCM-seg on the JAX step's draws (its key splits) at
        mixup_params a (key 7's Beta(0.4, 0.4) ratio, 0.41, takes points
        of both clouds): clouds and labels equal."""
        B, N = 3, 64
        x = _unit_clouds(np.random.default_rng(7), B, N)
        y = np.random.default_rng(8).integers(0, 8, (B, N))
        key = jax.random.key(seed)
        kperm, klam, ksa, ksb, kpts = jax.random.split(key, 5)
        draws = {"perm": jax.random.permutation(kperm, B),
                 "lam": jax.random.beta(klam, a, a),
                 "start_a": jax.random.randint(ksa, (B,), 0, N),
                 "start_b": jax.random.randint(ksb, (B,), 0, N),
                 "points": jax.random.permutation(kpts, N)}
        got, got_y = steps.pcm_mix_segmentation(
            _t(x), _t(y), {k: _t(v).long() if k != "lam" else _t(v)
                           for k, v in draws.items()})
        want, want_y = jsteps.pcm_mix_segmentation(key, jnp.asarray(x),
                                                   jnp.asarray(y), a)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))

    def test_seg_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(9)
        logits = 3 * rng.standard_normal((2, 50, 8)).astype(np.float32)
        y = rng.integers(0, 8, (2, 50))
        np.testing.assert_allclose(
            float(seg_steps.seg_cross_entropy(_t(logits), _t(y))),
            float(jseg.seg_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(y))), rtol=1e-6)

    def test_trgt_defrec_adds_to_an_earlier_term(self):
        """`_ssl_recipe_losses` adds its DefRec term to a `trgt_DefRec`
        already in the metrics (DefRec_on_trgt with the combined branch),
        as the JAX step sums them."""
        cfg = PointDAConfig(DefRec_weight=0.5)
        rng = np.random.default_rng(10)
        x = _t(_unit_clouds(rng, 2, 64))
        pred = _t(rng.standard_normal((2, 64, 3)).astype(np.float32))
        mask = _t((rng.random((2, 64)) < 0.3).astype(np.float32))
        m = {"trgt_DefRec": torch.tensor(0.25)}
        total = steps._ssl_recipe_losses(cfg, {"defrec": pred}, x, mask,
                                         None, None, None, "trgt", m)
        want = L.defrec_loss(pred, x, mask, 0.5)
        assert float(total) == float(want)
        assert float(m["trgt_DefRec"]) == pytest.approx(0.25 + float(want),
                                                        rel=1e-6)
