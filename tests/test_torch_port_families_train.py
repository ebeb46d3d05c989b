"""The Hengshuang segmenter's train step against the JAX package's, and
the new families through the port's entry points on the CPU: the
`trainer`, `eval`, `infer` and `spst` CLIs with PointNet, the
`seg` and `eval`/`infer --task pointsegda` CLIs with HengshuangSeg, and a
serving bundle of a non-DGCNN model.

Models, weights and helpers as in `test_torch_port_families.py`.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_families import FAMILIES, port, variables

from mlsp_tpu.train import seg_steps as jseg
from mlsp_tpu.train import state as jstate
from mlsp_tpu.utils import config as jconfig
from mlsp_tpu_torch import ServingModel, cli, make_model, save_serving_bundle
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.testing import grad_gaps
from mlsp_tpu_torch.train import seg_steps
from mlsp_tpu_torch.utils.config import PointSegDAConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_clouds(rng, b, n):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x -= x.mean(1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(-1)[:, None, None]


def test_hengshuang_seg_step_matches_jax():
    """One seg iteration (the base recipe: source CE, DefRec on the target)
    at B=2, N=128, train-mode BN, dropout 0, the port fed the JAX step's
    own draws (`debug_aux`), each side on its own kNN graphs and FPS
    orders: each loss term within 1e-4 relative and each gradient within
    1e-4 relative L2 (`grad_gaps`), each plus 3 times the JAX step's own
    change under a 1e-6 input shift. The JAX step returns no gradients:
    they come from one step of SGD at lr 1e4, (before - after) / 1e4."""
    B, N = 2, 128
    f = FAMILIES["hengshuang_seg"]
    cfg_j = jconfig.PointSegDAConfig(batch_size=B, num_points=N, dropout=0.0,
                                     knn_backend="xla", debug_aux=True,
                                     model="hengshuang_seg").resolved()
    cfg = PointSegDAConfig(batch_size=B, num_points=N, dropout=0.0,
                           model="hengshuang_seg").resolved()
    v = variables("hengshuang_seg", 13)
    lr = 1e4
    state = jstate.TrainState.create(
        apply_fn=f.jax_model.apply, params=v["params"],
        batch_stats=v["batch_stats"], tx=optax.sgd(lr))
    rng = np.random.default_rng(14)
    src, trgt = _unit_clouds(rng, B, N), _unit_clouds(rng, B, N)
    src_y = rng.integers(0, 8, (B, N))
    key = jax.random.key(15)
    step = jax.jit(functools.partial(jseg._seg_step_inner, cfg=cfg_j))
    new_state, m, (jpreds, jlabels) = step(
        state, jnp.asarray(src), jnp.asarray(src_y), jnp.asarray(trgt), key)
    floor_state, floor, _ = step(state, jnp.asarray(src + 1e-6),
                                 jnp.asarray(src_y),
                                 jnp.asarray(trgt + 1e-6), key)
    aux = {k: torch.from_numpy(np.array(a)) for k, a in m.items()
           if k.startswith("aux_")}
    assert float(aux["aux_dmask"].sum(-1).min()) >= 40  # a region each

    model = port("hengshuang_seg", v)
    total, got, (preds, labels) = seg_steps.pointsegda_losses(
        model, cfg, {"src_x": aux["aux_src"], "src_y": aux["aux_sy"].long(),
                     "trgt_x": aux["aux_trgt"]},
        {"dx": aux["aux_dx"], "dmask": aux["aux_dmask"]}, None)
    total.backward()
    assert set(got) == {k for k in m if not k.startswith("aux_")}
    for name, t in got.items():
        want = float(m[name])
        tol = 1e-4 + 3.0 * abs(float(floor[name]) / want - 1.0)
        assert abs(t.item() / want - 1.0) <= tol, (name, t.item(), want)

    def grads(new):
        return f.grads(jax.tree_util.tree_map(
            lambda a, b: (np.asarray(a) - np.asarray(b)) / lr, v["params"],
            new.params))

    want_g, moved_g = grads(new_state), grads(floor_state)
    named = dict(model.named_parameters())
    assert set(want_g) == set(named)
    got_g = {n: (named[n].grad if named[n].grad is not None
                 else torch.zeros_like(named[n])) for n in want_g}
    gaps, floor_g = grad_gaps(got_g, want_g), grad_gaps(moved_g, want_g)
    bad = {n: (g, floor_g[n]) for n, g in gaps.items()
           if g > 1e-4 + 3.0 * floor_g[n]}
    assert not bad, bad
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert (preds.numpy() == np.asarray(jpreds)).mean() >= 0.99


def _run(argv) -> dict:
    kernels.reset_launches()
    assert cli.main(argv) == 0
    assert not any(kernels.launches().values())  # CPU tensors: plain only
    return kernels.launches()


def _summary(path) -> dict:
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1].split(": ", 1)[1])


def test_pointda_clis_run_a_pointnet(tmp_path):
    """`trainer --model pointnet --DefRec_on_trgt True` (PCM and DefRec on
    the target, full width) for one epoch at N=64, then `eval` and `infer
    --model pointnet` from its checkpoint (equal accuracies, 80 rows of
    probabilities), then one `spst` round of one epoch from it, all on the
    CPU. (PointNet: the cheapest family on the CPU; the full-width
    PointTransformer and Hengshuang take these paths in `chip_smoke.py`.)"""
    out = str(tmp_path)
    common = ["--synthetic", "True", "--device", "cpu", "--num_points", "64",
              "--out_path", out, "--model", "pointnet"]
    _run(["trainer", "--DefRec_on_trgt", "True", "--epochs", "1",
          "--batch_size", "16", "--test_batch_size", "16",
          "--exp_name", "pn", *common])
    ckpt = str(tmp_path / "pn" / "model.ckpt")
    with open(tmp_path / "pn" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert {"src_mixup", "trgt_DefRec", "total"} <= set(rec["train"])
    assert all(np.isfinite(v) for v in rec["train"].values())
    for cmd in ("eval", "infer"):
        _run([cmd, "--model_file", ckpt, "--test_batch_size", "16",
              "--exp_name", cmd, *common])
    ev = _summary(tmp_path / "eval" / "run.log")
    inf = _summary(tmp_path / "infer" / "run.log")
    assert ev["acc"] == inf["acc"]
    pred = np.load(inf["output"])
    assert pred["prob"].shape == (80, 10)
    assert np.allclose(pred["prob"].sum(-1), 1.0, atol=1e-5)
    _run(["spst", "--model_file", ckpt, "--rounds", "1", "--epochs", "1",
          "--threshold", "2.31", "--apply_PCM", "True", "--batch_size", "16",
          "--test_batch_size", "16", "--exp_name", "spst", *common])
    assert (tmp_path / "spst" / "model.ckpt").exists()


def test_seg_clis_run_a_hengshuang_seg(tmp_path):
    """`seg --config configs/pointsegda_hengshuang.yaml` (DefRec on the
    target, full width) for one epoch at N=64, then `eval` and `infer
    --task pointsegda --model hengshuang_seg` from its checkpoint (equal
    per-point accuracies, [16, 64, 8] probabilities), on the CPU."""
    out = str(tmp_path)
    common = ["--synthetic", "True", "--device", "cpu", "--num_points", "64",
              "--out_path", out]
    _run(["seg", "--config", "configs/pointsegda_hengshuang.yaml",
          "--epochs", "1", "--batch_size", "8", "--test_batch_size", "8",
          "--exp_name", "hs", *common])
    ckpt = str(tmp_path / "hs_adobe_faust" / "model.ckpt")
    for cmd in ("eval", "infer"):
        _run([cmd, "--task", "pointsegda", "--model", "hengshuang_seg",
              "--model_file", ckpt, "--test_batch_size", "8",
              "--exp_name", cmd, *common])
    ev = _summary(tmp_path / "eval" / "run.log")
    inf = _summary(tmp_path / "infer" / "run.log")
    assert ev["acc"] == inf["acc"] and np.isfinite(ev["miou"])
    assert np.load(inf["output"])["prob"].shape == (16, 64, 8)


@pytest.mark.parametrize("name,kw", [
    ("point_transformer", dict(trans_dim=32, depth=2, heads=2, num_group=8,
                               group_size=8, encoder_dims=32,
                               fetch_idx=(0, 1))),
    ("hengshuang", dict(nblocks=2, d_model=16)),
])
def test_serving_bundle_rebuilds_the_family(tmp_path, name, kw):
    """A non-DGCNN bundle records its model's own name and config, and
    `ServingModel` rebuilds that model: answers equal the model's."""
    model = make_model(name, 10, device="cpu", dropout=0.0,
                       generator=torch.Generator().manual_seed(3), **kw)
    meta = save_serving_bundle(model, str(tmp_path / "b"), num_points=64)
    assert meta["model"] == name and meta["model_kwargs"] == model.config
    served = ServingModel(str(tmp_path / "b"), device="cpu")
    assert type(served.model) is type(model)
    x, _ = make_classification(5, 64, seed=2)
    with torch.no_grad():
        want = model(torch.from_numpy(x))["cls"].numpy()
    np.testing.assert_allclose(served.predict(x), want, rtol=1e-6, atol=1e-6)


def test_segmenter_bundle_is_queued(tmp_path):
    """Segmentation bundles are ported: a HengshuangSeg bundle records
    task "pointsegda" and serves the model's own per-point logits
    [B, N, 8] (`model(x, ("seg",))["seg"]`), for a batch of any size."""
    model = make_model("hengshuang_seg", 8, device="cpu", dropout=0.0,
                       generator=torch.Generator().manual_seed(3),
                       nblocks=2, d_model=16)
    meta = save_serving_bundle(model, str(tmp_path / "b"), num_points=64,
                               num_class=8)
    assert meta["task"] == "pointsegda" and meta["model"] == "hengshuang_seg"
    served = ServingModel(str(tmp_path / "b"), device="cpu")
    for b in (3, 5):
        x, _ = make_classification(b, 64, seed=b)
        with torch.no_grad():
            want = model(torch.from_numpy(x), ("seg",))["seg"].numpy()
        got = served.predict(x)
        assert got.shape == (b, 64, 8)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
