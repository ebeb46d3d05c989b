"""The port's SPST stage held against the JAX package on the CPU: the
pseudo-label selection, the SPST losses and gradients, the batch order, a
short run with its files, weights and learning rates, the degenerate
rounds, the refusals and the `spst` CLI in a process without JAX.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_step as ts
from mlsp_tpu.data import pipeline as jpipeline
from mlsp_tpu.losses import losses as jlosses
from mlsp_tpu.train import spst as jspst
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils.config import SPSTConfig as JaxSPSTConfig
from mlsp_tpu.utils.logging import IOStream as JaxIOStream
from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.pointda import load_pointda
from mlsp_tpu_torch.testing import Tape
from mlsp_tpu_torch.train import spst
from mlsp_tpu_torch.train.state import torch_cosine_lr
from mlsp_tpu_torch.utils import checkpoint
from mlsp_tpu_torch.utils.config import SPSTConfig
from mlsp_tpu_torch.utils.logging import IOStream

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}
SSL_PREFIXES = ("DefRec.", "Norm_pred.", "Rec_scan.", "Density_cls.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small CPU forwards here run several times
    faster than with a thread per core beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(v):
    jm = ts._jax_model()
    return jstate.TrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=jstate.make_epoch_lr_optimizer("ADAM", 1e-4, 5e-5, 0.9))


def _gate_between(values):
    v = np.sort(values)
    i = int(np.argmax(np.diff(v)))
    assert v[i + 1] - v[i] > 1e-4, v
    return float((v[i] + v[i + 1]) / 2)


@pytest.mark.parametrize("use_entropy", [True, False])
def test_select_pseudo_labels_matches_jax(tmp_path, use_entropy):
    """The same clouds and labels kept as JAX's selection on the same
    weights: 20 of 24 clouds at batch 8 (the last batch padded), the gate
    halfway across the widest gap between the clouds' confidences."""
    v = ts._variables(1)
    rng = np.random.default_rng(2)
    data = ts._unit_clouds(rng, 24, 128)
    label = rng.integers(0, 10, 24)
    indices = rng.permutation(24)[:20]
    model = ts._port(v)
    with torch.no_grad():
        conf = torch.softmax(model.eval()(torch.from_numpy(data[indices]))[
            "cls"], -1).double()
    score = (-(conf * torch.log_softmax(conf, -1)).sum(-1) if use_entropy
             else conf.amax(-1))
    threshold = _gate_between(score.numpy())
    x, y = spst.select_pseudo_labels(
        model, data, label, indices, 8, threshold, use_entropy,
        IOStream(str(tmp_path), "port"), 0)
    wx, wy = jspst.select_pseudo_labels(
        _jax_state(v), data, label, indices, 8, threshold, use_entropy,
        JaxIOStream(str(tmp_path), "jax"), 0)
    assert 0 < len(wy) < 20
    np.testing.assert_array_equal(x.numpy(), wx)
    np.testing.assert_array_equal(y.numpy(), wy)
    assert y.dtype == torch.int64


@pytest.mark.parametrize("apply_PCM", [False, True])
def test_spst_losses_and_grads_match_jax(apply_PCM):
    """The SPST loss terms within rtol 1e-4 and every gradient within 1e-4
    relative L2, plus 3 times JAX's own change under a 1e-6 input shift,
    of a JAX loss built from the JAX step's own `_apply` and losses on the
    port's transformed clouds (train-mode BN, B=4, N=128, JAX on the
    port's kNN graphs), with spl/cls weights off 1. As in
    `TestTrainModeDGCNN`, the weights and clouds are seeded so that no
    max-pool or ReLU kink lies within rounding (a flip there moves one
    element's share of a gradient, which no input shift measures)."""
    v = ts._variables(1)
    rng = np.random.default_rng(1)
    t_x, s_x = (torch.from_numpy(ts._unit_clouds(rng, 4, 128))
                for _ in range(2))
    t_y, s_y = (torch.from_numpy(rng.integers(0, 10, 4)) for _ in range(2))
    cfg = SPSTConfig(apply_PCM=apply_PCM, dropout=0.0, head_dtype="f32")
    spl_w, cls_w = 0.9, 0.8
    draws = spst.draw_spst(torch.Generator().manual_seed(0), t_x, s_x, s_y,
                           cfg)
    # the target: rotated about z, not jittered
    torch.testing.assert_close(draws["t_x"].norm(dim=-1), t_x.norm(dim=-1))
    torch.testing.assert_close(draws["t_x"][..., 2], t_x[..., 2])
    model = ts._port(v)
    tape = Tape()
    with tape.record():
        total, got = spst.spst_losses(model, cfg, draws, t_y, s_y, spl_w,
                                      cls_w, None)
    total.backward()

    j = {k: jnp.asarray(t.numpy()) for k, t in draws.items()}
    state = _jax_state(v)

    src_name = "mixed" if apply_PCM else "s_x"

    @jax.jit
    def grad_fn(params, tx, sx):
        def loss(p):
            bstats, m = state.batch_stats, {}
            out, bstats = jsteps._apply(state, p, bstats, tx, (),
                                        jax.random.key(0))
            m["trgt_cls"] = spl_w * jlosses.cross_entropy(
                out["cls"], jnp.asarray(t_y.numpy()))
            out, _ = jsteps._apply(state, p, bstats, sx, (),
                                   jax.random.key(1))
            if apply_PCM:
                m["src_mixup"] = jlosses.mixup_cross_entropy(
                    out["cls"], j["ya"], j["yb"], j["lam"], cfg.DefRec_weight)
            else:
                m["src_cls"] = cls_w * jlosses.cross_entropy(
                    out["cls"], jnp.asarray(s_y.numpy()))
            m["total"] = sum(m.values())
            return m["total"], m

        return jax.grad(loss, has_aux=True)(params)

    with ts._jax_on_graphs(tape.graphs):
        grads, m = grad_fn(state.params, j["t_x"], j[src_name])
    # JAX's own change under a 1e-6 input shift, on the same graphs (the
    # trace above is reused): the chaos floor of train-mode BN over B=4
    floor, _ = grad_fn(state.params, j["t_x"] + 1e-6, j[src_name] + 1e-6)
    assert set(got) == set(m)
    for name, t in got.items():
        assert t.item() == pytest.approx(float(m[name]), rel=1e-4), name
    ts._assert_grads(model, grads, 1e-4, floor)
    # only the classifier path trains: the SSL heads have no gradient
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith(SSL_PREFIXES), name


def test_batch_order_matches_jax():
    """Two epochs of (selected target, source) batches from one shared
    numpy generator: the JAX trainer's `zip(batches(...), batches(...))`."""
    src = load_pointda("modelnet", "./none", "train", 32,
                       synthetic_fallback=True, seed=1, device="cpu")
    n_sel = 150
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    ids_t = np.arange(n_sel).astype(np.float32)
    ids_s = np.arange(len(src)).astype(np.float32)
    for _ in range(2):
        got = spst.epoch_pairs(n_sel, src, 32, rng)
        want = list(zip(
            jpipeline.batches(ids_t, ids_t, 32, shuffle=True, drop_last=True,
                              rng=jrng),
            jpipeline.batches(ids_s, ids_s, 32, indices=src.train_ind,
                              shuffle=True, drop_last=True, rng=jrng)))
        assert len(got) == len(want) == 4
        for (t, s), ((wt, _), (ws, _)) in zip(got, want):
            np.testing.assert_array_equal(t, wt)
            np.testing.assert_array_equal(s, ws)


def _pretrained(tmp_path) -> str:
    """A port checkpoint of a seeded DGCNN, standing for the pretrain
    stage's model.ckpt."""
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(11))
    path = str(tmp_path / "pre" / "model.ckpt")
    checkpoint.save_train_state(path, model, epoch=3)
    return path


def _cfg(tmp_path, **kw):
    base = dict(synthetic=True, device="cpu", num_points=64, batch_size=8,
                test_batch_size=8, out_path=str(tmp_path),
                model_file=_pretrained(tmp_path))
    return SPSTConfig(**{**base, **kw})


@pytest.fixture
def small_data(monkeypatch):
    """The synthetic splits cut to 40 train clouds (32 train, 8 val) and 16
    test clouds, so that a CPU run takes seconds."""
    load = spst.load_pointda

    def small(name, dataroot, partition, *args, **kwargs):
        ds = load(name, dataroot, partition, *args, **kwargs)
        if partition != "train":
            return dataclasses.replace(ds, data=ds.data[:16],
                                       label=ds.label[:16])
        return dataclasses.replace(ds, data=ds.data[:40],
                                   label=ds.label[:40]).split(1)

    monkeypatch.setattr(spst, "load_pointda", small)


def test_two_rounds_files_weights_and_lr(tmp_path, small_data):
    """2 rounds x 2 epochs at N=64, B=8 with a threshold that selects every
    target cloud: the files, the per-epoch LR (torch's cosine, unclamped:
    round 2 rises again) and spl/cls weights, the SSL heads byte-identical
    to the loaded checkpoint, the classifier trained."""
    cfg = _cfg(tmp_path, rounds=2, epochs=2, threshold=2.31, apply_PCM=True,
               spl_weight=0.9)
    model, res = spst.train_spst(cfg)
    exp = tmp_path / "SPST"
    for f in ("model.ckpt", "best_model.ckpt", "finetune_convergence.json",
              "metrics.jsonl"):
        assert (exp / f).exists(), f
    curves = json.loads((exp / "finetune_convergence.json").read_text())
    assert all(len(c) == 4 for c in curves.values())
    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1, 2, 3]
    assert [r["round"] for r in recs] == [0, 0, 1, 1]
    lrs = [r["lr"] for r in recs]
    assert lrs == [torch_cosine_lr(1e-4, 2, e) for e in range(4)]
    assert lrs[2] == 0.0 and lrs[3] > lrs[2]
    assert [r["spl_weight"] for r in recs] == pytest.approx(
        [0.9 - 5e-3 * (e + 1) for e in range(4)])
    assert [r["cls_weight"] for r in recs] == pytest.approx(
        [1.0 - 5e-3 * (e + 1) for e in range(4)])
    assert res["spl_weight"] == pytest.approx(0.9 - 0.02)
    assert set(recs[0]["train"]) == {"trgt_cls", "src_mixup", "total"}
    assert all(np.isfinite(v) for r in recs for v in r["train"].values())

    loaded = torch.load(cfg.model_file, weights_only=True)["model"]
    best = torch.load(exp / "model.ckpt", weights_only=True)
    assert best["epoch"] == res["best"]["epoch"] >= 0
    for sd in (model.state_dict(), best["model"]):
        for k, t in loaded.items():
            if k.startswith(SSL_PREFIXES):
                assert torch.equal(sd[k], t), k
        assert not torch.equal(sd["C.mlp3.weight"], loaded["C.mlp3.weight"])
    assert {"initial", "final", "spl_weight", "cls_weight",
            "best"} <= set(res)


@pytest.mark.parametrize("kw", [dict(threshold=0.0, batch_size=8),
                                dict(threshold=10.0, batch_size=64)])
def test_degenerate_rounds_advance_weight_decay(tmp_path, small_data, kw):
    """A selection smaller than one batch (none at all, or all 32 target
    train clouds against a batch of 64) skips the round's epochs and still
    decays spl/cls by epochs x 5e-3; nothing trains, no checkpoint."""
    cfg = _cfg(tmp_path, rounds=2, epochs=3, **kw)
    model, res = spst.train_spst(cfg)
    assert res["spl_weight"] == pytest.approx(1.0 - 5e-3 * 6)
    assert res["cls_weight"] == pytest.approx(1.0 - 5e-3 * 6)
    assert res["best"]["epoch"] == -1
    assert res["final"]["acc"] == res["initial"]["acc"]
    assert not (tmp_path / "SPST" / "model.ckpt").exists()
    loaded = torch.load(cfg.model_file, weights_only=True)["model"]
    assert all(torch.equal(t, loaded[k])
               for k, t in model.state_dict().items())


def test_refusals(tmp_path):
    """A missing file raises FileNotFoundError. A malformed (truncated)
    JAX msgpack `.ckpt` raises ValueError naming it, for `vit` too (ported
    since); `from_torch` on the port's own checkpoint, which is no
    reference state_dict, raises the reference's missing-keys report."""
    with pytest.raises(FileNotFoundError):
        spst.train_spst(_cfg(tmp_path, model_file=str(tmp_path / "no.ckpt")))
    foreign = tmp_path / "jax.ckpt"
    foreign.write_bytes(b"\x82\xa6params\x80")
    for kw in (dict(model_file=str(foreign)),
               dict(model_file=str(foreign), model="vit")):
        with pytest.raises(ValueError, match="jax.ckpt.*truncated"):
            spst.train_spst(_cfg(tmp_path, **kw))
    with pytest.raises(ValueError, match="not found in the checkpoint"):
        spst.train_spst(_cfg(tmp_path, from_torch=True))


def test_config_fields_and_defaults_match_jax():
    """Every field and default of the JAX `SPSTConfig`, the precision and
    EdgeConv-route knobs included, plus the port's `device`."""
    got = {f.name: f.default for f in dataclasses.fields(SPSTConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JaxSPSTConfig)}
    assert set(got) == set(want) | {"device"}
    assert all(got[k] == want[k] for k in want)


_CLI = """
import sys
from mlsp_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = {m.split('.')[0] for m in sys.modules}
assert not loaded & %r, loaded & %r
sys.exit(rc)
""" % (FORBIDDEN, FORBIDDEN)


def test_spst_cli_without_jax(tmp_path):
    """`spst` from a pretrained checkpoint on the CPU in a process that
    imports no JAX; a YAML composes with the flags; without --device cpu
    and without a card it exits 1."""
    run = functools.partial(subprocess.run, capture_output=True, text=True,
                            timeout=300, env={**os.environ,
                                              "OMP_NUM_THREADS": "1"})
    yaml = tmp_path / "spst.yaml"
    yaml.write_text("rounds: 1\nepochs: 1\nthreshold: 2.31\n")
    args = ["spst", "--config", str(yaml), "--synthetic", "True",
            "--num_points", "32", "--batch_size", "32",
            "--test_batch_size", "32", "--model_file",
            _pretrained(tmp_path), "--out_path", str(tmp_path)]
    r = run([sys.executable, "-c", _CLI, *args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    exp = tmp_path / "SPST"
    for f in ("model.ckpt", "best_model.ckpt", "finetune_convergence.json"):
        assert (exp / f).exists(), f
    assert "pseudo label selection: 256/256" in (exp / "run.log").read_text()
    if not torch.cuda.is_available():
        r = run([sys.executable, "-c", _CLI, *args])
        assert r.returncode == 1 and "no CUDA device" in r.stderr
