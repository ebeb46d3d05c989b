"""The port's PointSegDA trainer, seg eval and infer and the `seg` CLI on
the CPU.

Against the JAX package: `evaluate_seg`, `run_eval` and `run_infer` on the
same DGCNNSeg weights (a JAX checkpoint, carried over with
`utils.jax_weights`) and the same synthetic split, and the trainer's batch
order. Within the port: a 2-epoch MLSP-recipe run with PCM (N=64) and what
it leaves behind, the best-epoch selection, frozen untrained heads, the
non-finite abort, and the CLI in a process that imports no JAX.
"""

import contextlib
import importlib
import json
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.data import pipeline as jpipeline
from mlsp_tpu.data.pointsegda import load_pointsegda as jax_load_pointsegda
from mlsp_tpu.train import evaluation as jeval
from mlsp_tpu.train import pointsegda_trainer as jtrainer
from mlsp_tpu.train.state import create_train_state
from mlsp_tpu.utils import checkpoint as jcheckpoint
from mlsp_tpu.utils import metrics as jmetrics
from mlsp_tpu.utils.config import EvalConfig as JaxEvalConfig
from mlsp_tpu_torch import cli, make_model
from mlsp_tpu_torch.data.pointsegda import load_pointsegda
from mlsp_tpu_torch.train import evaluation, pointsegda_trainer
from mlsp_tpu_torch.train.pointda_trainer import eval_batches, epoch_pairs
from mlsp_tpu_torch.utils import checkpoint
from mlsp_tpu_torch.utils.config import (
    EvalConfig,
    PointSegDAConfig,
    load_yaml,
)
from mlsp_tpu_torch.utils.jax_weights import dgcnn_seg_state_dict_from_jax

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
N, B = 64, 8
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}
MLSP_YAML = str(ROOT / "configs/pointsegda/adobe2faust.yaml")
_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_jdseg = importlib.import_module("mlsp_tpu.models.dgcnn_seg")


def _randomise(variables, seed):
    """gamma of both signs, beta and running statistics away from their
    init values."""
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

    return (jax.tree_util.tree_map_with_path(param, variables["params"]),
            jax.tree_util.tree_map_with_path(stat, variables["batch_stats"]))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of DGCNNSeg weights as a JAX checkpoint and as a port one."""
    d = tmp_path_factory.mktemp("seg_weights")
    jcfg = JaxEvalConfig(task="pointsegda", synthetic=True, num_points=N,
                         test_batch_size=B).resolved()
    jmodel, heads = jeval._build_model(jcfg)
    state = create_train_state(jmodel, jax.random.key(0),
                               jnp.zeros((B, N, 3)), heads=heads)
    params, stats = _randomise({"params": state.params,
                                "batch_stats": state.batch_stats}, 12)
    state = state.replace(params=params, batch_stats=stats)
    jcheckpoint.save_train_state(str(d / "jax.ckpt"), state, 0, {})
    model = make_model("dgcnn_seg", 8, device="cpu")
    model.load_state_dict(dgcnn_seg_state_dict_from_jax(
        {"params": params, "batch_stats": stats}), strict=True)
    checkpoint.save_train_state(str(d / "port.ckpt"), model)
    return {"dir": d, "state": state, "model": model}


class _Graphs:
    """The port's kNN graphs in call order (per batch, the four of
    DGCNNSeg), and the JAX model's eval forward on them."""

    def __init__(self):
        self.graphs = []

    @contextlib.contextmanager
    def record(self):
        plain = _knn.knn_indices_torch

        def knn(x, k):
            out = plain(x, k)
            self.graphs.append(out.numpy().astype(np.int32))
            return out

        with mock.patch.object(_knn, "knn_indices_torch", knn):
            yield self

    def jax_logits(self, state, data, sels) -> np.ndarray:
        """[S, B, N, C] seg logits of the JAX model on the recorded
        graphs."""
        @jax.jit
        def fwd(params, stats, x, graphs):
            it = iter(graphs)
            with mock.patch.object(_jdseg, "knn_indices",
                                   lambda *a, **kw: next(it)):
                return state.apply_fn({"params": params,
                                       "batch_stats": stats}, x,
                                      train=False)["seg"]

        assert len(self.graphs) == 4 * len(sels)
        return np.stack([np.asarray(fwd(state.params, state.batch_stats,
                                        jnp.asarray(data[sel]),
                                        tuple(self.graphs[4 * i:4 * i + 4])))
                         for i, sel in enumerate(sels)])


class TestAgainstJax:
    @pytest.mark.parametrize("split", ["test", "val"])
    def test_run_infer_and_evaluate_seg(self, weights, tmp_path, split):
        """Per-point probabilities within 1e-4 of the JAX model run on the
        port's kNN graphs; classes equal to the JAX run's own where the
        top-2 margin exceeds 1e-3; `evaluate_seg`'s loss within 1e-4 of
        the JAX trainer's and its mIoU and accuracy equal."""
        d = weights["dir"]
        kw = dict(task="pointsegda", dataset="faust", split=split,
                  synthetic=True, num_points=N, test_batch_size=B,
                  out_path=str(tmp_path))
        want = jeval.run_infer(JaxEvalConfig(
            model_file=str(d / "jax.ckpt"), exp_name="j", **kw))
        rec = _Graphs()
        with rec.record():
            got = evaluation.run_infer(EvalConfig(
                model_file=str(d / "port.ckpt"), exp_name="p", device="cpu",
                **kw))
        w, g = np.load(want["output"]), np.load(got["output"])
        for name in ("index", "label"):
            np.testing.assert_array_equal(g[name], w[name])
        assert g["prob"].shape == w["prob"].shape == (16, N, 8)
        ds = load_pointsegda("faust", ".", split, True, N)
        sels, counts = eval_batches(len(ds), B)
        shared = np.concatenate([lg[:n] for lg, n in zip(
            rec.jax_logits(weights["state"], ds.data, sels), counts)])
        np.testing.assert_allclose(
            g["prob"], jmetrics.softmax_np(shared), rtol=0, atol=1e-4)
        top2 = np.sort(np.log(w["prob"]), -1)[..., -2:]
        mask = top2[..., 1] - top2[..., 0] > 1e-3
        assert mask.mean() > 0.99
        np.testing.assert_array_equal(g["pred"][mask], w["pred"][mask])
        assert got["n"] == want["n"] == 16

        jl, jm, ja = jtrainer.evaluate_seg(weights["state"], ds.data,
                                           ds.label, B)
        pl, pm, pa = pointsegda_trainer.evaluate_seg(weights["model"],
                                                     ds.data, ds.label, B)
        assert abs(pl - jl) <= 1e-4 * abs(jl)
        if mask.all():
            assert (pm, pa) == (jm, ja)
        assert round(pa, 6) == got["acc"]

    def test_run_eval_reports_evaluate_seg(self, weights, tmp_path):
        r = evaluation.run_eval(EvalConfig(
            task="pointsegda", model_file=str(weights["dir"] / "port.ckpt"),
            synthetic=True, num_points=N, test_batch_size=B,
            out_path=str(tmp_path), device="cpu"))
        ds = load_pointsegda("faust", ".", "test", True, N)
        loss, miou, acc = pointsegda_trainer.evaluate_seg(
            weights["model"], ds.data, ds.label, B)
        assert r == {"dataset": "faust", "split": "test",
                     "loss": round(loss, 6), "miou": round(miou, 6),
                     "acc": round(acc, 6)}

    @pytest.mark.parametrize("epoch", [0, 3])
    def test_epoch_batch_order_equals_the_jax_trainer(self, epoch):
        """The JAX seg trainer's two `batches` iterators on one
        `SeedSequence((seed, epoch))` generator, zipped."""
        src = jax_load_pointsegda("adobe", ".", "train", True, 16)
        trgt = jpipeline.Dataset(src.data[:40], src.label[:40])
        erng = np.random.default_rng(np.random.SeedSequence((1, epoch)))
        want = list(zip(
            jpipeline.batches(src.data, src.label, 16, shuffle=True,
                              drop_last=True, rng=erng),
            jpipeline.batches(trgt.data, trgt.label, 16, shuffle=True,
                              drop_last=True, rng=erng)))
        got = epoch_pairs(load_pointsegda("adobe", ".", "train", True, 16),
                          jpipeline.Dataset(src.data[:40], src.label[:40]),
                          16, 1, epoch)
        assert len(got) == len(want) == 2
        for (s, t), ((sx, sy), (tx, _)) in zip(got, want):
            np.testing.assert_array_equal(src.data[s], sx)
            np.testing.assert_array_equal(src.label[s], sy)
            np.testing.assert_array_equal(trgt.data[t], tx)


def _mlsp_cfg(out, **kw):
    """The MLSP recipe of the adobe -> faust config, with PCM, at N=64."""
    cfg = load_yaml(PointSegDAConfig, MLSP_YAML)
    return type(cfg)(**{**cfg.__dict__, "synthetic": True, "apply_PCM": True,
                        "epochs": 2, "num_points": N, "device": "cpu",
                        "out_path": str(out), **kw})


@pytest.fixture(scope="module")
def seg_run(tmp_path_factory):
    """A 2-epoch run in which epoch 1's source val loss is reported 100
    higher than it is, so the best epoch (0) is not the last."""
    out = tmp_path_factory.mktemp("seg")
    real = pointsegda_trainer.evaluate_seg
    calls = []

    def evaluate(*args):
        r = real(*args)
        calls.append(r)
        return (r[0] + 100.0, *r[1:]) if len(calls) == 3 else r

    live = {}
    load = torch.nn.Module.load_state_dict

    def keep_live(self, state_dict, *a, **kw):  # before the best is loaded
        live.update({k: t.clone() for k, t in self.state_dict().items()})
        return load(self, state_dict, *a, **kw)

    with mock.patch.object(pointsegda_trainer, "evaluate_seg", evaluate), \
            mock.patch.object(torch.nn.Module, "load_state_dict", keep_live):
        model, results = pointsegda_trainer.train_pointsegda(_mlsp_cfg(out))
    return {"dir": out / "MLSP_adobe2faust_adobe_faust", "model": model,
            "results": results, "calls": calls, "live": live}


class TestSegTrainer:
    def test_files_log_lines_and_metrics(self, seg_run):
        d = seg_run["dir"]
        for f in ("model.ckpt", "run.log", "metrics.jsonl"):
            assert (d / f).exists(), f
        log = (d / "run.log").read_text()
        for line in ("Total params", "heads trained: seg, defrec, normal, "
                     "density", "Best model was found at epoch 0",
                     "target test seg loss:"):
            assert line in log, line
        recs = [json.loads(x) for x in
                (d / "metrics.jsonl").read_text().splitlines()]
        assert [r["epoch"] for r in recs] == [0, 1]
        assert set(recs[0]["train"]) == {
            "src_seg", "trgt_DefRec", "trgt_def_normal",
            "trgt_def_density_cls", "trgt_def_density_mse", "total",
            "src_train_mIoU"}
        assert all(np.isfinite(v) for r in recs for v in r["train"].values())
        assert 0.0 <= recs[1]["train"]["src_train_mIoU"] <= 1.0
        assert set(recs[0]["src_val"]) == {"loss", "mIoU", "acc"}
        # 48 train clouds a domain at B=16: 3 steps an epoch; 2 val splits
        # an epoch and the final test
        assert len(seg_run["calls"]) == 5

    def test_best_epoch_by_source_val_loss(self, seg_run):
        """Epoch 1's source val loss is reported higher, so epoch 0 is the
        best: model.ckpt holds it, the returned model has its weights (not
        the live ones), and the final test ran on them."""
        d, res = seg_run["dir"], seg_run["results"]
        assert res["best"]["epoch"] == 0
        best = make_model("dgcnn_seg", 8, device="cpu")
        assert checkpoint.load_train_state(str(d / "model.ckpt"), best)[0] == 0
        got = seg_run["model"].state_dict()
        for k, v in best.state_dict().items():
            assert torch.equal(got[k], v), k
        assert any(not torch.equal(seg_run["live"][k], v)
                   for k, v in got.items())
        ds = load_pointsegda("faust", ".", "test", True, N)
        loss, miou, acc = pointsegda_trainer.evaluate_seg(best, ds.data,
                                                          ds.label, 32)
        assert res["test"] == {"loss": loss, "mIoU": miou, "acc": acc}

    def test_untrained_heads_stay_frozen(self, tmp_path):
        """The base recipe (DefRec on the target) reads no normal or
        density output: those heads keep their initial weights and BN
        statistics; the trained ones move."""
        cfg = PointSegDAConfig(synthetic=True, epochs=1, num_points=N,
                               out_path=str(tmp_path), device="cpu")
        model, _ = pointsegda_trainer.train_pointsegda(cfg)
        init = make_model("dgcnn_seg", 8, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        a, b = init.state_dict(), model.state_dict()
        for head in ("Norm_pred.", "Density_cls."):
            keys = [k for k in a if k.startswith(head)]
            assert keys and all(torch.equal(a[k], b[k]) for k in keys), head
        for head in ("seg.", "DefRec.", "shared_layers."):
            assert any(not torch.equal(a[k], b[k]) for k in a
                       if k.startswith(head)), head
        log = (tmp_path / "DefRec_PCM_adobe_faust" / "run.log").read_text()
        assert "heads trained: seg, defrec; frozen: normal, density" in log

    def test_nonfinite_loss_aborts(self, tmp_path):
        cfg = PointSegDAConfig(synthetic=True, epochs=1, num_points=32,
                               lr=float("inf"), out_path=str(tmp_path),
                               exp_name="nan", device="cpu")
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            pointsegda_trainer.train_pointsegda(cfg)
        raw = torch.load(tmp_path / "nan_adobe_faust" / "nonfinite_crash.ckpt",
                         weights_only=True)
        assert raw["epoch"] == 0 and "src_seg" in raw["metrics"][
            "nonfinite_terms"]

    def test_not_ported_raise(self, tmp_path):
        """`vit` (a classifier) is refused as a segmenter, by the seg
        trainer and by seg eval; the recipe's head check and SGD as
        before."""
        base = dict(synthetic=True, device="cpu", out_path=str(tmp_path))
        with pytest.raises(ValueError, match="not a PointSegDA segmenter"):
            pointsegda_trainer.train_pointsegda(PointSegDAConfig(
                model="vit", **base))
        with pytest.raises(ValueError, match="head"):
            pointsegda_trainer.train_pointsegda(PointSegDAConfig(
                model="hengshuang_seg", Norm_on_trgt=True, **base))
        # SGD trains: the optimizer's refusal is gone
        cfg = PointSegDAConfig(optimizer="SGD", epochs=1, num_points=32,
                               exp_name="sgd", **base)
        model, res = pointsegda_trainer.train_pointsegda(cfg)
        init = make_model("dgcnn_seg", 8, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        assert not torch.equal(init.state_dict()["seg.conv1.weight"],
                               model.state_dict()["seg.conv1.weight"])
        assert np.isfinite(res["test"]["loss"])
        with pytest.raises(ValueError, match="does not serve"):
            evaluation.run_eval(EvalConfig(task="pointsegda", model="vit",
                                           **base))


_CLI = """
import sys
from mlsp_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = {m.split('.')[0] for m in sys.modules}
assert not loaded & %r, loaded & %r
sys.exit(rc)
""" % (FORBIDDEN, FORBIDDEN)


class TestSegCli:
    def test_seg_then_eval_and_infer(self, tmp_path):
        """The `seg` CLI with the MLSP config on the CPU, then `eval` and
        `infer --task pointsegda` on its model.ckpt, in processes that
        import no JAX."""
        def run(*argv):
            return subprocess.run([sys.executable, "-c", _CLI, *argv],
                                  cwd=ROOT, capture_output=True, text=True,
                                  timeout=600)

        common = ["--synthetic", "True", "--device", "cpu", "--num_points",
                  str(N), "--out_path", str(tmp_path)]
        r = run("seg", "--config", MLSP_YAML, "--epochs", "1", "--apply_PCM",
                "True", *common)
        assert r.returncode == 0, r.stderr
        assert "target test seg mIOU" in r.stdout
        ckpt = str(tmp_path / "MLSP_adobe2faust_adobe_faust" / "model.ckpt")
        task = ["--task", "pointsegda", "--model_file", ckpt]
        r = run("eval", *task, *common)
        assert r.returncode == 0, r.stderr
        ev = json.loads(r.stdout.strip().splitlines()[-1].split(": ", 1)[1])
        r = run("infer", *task, *common)
        assert r.returncode == 0, r.stderr
        inf = json.loads(r.stdout.strip().splitlines()[-1].split(": ", 1)[1])
        assert ev["acc"] == inf["acc"] and inf["n"] == 16
        assert set(ev) == {"dataset", "split", "loss", "miou", "acc"}
        out = np.load(inf["output"])
        assert out["prob"].shape == (16, N, 8) and out["pred"].shape == (16, N)

    def test_no_card_without_device_cpu(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert cli.main(["seg", "--synthetic", "True"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert cli.main(["eval", "--task", "pointsegda", "--model_file",
                         "x.ckpt"]) == 1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_model("dgcnn_seg", 8)
