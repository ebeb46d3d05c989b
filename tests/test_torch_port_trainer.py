"""The port's PointDA trainer, eval and infer on the CPU.

Against the JAX package: `evaluate` and `run_infer` on the same DGCNN
weights (a JAX checkpoint, carried over with `utils.jax_weights`) and the
same synthetic split. Within the port: a paper-recipe run (N=64, B=8, 2
epochs) and what it leaves behind, resume, the best-epoch selection, the
frozen scan head, the non-finite abort, checkpoint shape checks, and the
CLI in a process that imports no JAX.
"""

import contextlib
import functools
import importlib
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.train import evaluation as jeval
from mlsp_tpu.train import pointda_trainer as jtrainer
from mlsp_tpu.train.state import create_train_state
from mlsp_tpu.utils import checkpoint as jcheckpoint
from mlsp_tpu.utils import metrics as jmetrics
from mlsp_tpu.utils.config import EvalConfig as JaxEvalConfig
from mlsp_tpu_torch import cli, make_model, models
from mlsp_tpu_torch.data.pointda import load_pointda
from mlsp_tpu_torch.train import evaluation, pointda_trainer
from mlsp_tpu_torch.utils import checkpoint
from mlsp_tpu_torch.utils.config import EvalConfig, PointDAConfig
from mlsp_tpu_torch.utils.jax_weights import dgcnn_state_dict_from_jax

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
N, B = 64, 8
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}
_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_jdgcnn = importlib.import_module("mlsp_tpu.models.dgcnn")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the file's tests, then the count it had: beside
    the other test processes the paper run's small steps go several times
    faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(variables, seed):
    """gamma of both signs (a negative gamma turns EdgeConvM's max into a
    min), beta and running statistics away from their init values."""
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
    """One set of DGCNN weights as a JAX checkpoint and as a port one."""
    d = tmp_path_factory.mktemp("weights")
    jcfg = JaxEvalConfig(synthetic=True, num_points=N, test_batch_size=B)
    jmodel, heads = jeval._build_model(jcfg)
    state = create_train_state(jmodel, jax.random.key(0),
                               jnp.zeros((B, N, 3)), heads=heads)
    params, stats = _randomise({"params": state.params,
                                "batch_stats": state.batch_stats}, 11)
    state = state.replace(params=params, batch_stats=stats)
    jcheckpoint.save_train_state(str(d / "jax.ckpt"), state, 0, {})
    model = make_model("dgcnn", 10, device="cpu")
    model.load_state_dict(dgcnn_state_dict_from_jax(
        {"params": params, "batch_stats": stats}), strict=True)
    checkpoint.save_train_state(str(d / "port.ckpt"), model)
    return {"dir": d, "state": state, "model": model}


class _Graphs:
    """The kNN graphs of the port's run, in call order (per batch, the
    five of DGCNN), and the JAX model's eval forward on them: with the
    discrete choices shared, only rounding separates the two programs
    (near-tie rows may otherwise take other neighbours in each)."""

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
        """[S, B, C] logits of the JAX model on the recorded graphs."""
        @jax.jit
        def fwd(params, stats, x, graphs):
            it = iter(graphs)
            with mock.patch.object(_jdgcnn, "knn_indices",
                                   lambda *a, **kw: next(it)):
                return state.apply_fn({"params": params,
                                       "batch_stats": stats}, x,
                                      train=False)["cls"]

        assert len(self.graphs) == 5 * len(sels)
        return np.stack([np.asarray(fwd(state.params, state.batch_stats,
                                        jnp.asarray(data[sel]),
                                        tuple(self.graphs[5 * i:5 * i + 5])))
                         for i, sel in enumerate(sels)])


def _margin_mask(prob):
    """Clouds whose top-2 logit margin exceeds 1e-3: there the two
    programs must predict the same class."""
    top2 = np.sort(np.log(prob), -1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > 1e-3


class TestAgainstJax:
    @pytest.mark.parametrize("split", ["test", "val"])
    def test_run_infer_and_evaluate(self, weights, tmp_path, split):
        d = weights["dir"]
        kw = dict(dataset="scannet", split=split, synthetic=True,
                  num_points=N, test_batch_size=B, out_path=str(tmp_path))
        want = jeval.run_infer(JaxEvalConfig(
            model_file=str(d / "jax.ckpt"), exp_name="j", **kw))
        rec = _Graphs()
        with rec.record():
            got = evaluation.run_infer(EvalConfig(
                model_file=str(d / "port.ckpt"), exp_name="p", device="cpu",
                **kw))
        w, g = np.load(want["output"]), np.load(got["output"])
        np.testing.assert_array_equal(g["index"], w["index"])
        np.testing.assert_array_equal(g["label"], w["label"])
        ds = load_pointda("scannet", ".", "train" if split == "val" else
                          "test", N, True, 1, device="cpu")
        idx = ds.val_ind if split == "val" else None
        sels, counts = pointda_trainer.eval_batches(len(ds), B, idx)
        shared = np.concatenate([lg[:n] for lg, n in zip(
            rec.jax_logits(weights["state"], ds.data, sels), counts)])
        np.testing.assert_allclose(
            g["prob"], jmetrics.softmax_np(shared), rtol=0, atol=1e-4)
        mask = _margin_mask(w["prob"])
        assert mask.mean() > 0.9
        np.testing.assert_array_equal(g["pred"][mask], w["pred"][mask])
        assert got["n"] == want["n"] == (80 if split == "test" else 64)

        # evaluate on the same split and weights, through the JAX trainer's
        er = jtrainer.evaluate(weights["state"], ds.data, ds.label, B, 10, idx)
        pr = pointda_trainer.evaluate(weights["model"], ds.data, ds.label, B,
                                      10, idx)
        assert abs(pr["loss"] - er["loss"]) <= 1e-4 * abs(er["loss"])
        keep = np.ones(len(mask), bool) if mask.all() else mask
        from mlsp_tpu_torch.utils.metrics import confusion_matrix

        np.testing.assert_array_equal(
            confusion_matrix(g["label"][keep], g["pred"][keep], 10),
            confusion_matrix(w["label"][keep], w["pred"][keep], 10))
        if mask.all():
            np.testing.assert_array_equal(pr["conf_mat"], er["conf_mat"])
            assert pr["acc"] == er["acc"] == got["acc"]
            assert pr["balanced_acc"] == er["balanced_acc"]

    def test_run_eval_reports_evaluate(self, weights, tmp_path):
        r = evaluation.run_eval(EvalConfig(
            model_file=str(weights["dir"] / "port.ckpt"), synthetic=True,
            num_points=N, test_batch_size=B, out_path=str(tmp_path),
            device="cpu"))
        ds = load_pointda("scannet", ".", "test", N, True, 1, device="cpu")
        want = pointda_trainer.evaluate(weights["model"], ds.data, ds.label,
                                        B, 10)
        assert r["acc"] == round(want["acc"], 6)
        assert r["loss"] == round(want["loss"], 6)
        assert (tmp_path / "EVAL" / "Eval_eval_conf_mat.csv").exists()


def _paper_cfg(out, name, **kw):
    return PointDAConfig(synthetic=True, epochs=2, num_points=N, batch_size=B,
                         test_batch_size=B, out_path=str(out), exp_name=name,
                         save_every=1, device="cpu", **kw).paper_recipe


@pytest.fixture(scope="module")
def paper_run(tmp_path_factory):
    """A 2-epoch paper-recipe run; `last.ckpt` after epoch 0 is kept as
    `last_e0.ckpt` beside it."""
    out = tmp_path_factory.mktemp("paper")
    save = checkpoint.save_train_state

    def keep_epoch0(path, *args, **kw):
        save(path, *args, **kw)
        if path.endswith("last.ckpt") and kw.get("epoch", args[3]) == 0:
            shutil.copy(path, path.replace("last.ckpt", "last_e0.ckpt"))

    with mock.patch.object(checkpoint, "save_train_state", keep_epoch0):
        model, results = pointda_trainer.train_pointda(_paper_cfg(out, "a"))
    return {"dir": out / "a", "model": model, "results": results,
            "cfg": _paper_cfg(out, "a")}


class TestTrainer:
    def test_files_and_log_lines(self, paper_run):
        """What `tests/test_train_e2e.py` checks of the JAX trainer."""
        d = paper_run["dir"]
        for f in ("model.ckpt", "last.ckpt", "run.log", "metrics.jsonl",
                  "Target_test_conf_mat.csv"):
            assert (d / f).exists(), f
        log = (d / "run.log").read_text()
        assert "Best validation model confusion matrix:" in log
        assert "Test confusion matrix:" in log
        assert "target test accuracy:" in log
        lines = (d / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[-1])
        assert rec["epoch"] == 1 and {"train", "src_val", "trgt_val"} <= set(rec)
        assert isinstance(rec["src_val"]["acc"], float)
        assert set(rec["train"]) == {
            "src_mixup", "trgt_DefRec", "trgt_def_normal",
            "trgt_def_density_cls", "trgt_def_density_mse", "total"}
        assert all(np.isfinite(v) for v in rec["train"].values())
        model = make_model("dgcnn", 10, device="cpu")
        epoch, _ = checkpoint.load_train_state(str(d / "last.ckpt"), model)
        assert epoch == 1
        assert paper_run["results"]["test"]["acc"] >= 0.0

    def test_final_test_uses_the_best_epoch(self, paper_run):
        """The best epoch (0) is not the last (1): the returned model and
        the final test hold epoch 0's weights, not the live ones."""
        d, res = paper_run["dir"], paper_run["results"]
        assert res["best"]["epoch"] == 0, "pick a run whose best is not last"
        best = make_model("dgcnn", 10, device="cpu")
        assert checkpoint.load_train_state(str(d / "model.ckpt"), best)[0] == 0
        last = make_model("dgcnn", 10, device="cpu")
        checkpoint.load_train_state(str(d / "last.ckpt"), last)
        got = paper_run["model"].state_dict()
        for k, v in best.state_dict().items():
            assert torch.equal(got[k], v), k
        assert any(not torch.equal(got[k], v)
                   for k, v in last.state_dict().items())
        ds = load_pointda("scannet", ".", "test", N, True, 1, device="cpu")
        want = pointda_trainer.evaluate(best, ds.data, ds.label, B, 10)
        assert res["test"]["loss"] == want["loss"]
        np.testing.assert_array_equal(res["test"]["conf_mat"],
                                      want["conf_mat"])

    def test_scan_head_frozen(self, paper_run):
        """The paper recipe reads no scan output: its weights and BN
        statistics stay at init after both epochs, while the trained heads
        moved."""
        init = make_model("dgcnn", 10, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        last = make_model("dgcnn", 10, device="cpu")
        checkpoint.load_train_state(str(paper_run["dir"] / "last.ckpt"), last)
        a, b = init.state_dict(), last.state_dict()
        scan = [k for k in a if k.startswith("Rec_scan.")]
        assert scan and all(torch.equal(a[k], b[k]) for k in scan)
        for head in ("DefRec.", "Norm_pred.", "Density_cls.mlp"):
            assert any(not torch.equal(a[k], b[k]) for k in a
                       if k.startswith(head)), head

    def test_resume_repeats_the_run_bitwise(self, paper_run, tmp_path):
        """Resume from last.ckpt after epoch 0: weights, BN statistics,
        optimizer and scheduler at the end equal the uninterrupted run's."""
        cfg = _paper_cfg(tmp_path, "b")
        cfg = type(cfg)(**{**cfg.__dict__,
                           "resume": str(paper_run["dir"] / "last_e0.ckpt")})
        pointda_trainer.train_pointda(cfg)
        log = (tmp_path / "b" / "run.log").read_text()
        assert "last_e0.ckpt at epoch 0" in log
        assert len((tmp_path / "b" / "metrics.jsonl").read_text()
                   .splitlines()) == 1
        want = torch.load(paper_run["dir"] / "last.ckpt", weights_only=True)
        got = torch.load(tmp_path / "b" / "last.ckpt", weights_only=True)
        assert got["epoch"] == want["epoch"] == 1
        assert got["scheduler"] == want["scheduler"]
        for k, v in want["model"].items():
            assert torch.equal(got["model"][k], v), k
        assert got["optimizer"]["param_groups"] == \
            want["optimizer"]["param_groups"]
        for i, s in want["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)

    def test_nonfinite_loss_aborts(self, tmp_path):
        cfg = PointDAConfig(synthetic=True, epochs=1, num_points=32,
                            batch_size=32, test_batch_size=32, lr=float("inf"),
                            out_path=str(tmp_path), exp_name="nan",
                            device="cpu")
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            pointda_trainer.train_pointda(cfg)
        raw = torch.load(tmp_path / "nan" / "nonfinite_crash.ckpt",
                         weights_only=True)
        assert raw["epoch"] == 0 and "src_mixup" in raw["metrics"][
            "nonfinite_terms"]

    def test_wrong_num_class_names_the_keys(self, weights):
        model = make_model("dgcnn", 8, device="cpu")
        with pytest.raises(ValueError) as e:
            checkpoint.load_model_weights(model, str(weights["dir"] /
                                                     "port.ckpt"))
        assert "C.mlp3.weight: ckpt (10, 256) != model (8, 256)" in str(e.value)
        assert "C.mlp3.bias" in str(e.value)
        # the JAX .ckpt of the same weights now loads: the same report
        with pytest.raises(ValueError) as e:
            checkpoint.load_model_weights(model, str(weights["dir"] /
                                                     "jax.ckpt"))
        assert "jax.ckpt" in str(e.value)
        assert "C.mlp3.weight: ckpt (10, 256) != model (8, 256)" in str(e.value)

    def test_not_ported_raise(self, tmp_path, weights):
        """What raised NotImplementedError (ported since) runs or raises
        ValueError: `vit` trains (a narrow one, one epoch at N=32), is
        refused under `--task pointsegda`, and eval of a malformed `.ckpt`
        or, with `from_torch`, of a port checkpoint raises naming it; the
        scan head check as before."""
        base = dict(synthetic=True, device="cpu", out_path=str(tmp_path))
        narrow = functools.partial(models.PointViT, trans_dim=32,
                                   encoder_dims=32, depth=2, heads=2,
                                   num_group=8, group_size=8,
                                   fetch_idx=(0, 1))
        with mock.patch.dict(models._MODELS, vit=narrow):
            model, _ = pointda_trainer.train_pointda(PointDAConfig(
                model="vit", epochs=1, num_points=32, batch_size=32,
                test_batch_size=32, **base))
        assert model.NAME == "vit"
        bad = tmp_path / "bad.ckpt"
        bad.write_bytes(b"\x82\xa6params")
        for kw, match in (({"task": "pointsegda", "model": "vit"},
                           "does not serve"),
                          ({"model_file": str(bad)}, "bad.ckpt"),
                          ({"model_file": str(weights["dir"] / "port.ckpt"),
                            "from_torch": True},
                           "not found in the checkpoint")):
            with pytest.raises(ValueError, match=match):
                evaluation.run_eval(EvalConfig(**{**base, **kw}))
        with pytest.raises(ValueError, match="head"):
            pointda_trainer.train_pointda(PointDAConfig(
                Scan_on_trgt=True, model="pointnet", **base))


_CLI = """
import sys
from mlsp_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = {m.split('.')[0] for m in sys.modules}
assert not loaded & %r, loaded & %r
sys.exit(rc)
""" % (FORBIDDEN, FORBIDDEN)


class TestCli:
    def test_trainer_then_eval_and_infer(self, tmp_path):
        """The CLI on the CPU, in processes that import no JAX."""
        def run(*argv):
            return subprocess.run([sys.executable, "-c", _CLI, *argv],
                                  cwd=ROOT, capture_output=True, text=True,
                                  timeout=600, env={**os.environ,
                                                    "OMP_NUM_THREADS": "1"})

        common = ["--synthetic", "True", "--device", "cpu", "--num_points",
                  "32", "--test_batch_size", "32", "--out_path", str(tmp_path)]
        r = run("trainer", "--epochs", "2", "--batch_size", "32", *common)
        assert r.returncode == 0, r.stderr
        assert "target test accuracy" in r.stdout
        ckpt = str(tmp_path / "MLSP" / "model.ckpt")
        r = run("eval", "--model_file", ckpt, *common)
        assert r.returncode == 0, r.stderr
        ev = json.loads(r.stdout.strip().splitlines()[-1].split(": ", 1)[1])
        r = run("infer", "--model_file", ckpt, *common)
        assert r.returncode == 0, r.stderr
        inf = json.loads(r.stdout.strip().splitlines()[-1].split(": ", 1)[1])
        assert ev["acc"] == inf["acc"] and inf["n"] == 80
        assert np.load(inf["output"])["prob"].shape == (80, 10)

    def test_no_card_without_device_cpu(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert cli.main(["trainer", "--synthetic", "True"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert cli.main(["infer", "--model_file", "x.ckpt"]) == 1
