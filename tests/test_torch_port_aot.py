"""The port's segmentation and AOT serving bundles (`mlsp_tpu_torch.serving`,
`train/evaluation.py::run_aot_export`, the `aot` CLI) held against the
JAX package's StableHLO bundles (`mlsp_tpu.serving`) on the CPU.

Weights go across with `utils/jax_weights` (or through a JAX `.ckpt`),
each side builds its own kNN graphs (the JAX bundle its XLA kNN, the port
its plain one). Logits agree within rtol = atol = 1e-4, the port-vs-JAX
bound of the interop tests.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_interop import MODELS, canonical, port_model, variables

from mlsp_tpu import serving as jserving
from mlsp_tpu.cli import main as jax_main
from mlsp_tpu.train.state import create_train_state
from mlsp_tpu.utils import checkpoint as jcheckpoint
from mlsp_tpu_torch import (
    ServingModel,
    make_model,
    save_aot_bundle,
    save_serving_bundle,
)
from mlsp_tpu_torch.cli import main as port_main
from mlsp_tpu_torch.utils import jax_weights as jw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 3, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(name: str, v: dict):
    m, _, heads, _ = MODELS[name]
    state = create_train_state(m, jax.random.key(0), jnp.zeros((1, N, 3)),
                               heads=heads)
    return state.replace(params=v["params"], batch_stats=v["batch_stats"]), m


def _clouds(seed: int, b: int = B) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, N, 3)) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("name", ["dgcnn_seg", "hengshuang_seg"])
def test_seg_bundles_match_the_jax_seg_bundle(name, tmp_path):
    """The port's weights bundle and AOT bundle of a segmenter (N = 64, 8
    classes) on the weights of a JAX model serve the per-point logits
    [B, N, 8] of the JAX package's `task="pointsegda"` bundle of the same
    variables, for two batch sizes; both record task "pointsegda"."""
    v = variables(name, 21)
    state, m = _jax_state(name, v)
    jserving.save_serving_bundle(state, m, str(tmp_path / "jax"),
                                 task="pointsegda", num_points=N,
                                 num_class=8, platforms=("cpu",))
    jbundle = jserving.load_serving_bundle(str(tmp_path / "jax"))
    model = port_model(name, knn_backend="torch")
    model.load_state_dict(jw.state_dict_from_jax(
        canonical(name), v, model.config.get("pergroup")))
    metas = [save_serving_bundle(model, str(tmp_path / "w"), N, 8),
             save_aot_bundle(model, str(tmp_path / "aot"), N, 8)]
    assert [mt["task"] for mt in metas] == ["pointsegda"] * 2
    assert metas[1]["format"] == "torch.export/pt2-v1"
    served = [ServingModel(str(tmp_path / d), device="cpu")
              for d in ("w", "aot")]
    for b in (B, 2):
        x = _clouds(b, b)
        want = jbundle.predict(x)
        assert want.shape == (b, N, 8)
        for s in served:
            np.testing.assert_allclose(s.predict(x), want, rtol=1e-4,
                                       atol=1e-4)


def _write_jax_ckpt(tmp_path) -> str:
    state, _ = _jax_state("dgcnn", variables("dgcnn", 22))
    path = str(tmp_path / "m.ckpt")
    jcheckpoint.save_train_state(path, state)
    return path


def test_aot_cli_on_a_jax_ckpt_matches_the_jax_aot(tmp_path):
    """`aot` of a JAX `.ckpt` (a full-width DGCNN at N = 64) by both
    packages' CLIs: the port writes a `.pt2` bundle whose self-check
    passes, with the JAX bundle's metadata keys; both bundles give the
    same class logits within 1e-4 on batches of two sizes; a cloud of
    another point count is refused by both."""
    ckpt = _write_jax_ckpt(tmp_path)
    common = ["--model_file", ckpt, "--num_points", str(N),
              "--test_batch_size", str(B), "--out_path", str(tmp_path)]
    assert jax_main(["aot", *common, "--exp_name", "jax",
                     "--output", str(tmp_path / "jax")]) == 0
    assert port_main(["aot", *common, "--device", "cpu", "--exp_name",
                      "port", "--output", str(tmp_path / "port")]) == 0
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jmeta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert meta["format"] == "torch.export/pt2-v1"
    assert {k: meta[k] for k in ("task", "batch_size", "num_points",
                                 "num_class")} == {
        k: jmeta[k] for k in ("task", "batch_size", "num_points",
                              "num_class")}
    log = (tmp_path / "port" / "run.log").read_text().splitlines()
    summary = json.loads(log[-1].split(": ", 1)[1])
    assert summary["selfcheck_max_diff"] <= 1e-5
    jbundle = jserving.load_serving_bundle(str(tmp_path / "jax"))
    port = ServingModel(str(tmp_path / "port"), device="cpu")
    for b in (B, 5):
        x = _clouds(10 + b, b)
        got, want = port.predict(x), jbundle.predict(x)
        assert got.shape == want.shape == (b, 10)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for bundle in (jbundle, port):
        with pytest.raises(ValueError, match="expects"):
            bundle.predict(np.zeros((B, N + 1, 3), np.float32))


def test_pt2_serves_in_a_process_without_model_code(tmp_path):
    """A `.pt2` bundle loads and serves through `ServingModel` in a fresh
    process that imports no model, op or kernel module of the port, and
    through `torch.export.load` alone; both equal the live model."""
    model = make_model("dgcnn_seg", 8, device="cpu", knn_backend="torch",
                       generator=torch.Generator().manual_seed(4))
    save_aot_bundle(model, str(tmp_path / "b"), N, 8)
    x = _clouds(7)
    with torch.no_grad():
        want = model(torch.from_numpy(x), ("seg",))["seg"].numpy()
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "want.npy", want)
    code = f"""
import sys, numpy as np, torch
from mlsp_tpu_torch.serving import ServingModel
d = {str(tmp_path)!r}
x, want = np.load(d + "/x.npy"), np.load(d + "/want.npy")
got = ServingModel(d + "/b", device="cpu").predict(x)
ep = torch.export.load(d + "/b/eval_fn.pt2")
alone = ep.module()(torch.from_numpy(x)).detach().numpy()
loaded = [m for m in sys.modules if m.startswith(
    ("mlsp_tpu_torch.models", "mlsp_tpu_torch.ops", "mlsp_tpu."))]
assert not loaded, loaded
np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
np.testing.assert_allclose(alone, want, rtol=1e-6, atol=1e-6)
print("ok", got.shape)
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "ok (3, 64, 8)" in done.stdout
