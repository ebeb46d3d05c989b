"""Port serving bundles (`mlsp_tpu_torch.serving`) and the port's package
boundary: no JAX and nothing of `mlsp_tpu` behind `import mlsp_tpu_torch`."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlsp_tpu_torch import (
    ServingModel,
    load_serving_bundle,
    make_model,
    save_serving_bundle,
)
from mlsp_tpu_torch.data.synthetic import make_classification

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 64
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}


@pytest.fixture
def bundle(tmp_path):
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(7))
    meta = save_serving_bundle(model, str(tmp_path / "b"), num_points=N)
    return model, str(tmp_path / "b"), meta


class TestServingBundle:
    def test_roundtrip_matches_model(self, bundle):
        model, path, meta = bundle
        assert meta["format"] == "mlsp_tpu_torch/state_dict-v1"
        assert json.loads((pathlib.Path(path) / "meta.json").read_text()) == meta
        served = load_serving_bundle(path, device="cpu")
        for bs in (4, 7):  # one bundle, any batch size
            x, _ = make_classification(bs, N, seed=bs)
            got = served.predict(x)
            with torch.no_grad():
                want = model(torch.from_numpy(x))["cls"].numpy()
            assert got.shape == (bs, 10) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_wrong_shape_rejected(self, bundle):
        served = ServingModel(bundle[1], device="cpu")
        with pytest.raises(ValueError, match="expects"):
            served.predict(np.zeros((2, N + 1, 3), np.float32))
        with pytest.raises(ValueError, match="expects"):
            served.predict(np.zeros((N, 3), np.float32))

    def test_no_card_no_device_raises(self, bundle, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingModel(bundle[1])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model("dgcnn", 10)

    def test_other_families_not_ported(self):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_model("pointnet", 10, device="cpu")
        with pytest.raises(ValueError, match="unknown model"):
            make_model("resnet", 10, device="cpu")


class TestPackageBoundary:
    def test_import_leaves_jax_out(self):
        """Importing every module of the port loads nothing of JAX."""
        code = ("import importlib, json, pkgutil, sys, mlsp_tpu_torch\n"
                "names = [m.name for m in pkgutil.walk_packages("
                "mlsp_tpu_torch.__path__, 'mlsp_tpu_torch.')]\n"
                "for n in names: importlib.import_module(n)\n"
                "print(json.dumps([names, sorted({m.split('.')[0] "
                "for m in sys.modules})]))")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, check=True)
        names, loaded = json.loads(out.stdout)
        assert {"mlsp_tpu_torch.train.steps", "mlsp_tpu_torch.ops.fps",
                "mlsp_tpu_torch.ops.kernels.normals",
                "mlsp_tpu_torch.transforms.deform",
                "mlsp_tpu_torch.losses.losses",
                "mlsp_tpu_torch.utils.config"} <= set(names)
        assert "mlsp_tpu_torch" in loaded
        assert not set(loaded) & FORBIDDEN, set(loaded) & FORBIDDEN

    def test_sources_import_no_jax(self):
        files = sorted((ROOT / "mlsp_tpu_torch").rglob("*.py"))
        files += [ROOT / "chip_smoke.py"]
        files += sorted((ROOT / "scripts").glob("torch_*.py"))
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    assert name.split(".")[0] not in FORBIDDEN, (path, name)
