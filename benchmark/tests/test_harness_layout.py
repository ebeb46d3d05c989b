"""The manifest and its files: every cell's configuration, traffic mix,
limits, reference and per-layer readers are found by name; the manifest
keeps the contract's shapes; the measuring path refuses to run without a
card; nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the port."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = core.load_cell(name)
    assert (ROOT / "benchmark" / "harness" /
            f"{cell.traffic['kind']}.py").exists()
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(core.reader(m["name"]).read)
        assert m["moves"] in e2e
    assert callable(cell.ref.spec) and callable(cell.ref.eval_logits)


def test_manifest_shapes():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(MANIFEST) == keys
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"]]
             + [m["name"] for m in MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
        stated = json.loads((ROOT / c["file"]).read_text())
        keys = set(stated).union(*(v for v in stated.values()
                                   if isinstance(v, dict)))
        assert set(c["reduced"]) <= keys, c["reduced"]
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA device" in p.stderr


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only the manifest and the benchmark's own
    files the run fails: the program is what it measures."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and "{" not in p.stdout


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & set(core.FORBIDDEN)
        assert not found, f"{f} imports {found}"


def test_references_import_nothing_of_the_port():
    for f in sorted((ROOT / "benchmark" / "reference").rglob("*.py")):
        assert "mlsp_tpu_torch" not in _imports(f), f
        assert "mlsp_tpu_torch" not in f.read_text()


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.harness import core, train, serve, eval_split, "
            "faults, trace; import benchmark.control;"
            "[core.load_cell(w) for w in %r];"
            "import mlsp_tpu_torch.train.pointda_trainer, "
            "mlsp_tpu_torch.train.pointsegda_trainer, mlsp_tpu_torch.serving;"
            "print(core.forbidden_modules())" % (CELLS,))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mlsp_tpu_torch_fake", object())
    assert "mlsp_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mlsp_tpu", object())
    assert "mlsp_tpu" in core.forbidden_modules()
