"""The port's native ingest (`mlsp_tpu_torch/native.py`, the data pipeline's
`standardize_files`), `data/meta.py` and `calibrate`, held against the JAX
package on the CPU.

Both packages bind the same C++ source (`native/mlsp_host.cpp`), so the
native routes must agree bit for bit, and so must the numpy routes; the
native and numpy routes agree within 2e-6 (`tests/test_native.py`'s
bound): the native unit cube sums in double, numpy in float32.
"""

import os

import numpy as np
import pytest

from mlsp_tpu import native as jnative
from mlsp_tpu.data import meta as jmeta
from mlsp_tpu.data import pipeline as jpipeline
from mlsp_tpu_torch import native
from mlsp_tpu_torch.cli import main as port_main
from mlsp_tpu_torch.data import meta, pipeline
from mlsp_tpu_torch.utils import chipcal

NUM_POINTS = 128


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    """24 seeded clouds of 40-1000 points (every bucket: tiled to 128, and
    256, 512, 1024 for FPS), float32 and float64, with 3 or 6 columns."""
    d = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(7)
    files = []
    for i, n in enumerate(rng.integers(40, 1000, 24)):
        cols = 6 if i % 3 == 0 else 3
        pc = rng.standard_normal((n, cols)) * rng.uniform(0.5, 3.0) + 1.5
        pc = pc.astype(np.float64 if i % 2 else np.float32)
        path = str(d / f"c{i:02d}.npy")
        np.save(path, pc)
        files.append(path)
    return files


@pytest.mark.parametrize("native_ingest", [True, False])
def test_standardize_files_equals_jax_bitwise(npy_files, native_ingest):
    """Each route against the JAX package's same route, with the
    alignment rotation on every other cloud (ShapeNet's mask)."""
    mask = np.arange(len(npy_files)) % 2 == 0
    kw = dict(rotate_axis="x", rotate_angle=-np.pi / 2, rotate_mask=mask,
              native_ingest=native_ingest)
    got = pipeline.standardize_files(npy_files, NUM_POINTS, device="cpu",
                                     **kw)
    want = jpipeline.standardize_files(npy_files, NUM_POINTS, **kw)
    assert got.shape == (len(npy_files), NUM_POINTS, 3)
    np.testing.assert_array_equal(got, want)


def test_native_and_numpy_routes_agree(npy_files, monkeypatch):
    """The native route (the default, and MLSP_NATIVE_INGEST=1) against
    the numpy one (MLSP_NATIVE_INGEST=0), within 2e-6."""
    monkeypatch.setenv("MLSP_NATIVE_INGEST", "0")
    plain = pipeline.standardize_files(npy_files, NUM_POINTS, device="cpu")
    monkeypatch.setenv("MLSP_NATIVE_INGEST", "1")
    fast = pipeline.standardize_files(npy_files, NUM_POINTS, device="cpu")
    np.testing.assert_allclose(fast, plain, rtol=0, atol=2e-6)


def test_built_into_the_port_build_directory():
    """The library lands in `mlsp_tpu_torch/_build/<hash>/`, never in the
    JAX package's `native/`."""
    native.load()
    so = native.library_path()
    assert so.exists()
    assert so.parent.parent.name == "_build"
    assert so.parent.parent.parent.name == "mlsp_tpu_torch"


def test_host_functions_match_jax_native(npy_files):
    """The bound helpers against the JAX package's bindings of the same
    library: unit cube, FPS, radius counts and normals, bit for bit."""
    pts = np.load(npy_files[1]).astype(np.float32)[:, :3]
    np.testing.assert_array_equal(native.scale_to_unit_cube(pts),
                                  jnative.scale_to_unit_cube(pts))
    np.testing.assert_array_equal(native.fps(pts, 32, 5),
                                  jnative.fps(pts, 32, 5))
    np.testing.assert_array_equal(native.radius_count(pts, 0.5, 50),
                                  jnative.radius_count(pts, 0.5, 50))
    np.testing.assert_array_equal(native.estimate_normals(pts, 10),
                                  jnative.estimate_normals(pts, 10))
    np.testing.assert_array_equal(native.npy_sizes(npy_files),
                                  jnative.npy_sizes(npy_files))


def test_bad_file_message_names_it(tmp_path):
    """A file the loader cannot parse raises ValueError naming it, with
    the JAX package's message."""
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((10, 2), np.float32))  # fewer than 3 columns
    for fn in (native.npy_sizes, jnative.npy_sizes):
        with pytest.raises(ValueError) as err:
            fn([bad])
        assert "bad.npy" in str(err.value)
    with pytest.raises(ValueError) as got:
        pipeline.standardize_files([bad], NUM_POINTS, device="cpu",
                                   native_ingest=True)
    with pytest.raises(ValueError) as want:
        jpipeline.standardize_files([bad], NUM_POINTS, native_ingest=True)
    assert str(got.value) == str(want.value)


def test_load_padded_npy_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    for cls, n in (("chair", 50), ("chair", 300), ("lamp", 90),
                   ("table", 200)):
        os.makedirs(tmp_path / cls, exist_ok=True)
        np.save(tmp_path / cls / f"{n}.npy",
                rng.standard_normal((n, 4)).astype(np.float32))
    got = meta.load_padded_npy(str(tmp_path), num_points=128)
    want = jmeta.load_padded_npy(str(tmp_path), num_points=128)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_array_equal(got.train_ind, want.train_ind)
    np.testing.assert_array_equal(got.val_ind, want.val_ind)
    with pytest.raises(FileNotFoundError, match="no npy files"):
        meta.load_padded_npy(str(tmp_path / "empty"))


def test_calibrate_returns_1_without_a_card(capsys):
    """No card, nothing measurable: JAX's "calibration unavailable" line and
    exit code 1, as `mlsp-tpu calibrate` off a TPU. The nearest-shape rule
    is JAX's."""
    assert port_main(["calibrate"]) == 1
    assert capsys.readouterr().out.startswith("calibration unavailable")
    from mlsp_tpu.utils import chipcal as jchipcal

    assert chipcal.SHAPES == jchipcal.SHAPES
    for n, c in ((1024, 64), (1024, 128), (2048, 64), (512, 256), (4096, 3)):
        assert chipcal.nearest_shape_key(n, c) == jchipcal.nearest_shape_key(
            n, c)


def test_calibrate_routes_on_the_cpu(monkeypatch):
    """`chipcal.edge_routes` at a small shape (B=2, N=32, C=4, k=20): the
    gather route's statistics and du against a float64 loop over each
    point's 20 nearest neighbours (du_j gets ds1_i + 2 u_j ds2_i from every
    point i that has j as a neighbour, and dmx_i / dmn_i where u_j is i's
    max / min; random values have no ties); within 1e-5. The K2 route
    insists on the kernel, so on CPU tensors it raises."""
    import torch

    monkeypatch.setitem(chipcal.SHAPES, "tiny", dict(B=2, N=32, C=4))
    xg, u, cot, routes = chipcal.edge_routes("tiny", "cpu")
    stats, du = routes["moments"]()
    x, uu, ct = (t.detach().double().numpy() for t in (xg, u, cot))
    want = np.zeros((4,) + uu.shape)
    want_du = np.zeros_like(uu)
    for b in range(2):
        d = ((x[b][:, None] - x[b][None]) ** 2).sum(-1)
        for i in range(32):
            nb = np.argsort(d[i], kind="stable")[:20]
            g = uu[b, nb]
            want[:, b, i] = g.max(0), g.min(0), g.sum(0), (g * g).sum(0)
            want_du[b, nb[g.argmax(0)], range(4)] += ct[0, b, i]
            want_du[b, nb[g.argmin(0)], range(4)] += ct[1, b, i]
            want_du[b, nb] += ct[2, b, i] + 2 * g * ct[3, b, i]
    for got, w in zip(stats, want):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(du.numpy(), want_du, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        routes["fused"]()
    assert torch.equal(routes["moments"]()[1], du)

