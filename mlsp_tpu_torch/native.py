"""ctypes binding of the native host library (counterpart of
`mlsp_tpu/native.py`).

`native/mlsp_host.cpp` (the JAX package's source, read as it is) holds
C++ counterparts of the reference's host-side dependencies (FPS, radius
counts, normal estimation) and a threaded `.npy` ingest for the data
pipeline (`data.pipeline.standardize_files`). It is built at first use
with g++ into `mlsp_tpu_torch/_build/<hash of the source, the flags and
the host CPU's flags>/`, never into `native/`. Where the JAX package
falls back to numpy when g++ fails, this module raises with g++'s output:
only `native_ingest=False` (or MLSP_NATIVE_INGEST=0) takes the numpy
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mlsp_host.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")

_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source."""


def _host_flags() -> bytes:
    """The CPU's instruction-set flags: `-march=native` builds for them."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "").encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """`_build/<hash of the source, the flags and the host's CPU>/`."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_flags())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmlsp_host.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"g++ not runnable: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
    os.replace(tmp, so)  # atomic: another process never loads a half file


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises NativeBuildError)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        ccpp = ctypes.POINTER(ctypes.c_char_p)
        lib.mlsp_scale_to_unit_cube.argtypes = [f32p, ctypes.c_int64]
        lib.mlsp_scale_to_unit_cube.restype = None
        lib.mlsp_fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, i64p]
        lib.mlsp_fps.restype = None
        lib.mlsp_radius_count.argtypes = [f32p, ctypes.c_int64,
                                          ctypes.c_float, ctypes.c_int64, f32p]
        lib.mlsp_radius_count.restype = None
        lib.mlsp_estimate_normals.argtypes = [f32p, ctypes.c_int64,
                                              ctypes.c_int64, f32p]
        lib.mlsp_estimate_normals.restype = None
        lib.mlsp_npy_sizes.argtypes = [ccpp, ctypes.c_int64, ctypes.c_int32,
                                       i64p]
        lib.mlsp_npy_sizes.restype = ctypes.c_int64
        lib.mlsp_load_npy_clouds.argtypes = [
            ccpp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, f32p, i64p]
        lib.mlsp_load_npy_clouds.restype = ctypes.c_int64
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _points(pts: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected points [P, 3], got {pts.shape}")
    return pts


def scale_to_unit_cube(pts: np.ndarray) -> np.ndarray:
    out = _points(pts).copy()
    load().mlsp_scale_to_unit_cube(_fptr(out), out.shape[0])
    return out


def fps(pts: np.ndarray, npoint: int, start: int = 0) -> np.ndarray:
    pts = _points(pts)
    if not 0 <= start < pts.shape[0] or not 0 < npoint <= pts.shape[0]:
        raise ValueError(f"fps: start {start}, npoint {npoint} for "
                         f"{pts.shape[0]} points")
    out = np.zeros(npoint, np.int64)
    load().mlsp_fps(_fptr(pts), pts.shape[0], npoint, start, _iptr(out))
    return out


def radius_count(pts: np.ndarray, radius: float, cap: int = 100) -> np.ndarray:
    pts = _points(pts)
    out = np.zeros(pts.shape[0], np.float32)
    load().mlsp_radius_count(_fptr(pts), pts.shape[0], radius, cap, _fptr(out))
    return out


def estimate_normals(pts: np.ndarray, k: int = 20) -> np.ndarray:
    pts = _points(pts)
    if not 0 < k <= pts.shape[0]:
        raise ValueError(f"estimate_normals: k {k} for {pts.shape[0]} points")
    out = np.zeros_like(pts)
    load().mlsp_estimate_normals(_fptr(pts), pts.shape[0], k, _fptr(out))
    return out


# Threaded .npy ingest (the native data loader)

_ROT_AXIS = {None: -1, "x": 0, "y": 1, "z": 2}


def _path_array(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _raise_ingest(code: int, paths: list[str]) -> None:
    if code == 0:
        return
    # the loader's error code: -(parse_rc * 1e6 + file index)
    rc, i = -((-code) // 1000000), (-code) % 1000000
    raise ValueError(
        f"native npy ingest failed on {paths[i]!r} (code {rc}: "
        "expects little-endian f4/f8, C-order, 2-D [P, D>=3] .npy)")


def _threads(n_threads: int) -> int:
    return n_threads or min(16, os.cpu_count() or 1)


def npy_sizes(paths: list[str], n_threads: int = 0) -> np.ndarray:
    """Row counts of .npy files (parallel header-only reads)."""
    out = np.zeros(len(paths), np.int64)
    _raise_ingest(int(load().mlsp_npy_sizes(
        _path_array(paths), len(paths), _threads(n_threads), _iptr(out))),
        paths)
    return out


def load_npy_clouds(paths: list[str], pad_points: int, unit_cube: bool = True,
                    rotate_axis: str | None = None, rotate_angle: float = 0.0,
                    rotate_mask: np.ndarray | None = None, n_threads: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded ingest of .npy clouds of at most `pad_points` rows each:
    parse, decode xyz to float32, scale to the unit cube, rotate where
    `rotate_mask` says (all clouds if None) and repeat-pad to `pad_points`
    rows, the per-cloud steps of `data.pipeline.standardize_clouds`.
    Returns (clouds [n, pad_points, 3] float32, row counts [n] int64)."""
    lib = load()
    out = np.empty((len(paths), pad_points, 3), np.float32)
    npts = np.zeros(len(paths), np.int64)
    mask = None
    if rotate_mask is not None:
        keep = np.ascontiguousarray(rotate_mask, np.uint8)
        if keep.shape != (len(paths),):
            raise ValueError(f"rotate_mask {keep.shape} for {len(paths)} "
                             "files")
        mask = keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    _raise_ingest(int(lib.mlsp_load_npy_clouds(
        _path_array(paths), len(paths), pad_points, int(unit_cube),
        _ROT_AXIS[rotate_axis], float(rotate_angle), mask,
        _threads(n_threads), _fptr(out), _iptr(npts))), paths)
    return out, npts
