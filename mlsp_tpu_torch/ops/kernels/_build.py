"""Builds the CUDA sources in `mlsp_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with
a plain C interface, `_build/<hash>/lib<name>.so` inside the package, and
loaded with `ctypes`; the wrappers pass `data_ptr()`s and the current CUDA
stream. The directory name is a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. All sources are
compiled together, one `nvcc` process each. A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
SOURCES = ("knn", "edge_moments")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise BuildError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing; return nvcc's output
    (register and spill counts from ptxas) by source name."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return {}
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = out / f"lib{name}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        logs, failed = {}, []
        for name, (proc, tmp) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu (exit {proc.returncode}):\n"
                              f"{logs[name]}")
            else:
                # rename is atomic: another process never loads a half file
                os.replace(tmp, out / f"lib{name}.so")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise BuildError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.

    Every library exports `mlsp_<name>_error_string(int)`, declared here;
    the wrappers declare their launchers.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = build_dir() / f"lib{name}.so"
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            err = getattr(lib, f"mlsp_{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if the launcher of `csrc/<name>.cu` returned a CUDA error."""
    if status != 0:
        msg = getattr(_libs[name], f"mlsp_{name}_error_string")(status)
        raise RuntimeError(f"mlsp_{name}: CUDA error {status}: {msg.decode()}")
