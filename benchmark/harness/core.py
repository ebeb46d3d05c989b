"""One run of one cell: the manifest (`BENCHMARK.json`) read, the cell's
configuration, traffic mix, limits and per-layer readers found by name,
the card checked, the traffic's driver run, and the result printed.

Files, each found by a name in `BENCHMARK.json`:

    benchmark/configs/<config>.json      the configuration as it is run
    benchmark/reference/<config>.py      its plain reference
    benchmark/traffic/<traffic>.json     a traffic mix; its "kind" names
                                         the driver, benchmark/harness/
                                         <kind>.py
    benchmark/limits/<workload>.json     the limits `correct` is held to
    benchmark/metrics/<metric>.py        a per-layer metric's reader,
                                         `read(ctx) -> float | None`

The result is the last line of standard output, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key, "checks".
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# Top-level modules that no run may hold: the JAX package and its stack.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlsp_tpu")


class Refused(RuntimeError):
    """A run that cannot measure: no card, a bad cell, a forbidden
    module."""


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    ref: object = None

    @property
    def ref_cfg(self) -> dict:
        """The sizes and hyperparameters the reference reads."""
        return {**self.config["hyper"], **self.config["model"]}


@dataclass
class Outcome:
    """What a driver hands back."""
    metrics: dict                 # end-to-end metric name -> value
    counts: dict                  # steps, clouds, requests, calls
    readings: dict                # every number the comparison can hold
    attempted: int
    failed: int
    memory_peak_bytes: int
    reading: object = None        # trace.Reading of a traced window


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s manifest with its files, or Refused."""
    manifest_path = root / "BENCHMARK.json"
    if not manifest_path.exists():
        raise Refused(f"no manifest at {manifest_path}")
    manifest = _load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"unknown workload {name!r}; the manifest has "
                      f"{sorted(cells)}")
    w = cells[name]
    bench = root / "benchmark"
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, name, reported)]
    cell = Cell(name=name, chips=w["chips"], config_name=w["config"],
                traffic_name=w["traffic"],
                config=_load_json(bench / "configs" / f"{w['config']}.json"),
                traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(bench / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)
    cell.ref = load_module(bench / "reference" / f"{w['config']}.py",
                           f"benchmark.reference.{w['config']}")
    return cell


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.exists():
        raise Refused(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The per-layer metric's reader module."""
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       f"benchmark_metric_{metric.replace('.', '__')}")


def forbidden_modules() -> list[str]:
    """Top-level names in `sys.modules` that no run may hold, compared as
    whole names (`mlsp_tpu_torch` is not `mlsp_tpu`)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line(torch, chips: int) -> str:
    """The card's name, count, power limit and clocks."""
    line = (f"card: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()} (cell uses {chips})")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        line += f"; nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        line += f"; nvidia-smi unavailable ({e})"
    return line


@dataclass
class Run:
    """What a driver is given: the cell, the run's arguments, the device,
    the trace and the process start (for `setup_s`)."""
    cell: Cell
    seed: int
    seconds: float
    trace: object
    device: object
    t_start: float
    note: object
    marks: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, for the note of its times."""
        self.marks.append((phase, time.perf_counter()))

    def setup_done(self) -> float:
        self.mark("the rest of set-up")
        return self.marks[-1][1] - self.t_start


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, note=None) -> tuple[dict, list, dict]:
    """Run the cell's driver; returns (the result object without
    "checks", the checks, every reading). `correct` holds each number
    that `cell.limits` names to its limit. `device` is the card; tests
    pass the CPU to drive the rest of a run without one."""
    from benchmark.harness.trace import Trace

    def _note(line):
        print(line, file=sys.stderr, flush=True)

    driver = importlib.import_module(
        f"benchmark.harness.{cell.traffic['kind']}")
    run = Run(cell, seed, seconds, Trace(traced), device, t_start,
              note or _note)
    run.mark("start-up and imports")
    out: Outcome = driver.run(run)
    ends = [t_start] + [t for _, t in run.marks]
    run.note("set-up phases (s): " + "; ".join(
        f"{p} {t - t0:.3f}" for (p, t), t0 in zip(run.marks, ends)))
    unread = sorted(set(cell.limits) - set(out.readings))
    if unread:
        raise Refused(f"{cell.name}'s limits name {unread}; its driver "
                      f"reads {sorted(out.readings)}")
    checks = [(k, out.readings[k], lim) for k, lim in cell.limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    ok = ok and out.failed == 0 and bool(checks)
    result = {"correct": ok, "attempted": out.attempted,
              "failed": out.failed}
    if traced:
        reading = out.reading
        ctx = Context(cell=cell, reading=reading, counts=out.counts)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": out.metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    if traced:
        dev["busy_s"] = out.reading.busy_s
        dev["window_s"] = out.reading.window_s
        result["breakdown"] = out.reading.breakdown
    result["device"] = dev
    return result, checks, out.readings


@dataclass
class Context:
    """What a per-layer reader reads: the cell (its configuration and
    reference), the traced window's device operations and the counts of
    work the window completed."""
    cell: Cell
    reading: object
    counts: dict

    @property
    def cfg(self) -> dict:
        return self.cell.ref_cfg


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def fail(msg: str) -> int:
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)
        return 2

    try:
        cell = load_cell(args.workload)
    except Refused as e:
        return fail(str(e))
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    try:
        result, checks, _ = execute(cell, args.seed, args.seconds,
                                    bool(args.trace), torch.device("cuda", 0),
                                    t_start)
    except Refused as e:
        return fail(str(e))
    # after the run, so that the query's time stays out of set-up
    print(card_line(torch, cell.chips), file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        return fail(f"the run loaded {found}: the benchmark measures the "
                    "port alone")
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    print(json.dumps(result), flush=True)
    return 0
