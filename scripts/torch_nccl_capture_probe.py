"""What a CUDA-graph capture of NCCL collectives meets on the card.

Usage: PYTHONPATH=. python scripts/torch_nccl_capture_probe.py

Each probe runs in its own process, on an NCCL world of one (the CLI's
`--mesh_data 1`), and prints one JSON line:

  version   torch's NCCL version (capture needs >= 2.9.6) and the card
  watchdog  does the process group's timeout bound a collective replayed
            inside a CUDA graph? An all-reduce queued behind a 10 s sleep
            on the card, with a 5 s process-group timeout: eagerly (the
            watchdog should end the process) and as one replay of a
            captured graph of (sleep, all-reduce)
  step      the paper-recipe step at B=32, N=1024 as a rank of the world:
            a chunk of 3 replays of its captured graph (global BatchNorm,
            the gradient and loss all-reduces inside) against 3 eager mesh
            steps from the same weights and generator seed at LR 0: the
            losses, and the launches counted through the replays
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SLEEP_S, TIMEOUT_S = 10, 5


def emit(probe: str, **fields) -> None:
    print(json.dumps({"probe": probe, **fields}), flush=True)


def _world():
    from mlsp_tpu_torch import parallel

    parallel.init_local_world("nccl", timeout_s=TIMEOUT_S)
    return parallel.make_mesh(1, device=torch.device("cuda", 0))


def probe_version() -> None:
    emit("version", nccl=".".join(map(str, torch.cuda.nccl.version())),
         torch=torch.__version__, card=torch.cuda.get_device_name(0))


def _sleep_cycles() -> int:
    """Clock cycles of SLEEP_S seconds of `torch.cuda._sleep`, measured."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(100_000_000)
    torch.cuda.synchronize()
    return int(100_000_000 * SLEEP_S / (time.perf_counter() - t0))


def probe_watchdog(mode: str) -> None:
    import torch.distributed as dist

    _world()
    t = torch.ones(1024, device="cuda")
    dist.all_reduce(t)  # the communicator, outside any capture
    torch.cuda.synchronize()
    cycles = _sleep_cycles()

    def body():
        torch.cuda._sleep(cycles)
        dist.all_reduce(t)

    t0 = time.perf_counter()
    if mode == "graph":
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            body()
        t0 = time.perf_counter()
        g.replay()
    else:
        body()
    torch.cuda.synchronize()
    time.sleep(2 * TIMEOUT_S)  # the watchdog's chance to act
    emit("watchdog", mode=mode, completed=True,
         seconds=time.perf_counter() - t0)
    dist.destroy_process_group()


def probe_step() -> None:
    import dataclasses

    from mlsp_tpu_torch import make_model
    from mlsp_tpu_torch.data.synthetic import make_classification
    from mlsp_tpu_torch.ops import kernels
    from mlsp_tpu_torch.train import make_optimizer, pointda_train_step
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.steps import pointda_train_scan
    from mlsp_tpu_torch.utils.config import PointDAConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _world()
    dev = mesh.device
    cfg = dataclasses.replace(PointDAConfig().paper_recipe, head_dtype="f32")
    x, y = make_classification(96, 1024, 10, seed=1)
    x = torch.from_numpy(x).to(dev).view(3, 32, 1024, 3)
    y = torch.from_numpy(y).to(dev).view(3, 32)
    out = {}
    for route in ("graph", "eager"):
        model = make_model("dgcnn", 10, device=dev,
                           generator=torch.Generator().manual_seed(0),
                           head_dtype="f32")
        opt, sched = make_optimizer(model, 0.0, cfg.wd, 2, 100, "SGD")
        gen = torch.Generator(device=dev).manual_seed(3)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if route == "graph":
            m = pointda_train_scan(model, opt, sched, x, y, x.flip(1), gen,
                                   cfg, Graphs(), mesh)
        else:
            steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                        x[i].flip(0), gen, cfg, mesh)
                     for i in range(3)]
            m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        torch.cuda.synchronize()
        out[route] = {"seconds_with_capture": time.perf_counter() - t0,
                      "total": m["total"].tolist(),
                      "launches": kernels.launches(),
                      "in_graphs": kernels.launches_in_graphs()}
    gap = max(abs(a / b - 1.0) for a, b in zip(out["graph"]["total"],
                                              out["eager"]["total"]))
    emit("step", **out, max_total_rel_gap=gap)


def main() -> int:
    if len(sys.argv) > 1:
        name, *rest = sys.argv[1:]
        {"version": probe_version, "step": probe_step,
         "watchdog": lambda: probe_watchdog(rest[0])}[name]()
        return 0
    rc = 0
    for args in (["version"], ["watchdog", "eager"], ["watchdog", "graph"],
                 ["step"]):
        done = subprocess.run([sys.executable, __file__, *args],
                              capture_output=True, text=True, timeout=300)
        sys.stdout.write(done.stdout)
        if done.returncode:
            emit(args[0], args=args, rc=done.returncode,
                 stderr=done.stderr[-3000:])
            rc = rc or int(args != ["watchdog", "eager"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
