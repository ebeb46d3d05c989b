"""Where the port's train time goes: a torch.profiler trace of a train step
(`mlsp_tpu_torch`) on one NVIDIA card.

Usage: PYTHONPATH=. python scripts/torch_train_profile.py
           [--seg | --all_branches] [--mesh_data 1]

Builds the full-width model `chip_smoke.py` trains, with seeded random
weights: without `--seg` the PointDA paper-recipe step (DGCNN k=20, N=1024,
B=32, 10 classes, `PointDAConfig().paper_recipe`, `pointda_train_step`);
with `--seg` the PointSegDA step (DGCNNSeg k=20, N=2048, B=16, 8 classes,
the MLSP recipe of configs/pointsegda_mlsp.yaml plus PCM,
`pointsegda_train_step`); with `--all_branches` the PointDA step with every
recipe flag on, as `chip_smoke.py`'s `branches` phase takes it (9 forwards,
3 normal estimates, SPL_v2 keeping every cloud). Takes 3 warm-up steps, then 5 steps under the
profiler, and prints one JSON line: wall time per step, the device's busy
share of that window, device time per step grouped by kernel name (largest
first), the hand-written kernels' share, and the card's name and power
limit.

With `--mesh_data 1` the step runs as the one rank of an NCCL world of one
(`parallel.init_local_world`, the step's `mesh=`), as `trainer
--mesh_data 1` runs it, and the same step without a mesh is profiled in
the same process for comparison: the line gains, for both, the wall time
per step (interleaved, outside the profiler) and host time per step
grouped by operator (self CPU time, largest first), and the number of
collectives a step calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mlsp_tpu_torch import make_model, parallel
from mlsp_tpu_torch.data.synthetic import (
    make_classification,
    make_segmentation,
)
from mlsp_tpu_torch.train import (
    make_optimizer,
    pointda_train_step,
    pointsegda_train_step,
)
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    load_yaml,
)

WARMUP, ITERS = 3, 5
# device kernels of csrc/*.cu, by the name the profiler reports
PORT_KERNELS = ("knn_kernel", "edge_moments_kernel", "edge_moments_bwd_kernel",
                "knn_moments_kernel", "fps_kernel")
# chip_smoke.py's all-branch recipe (its gate above log 10 keeps every cloud)
ALL_BRANCHES = dict(
    DefRec_on_src=True, apply_PCM=True, Density_normal_viainput_onsrc=True,
    DefRec_on_trgt=True, Norm_on_trgt=True, Scan_on_trgt=True,
    Density_on_trgt=True, Density_normal_viainput=True, Normal_ondef=True,
    Density_ondef=True, apply_SPL_v2=True, gamma_v2=2.31)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()

    seg = "--seg" in sys.argv[1:]
    device = torch.device("cuda", 0)
    if seg:
        cfg = dataclasses.replace(
            load_yaml(PointSegDAConfig, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                "pointsegda_mlsp.yaml")), apply_PCM=True).resolved()
        name, make, step = "dgcnn_seg", make_segmentation, pointsegda_train_step
        kw = {"density_num_cls": cfg.density_num_class,
              "pergroup": cfg.pergroup}
    else:
        cfg = PointDAConfig().paper_recipe
        if "--all_branches" in sys.argv[1:]:
            cfg = dataclasses.replace(cfg, **ALL_BRANCHES)
        name, make, step = "dgcnn", make_classification, pointda_train_step
        kw = {"head_dtype": cfg.head_dtype}
    model = make_model(name, cfg.num_class, device=device,
                       generator=torch.Generator().manual_seed(0),
                       dropout=cfg.dropout, **kw).train()
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 100)
    clouds, labels = make(2 * cfg.batch_size, cfg.num_points, cfg.num_class,
                          seed=1)
    x = torch.from_numpy(clouds).to(device)
    y = torch.from_numpy(labels).to(device)
    batch = (x[:cfg.batch_size], y[:cfg.batch_size], x[cfg.batch_size:])
    gen = torch.Generator(device=device).manual_seed(0)
    mesh = None
    if "--mesh_data" in sys.argv[1:]:
        if sys.argv[sys.argv.index("--mesh_data") + 1] != "1":
            print("torch_train_profile: only --mesh_data 1 runs on one card",
                  file=sys.stderr)
            return 1
        parallel.init_local_world("nccl")
        mesh = parallel.make_mesh(1, device=device)
    for _ in range(WARMUP):
        step(model, opt, sched, *batch, gen, cfg)
        if mesh is not None:
            step(model, opt, sched, *batch, gen, cfg, mesh)
    torch.cuda.synchronize()

    def run(m):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(model, opt, sched, *batch, gen, cfg, m)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    extra = {}
    if mesh is not None:
        walls = {"no_mesh": [], "mesh": []}
        for _ in range(3):
            for label, m in (("no_mesh", None), ("mesh", mesh)):
                walls[label].append(run(m) / ITERS)
        extra["wall_ms_per_step_interleaved"] = walls
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as host:
            run(None)
        extra["no_mesh_host_ms_per_step_by_op"] = host_ops(host)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run(mesh)
    if mesh is not None:
        extra["mesh_host_ms_per_step_by_op"] = host_ops(prof)
        extra["collectives_per_step"] = sum(
            ev.count for ev in prof.key_averages()
            if ev.key.startswith("c10d::")) / ITERS
        torch.distributed.destroy_process_group()

    # Device-side kernels only: a CPU op's self device time repeats the
    # time of the kernels it launched, and a range such as the optimizer's
    # `Optimizer.step#Adam.step` spans its kernels and the gaps between them.
    by_name = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False)}
    busy_ms = sum(by_name.values()) / 1e3
    port = {k: sum(us for name, us in by_name.items() if k in name) / 1e3 / ITERS
            for k in PORT_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "model": name, "batch": cfg.batch_size, "points": cfg.num_points,
        "iters": ITERS, "all_branches": "--all_branches" in sys.argv[1:],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card, "wall_ms_per_step": wall_ms / ITERS,
        "device_ms_per_step": busy_ms / ITERS,
        "device_busy_share": busy_ms / wall_ms,
        "port_kernels_ms_per_step": port,
        "device_ms_per_step_by_kernel": [
            [name[:90], us / 1e3 / ITERS] for name, us in top[:30]],
        "mesh_data": 1 if mesh is not None else None, **extra,
    }))
    return 0


def host_ops(prof) -> list:
    """Host time per step by operator (self CPU time), the 20 largest."""
    ops = sorted(((ev.key, ev.self_cpu_time_total / 1e3 / ITERS, ev.count / ITERS)
                  for ev in prof.key_averages()), key=lambda t: -t[1])
    return [[name[:60], ms, calls] for name, ms, calls in ops[:20]]


if __name__ == "__main__":
    sys.exit(main())
