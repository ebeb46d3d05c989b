"""Where the port's train time goes: a torch.profiler trace of the PointDA
paper-recipe train step (`mlsp_tpu_torch`) on one NVIDIA card.

Usage: PYTHONPATH=. python scripts/torch_train_profile.py

Builds the full-width model `chip_smoke.py` trains (DGCNN k=20, N=1024,
B=32, 10 classes, `PointDAConfig().paper_recipe`, seeded random weights),
takes 3 warm-up steps, then 5 steps of `pointda_train_step` under the
profiler, and prints one JSON line: wall time per step, the device's busy
share of that window, device time per step grouped by kernel name (largest
first), the hand-written kernels' share, and the card's name and power
limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.train import make_optimizer, pointda_train_step
from mlsp_tpu_torch.utils.config import PointDAConfig

WARMUP, ITERS = 3, 5
# device kernels of csrc/*.cu, by the name the profiler reports
PORT_KERNELS = ("knn_kernel", "edge_moments_kernel", "edge_moments_bwd_kernel",
                "knn_moments_kernel", "fps_kernel")


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

    cfg = PointDAConfig().paper_recipe
    device = torch.device("cuda", 0)
    model = make_model("dgcnn", cfg.num_class, device=device,
                       generator=torch.Generator().manual_seed(0),
                       dropout=cfg.dropout, head_dtype=cfg.head_dtype).train()
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 100)
    clouds, labels = make_classification(2 * cfg.batch_size, cfg.num_points,
                                         cfg.num_class, seed=1)
    x = torch.from_numpy(clouds).to(device)
    y = torch.from_numpy(labels).to(device)
    batch = (x[:cfg.batch_size], y[:cfg.batch_size], x[cfg.batch_size:])
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(WARMUP):
        pointda_train_step(model, opt, sched, *batch, gen, cfg)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            pointda_train_step(model, opt, sched, *batch, gen, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

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
        "batch": cfg.batch_size, "points": cfg.num_points, "iters": ITERS,
        "card": card, "wall_ms_per_step": wall_ms / ITERS,
        "device_ms_per_step": busy_ms / ITERS,
        "device_busy_share": busy_ms / wall_ms,
        "port_kernels_ms_per_step": port,
        "device_ms_per_step_by_kernel": [
            [name[:90], us / 1e3 / ITERS] for name, us in top[:30]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
