"""Where the port's serving time goes: a torch.profiler trace of the DGCNN
serving forward (`mlsp_tpu_torch`) on one NVIDIA card.

Usage: PYTHONPATH=. python scripts/torch_serving_profile.py

Builds the same full-width model as `chip_smoke.py` (DGCNN k=20, N=1024,
10 classes, seeded random weights), serves 20 requests of 32 clouds through
`ServingModel.predict` under the profiler after 5 warm-up requests, and
prints one JSON line: wall time per request, the device's busy share of
that window, and device time per request grouped by kernel name (largest
first), with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mlsp_tpu_torch import ServingModel, make_model, save_serving_bundle
from mlsp_tpu_torch.data.synthetic import make_classification

BATCH, ITERS = 32, 20


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()

    model = make_model("dgcnn", 10, generator=torch.Generator().manual_seed(0))
    x = make_classification(BATCH, 1024, 10, seed=1)[0]
    with tempfile.TemporaryDirectory() as path:
        save_serving_bundle(model, path, num_points=1024, num_class=10)
        served = ServingModel(path)
    for _ in range(5):
        served.predict(x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            served.predict(x)  # ends in a host copy of the logits
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched.
    by_name = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0}
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "batch": BATCH, "iters": ITERS, "card": card,
        "wall_ms_per_request": wall_ms / ITERS,
        "device_ms_per_request": busy_ms / ITERS,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_request_by_kernel": [
            [name[:90], us / 1e3 / ITERS] for name, us in top[:25]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
