"""`chip_smoke.py`'s `points_mesh` phase alone, on one card.

Usage: python scripts/torch_points_phase.py

Builds the kernels, makes K1's inputs as `chip_smoke.py` does (a B=32
serving forward of a full-width DGCNN and a B=16 seg forward), writes a
seeded random DGCNN checkpoint for the SPST round, then runs
`chip_smoke.points_mesh`: K1's query ranges against the whole launch and
2 gloo ranks sharing the card as data 1 x points 2 (steps, a trainer
epoch, an SPST round, a PointNet++ forward), each check failing the run.
Prints the phase's JSON lines, its seconds and its launches by path
(~1.5 min of command on an H100).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

# the repository's chip_smoke.py, not the JAX package's scripts/chip_smoke.py
# beside this file; the spawned ranks inherit this path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from mlsp_tpu_torch.ops.kernels import _build  # noqa: E402
from mlsp_tpu_torch.train.state import make_optimizer  # noqa: E402
from mlsp_tpu_torch.utils import checkpoint  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_points_phase: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator().manual_seed(cs.SEED)
    model = cs.make_model("dgcnn", cs.NUM_CLASS, device=device, generator=g,
                          k=cs.K)
    cs.randomise_batch_norm(model, g)
    x = torch.from_numpy(cs.make_classification(
        cs.B, cs.N, cs.NUM_CLASS, seed=cs.SEED + 2)[0]).to(device)
    knn_in, _ = cs.kernel_inputs(model, x)
    seg = cs.seg_kernels(device, g)
    with tempfile.TemporaryDirectory() as tmp:
        model_file = os.path.join(tmp, "model.ckpt")
        opt, sched = make_optimizer(model, 1e-3, 0.0, 1, 1)
        checkpoint.save_train_state(model_file, model, opt, sched, 0, {})
        t0 = time.perf_counter()
        pm = cs.points_mesh(device, card, g, tmp, model_file, knn_in,
                            seg["knn_in"])
        print(f"points_mesh {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(pm["by_path"]), flush=True)


if __name__ == "__main__":
    main()
