#!/usr/bin/env python3
"""Readings that set the limits of `correct`, on the card, at a cell's own
size, each a whole run of the cell (`core.execute`: its driver, its
window, its comparison, its committed limits) with the timed path as it
is or replaced:

    program    the port, as the benchmark runs it (the lower readings)
    control    the reference in the program's place, its float32 matmuls
               in TF32 (the configurations state float32 with TF32 off):
               the upper readings; it has to come out not correct
    fault:<f>  a planted fault of `harness/faults.py` (unchanged, half,
               altered)

    python3 benchmark/control.py --workload <cell> --mode control \
        --seeds 1 2 3 [--seconds 3]

One JSON line a seed: {"seed", "mode", "correct", "readings", "seconds"},
`correct` as the run decides it at the committed limits and `readings`
every number the comparison can hold. The benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core, data, faults, weights  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _train_in_place(cell, low: bool):
    """The trainer's step scan replaced: each step the reference's loss on
    the model's own tensors and the step's generator, its backward, then
    the program's optimizer and schedule."""
    from mlsp_tpu_torch.train import seg_steps, steps
    from mlsp_tpu_torch.train.graphs import stack_steps

    seg = cell.config["task"] == "pointsegda"

    def scan(model, opt, sched, src_xs, src_ys, trgt_xs, generator, cfg,
             graphs=None, mesh=None):
        outs = []
        for sx, sy, tx in zip(src_xs, src_ys, trgt_xs):
            W = dict(model.state_dict(keep_vars=True))
            opt.zero_grad(set_to_none=True)
            with tf32(low):
                loss = cell.ref.train_loss(W, sx, sy, tx, generator,
                                           cell.ref_cfg)
                loss.backward()
            opt.step()
            sched.step()
            m = {"total": loss.detach()}
            outs.append((m, (sy, sy)) if seg else m)
        return stack_steps(outs)

    stack = contextlib.ExitStack()
    for mod, name in ((steps, "pointda_train_scan"),
                      (seg_steps, "pointsegda_train_scan")):
        stack.enter_context(faults.patched(mod, name, lambda orig: scan))
    return stack


def _serve_in_place(cell, w0, low: bool):
    """`ServingModel.predict` replaced by the reference's logits."""
    from mlsp_tpu_torch import serving

    dev = next(iter(w0.values())).device

    def predict(self, x):
        with tf32(low):
            y = cell.ref.eval_logits(w0, torch.as_tensor(np.asarray(x),
                                                         device=dev),
                                     cell.ref_cfg)
        return y.float().cpu().numpy()

    return faults.patched(serving.ServingModel, "predict",
                          lambda orig: predict)


def _eval_in_place(cell, w0, low: bool):
    """The seg eval's forwards (`eval_logits`) replaced by the
    reference's, batch by batch."""
    from mlsp_tpu_torch.train import pointsegda_trainer as T

    def logits(model, x, sels, output="seg", mesh=None, graphs=None):
        with tf32(low):
            return np.stack([
                cell.ref.eval_logits(
                    w0, x[torch.as_tensor(s, device=x.device)],
                    cell.ref_cfg).float().cpu().numpy() for s in sels])

    return faults.patched(T, "eval_logits", lambda orig: logits)


def in_programs_place(cell, seed: int, device, low: bool = True):
    """A context that puts the reference in the program's place for a run
    of `cell` with `seed`: on the seed's weights, its float32 matmuls in
    TF32 where `low` (on the card; the CPU has no TF32, so there it is the
    reference itself, which has to come out correct)."""
    kind = cell.traffic["kind"]
    if kind == "train":
        return _train_in_place(cell, low)
    cfg = cell.ref_cfg
    w0 = weights.make(cell.ref.spec(cfg), data.derive_seed(seed, 3), device,
                      cfg["pergroup"])
    return {"serve": _serve_in_place,
            "eval_split": _eval_in_place}[kind](cell, w0, low)


def run_mode(cell, mode: str, seed: int, seconds: float, device,
             note=None) -> tuple[dict, dict]:
    """One run of `cell` in `mode`; returns (the result, every reading)."""
    if mode == "program":
        plant = contextlib.nullcontext()
    elif mode == "control":
        plant = in_programs_place(cell, seed, device)
    elif mode.startswith("fault:"):
        plant = faults.plant(cell.traffic["kind"], mode[6:])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    with plant:
        result, _, readings = core.execute(
            cell, seed, seconds, False, device, time.perf_counter(),
            note=note or (lambda s: print(s, file=sys.stderr, flush=True)))
    return result, readings


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        cell = core.load_cell(args.workload)
        t0 = time.perf_counter()
        result, readings = run_mode(cell, args.mode, seed, args.seconds,
                                    device)
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "correct": result["correct"], "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
