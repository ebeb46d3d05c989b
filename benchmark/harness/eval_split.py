"""The eval driver: `evaluate_seg` over a split held on the card, again and
again, as every seg epoch's validation and `eval --task pointsegda` run
it.

Set-up makes the split and the seeded weights (BatchNorm's running
statistics away from their initial values, so that eval-mode BatchNorm
does real work), loads them into the port's model and calls
`evaluate_seg` once, which captures the eval forward's graph. The
window calls it until `--seconds` have passed; every call must return
what the first returned. After the window the reference computes the
split's logits and the same loss, mIoU and accuracy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import data, weights
from benchmark.harness.core import Outcome
from benchmark.harness.train import make_model, port_config


def seg_metrics(logits: np.ndarray, labels: np.ndarray) -> tuple:
    """(mean per-point cross-entropy, mean per-cloud mIoU, mean per-cloud
    accuracy): the mIoU of a cloud is the mean IoU over the labels in its
    truth or its prediction."""
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    loss = -np.take_along_axis(logp, labels[..., None], -1).mean()
    pred = logits.argmax(-1)
    mious, accs = [], []
    for y, p in zip(labels, pred):
        ious = [((y == c) & (p == c)).sum() / ((y == c) | (p == c)).sum()
                for c in np.union1d(y, p)]
        mious.append(np.mean(ious))
        accs.append((y == p).mean())
    return float(loss), float(np.mean(mious)), float(np.mean(accs))


def run(run) -> Outcome:
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg

    cell, dev, seed = run.cell, run.device, run.seed
    cfg = port_config(cell, dev)
    h = cell.config["hyper"]
    m = cell.traffic["clouds"]
    x, y = data.segmentation(data.derive_seed(seed, 4), m, h["num_points"],
                             h["num_class"], dev)
    labels = y.cpu().numpy()
    w0 = weights.make(cell.ref.spec(cell.ref_cfg), data.derive_seed(seed, 3),
                      dev, cell.ref_cfg["pergroup"])
    run.mark("data and weights")
    model = make_model(cell, cfg, dev, w0)
    run.mark("model")
    graphs = Graphs() if dev.type == "cuda" else None
    first = evaluate_seg(model, x, labels, cfg.test_batch_size, None, graphs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    calls, differ = 0, 0
    setup_s = run.setup_done()
    with run.trace.window():
        t0 = time.perf_counter()
        while True:
            with run.trace.span("evaluate_seg"):
                got = evaluate_seg(model, x, labels, cfg.test_batch_size,
                                   None, graphs)
            calls += 1
            differ += got != first
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    reading = run.trace.read() if run.trace.on else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.note(f"window: {calls} calls of {m} clouds in {elapsed:.6f} s; "
             f"(loss, mIoU, acc) {first}; {differ} calls differed from the "
             f"first; peak memory {peak} bytes")
    del model, graphs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(cell, w0, x, labels, first, run.note)
    return Outcome(metrics={"eval_clouds_per_s": calls * m / elapsed,
                            "setup_s": setup_s},
                   counts={"calls": calls, "clouds": calls * m},
                   readings=readings, attempted=calls, failed=differ,
                   memory_peak_bytes=peak, reading=reading)


def check(cell, w0, x, labels, got, note) -> dict:
    """The loss (relative), mIoU and accuracy (absolute) against the
    reference's over the same split."""
    B = cell.config["hyper"]["test_batch_size"]
    logits = np.concatenate([
        cell.ref.eval_logits(w0, x[s:s + B], cell.ref_cfg).cpu().numpy()
        for s in range(0, len(x), B)])
    ref = seg_metrics(logits, labels)
    note(f"reference (loss, mIoU, acc) {ref}")
    return {"loss_gap": abs(got[0] - ref[0]) / abs(ref[0]),
            "miou_gap": abs(got[1] - ref[1]), "acc_gap": abs(got[2] - ref[2])}
