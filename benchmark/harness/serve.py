"""The serve driver: one client in a closed loop on a served bundle.

Set-up writes the configuration's model, with the seeded weights, as a
weights bundle (`save_serving_bundle`) under TMPDIR, loads it with
`ServingModel` and calls `predict` once at every batch size of the mix.
Requests are numpy batches of B clouds, consecutive rows of a pool made
at set-up; the mix's sizes come in blocks that each hold every size once,
in an order drawn from the seed, so every seed sends the same sizes. No
think time: the next request goes when the answer is back. Each request
is timed from the call of `predict` to the numpy logits it returns.

After the window the reference computes the logits of every pool cloud
once, and every answer of the window is held against the rows it
answers: the median answer's gap, each batch size's, and the 99th
percentile of all.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import data, weights
from benchmark.harness.core import Outcome
from benchmark.harness.train import make_model, port_config


def requests(traffic: dict, seed: int, count: int) -> tuple:
    """(sizes, first pool rows) of `count` requests."""
    rng = np.random.default_rng(data.derive_seed(seed, 5))
    lo, hi = traffic["batch_min"], traffic["batch_max"]
    block = np.arange(lo, hi + 1)
    nblocks = -(-count // len(block))
    sizes = np.concatenate([rng.permutation(block) for _ in range(nblocks)])
    sizes = sizes[:count]
    starts = rng.integers(0, traffic["pool"] - sizes + 1)
    return sizes, starts


def run(run) -> Outcome:
    from mlsp_tpu_torch.serving import ServingModel, save_serving_bundle

    cell, dev, seed = run.cell, run.device, run.seed
    t = cell.traffic
    cfg = port_config(cell, dev)
    h = cell.config["hyper"]
    w0 = weights.make(cell.ref.spec(cell.ref_cfg), data.derive_seed(seed, 3),
                      dev, cell.ref_cfg["pergroup"])
    pool, _ = data.classification(data.derive_seed(seed, 4), t["pool"],
                                  h["num_points"], cell.config["data"][
                                      "target_noise"], h["num_class"], dev)
    pool_np = pool.cpu().numpy()
    run.mark("data and weights")
    tmp = tempfile.mkdtemp(prefix="bench_bundle_")
    try:
        model = make_model(cell, cfg, dev, w0)
        save_serving_bundle(model, os.path.join(tmp, "bundle"),
                            h["num_points"], h["num_class"])
        del model
        served = ServingModel(os.path.join(tmp, "bundle"), dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if hasattr(served, "model") and hasattr(served.model, "edge_routes"):
        run.note("EdgeConv routes (edge_impl=%s): %s" % (
            served.model.edge_impl, ", ".join(served.model.edge_routes(
                h["num_points"], dev))))
    run.mark("bundle written and served, its routes")
    for b in range(t["batch_min"], t["batch_max"] + 1):
        served.predict(pool_np[:b])
    sizes, starts = requests(t, seed, t["max_requests"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    lat, answers, failed = [], [], 0
    setup_s = run.setup_done()
    with run.trace.window():
        t0 = time.perf_counter()
        for b, o in zip(sizes, starts):
            x = pool_np[o:o + b]
            with run.trace.span("predict"):
                a = time.perf_counter()
                try:
                    y = served.predict(x)
                except RuntimeError as e:  # a failed request misses
                    run.note(f"request failed: {e}")
                    y, failed = None, failed + 1
                lat.append(time.perf_counter() - a)
            answers.append((o, b, y))
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    reading = run.trace.read() if run.trace.on else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ms = np.asarray(lat) * 1e3
    if failed:  # a failed request counts as missing any latency limit
        ms[[i for i, (_, _, y) in enumerate(answers) if y is None]] = np.inf
    p50, p95 = float(np.percentile(ms, 50)), float(np.percentile(ms, 95))
    run.note(f"window: {len(lat)} requests, {int(sizes[:len(lat)].sum())} "
             f"clouds in {elapsed:.6f} s; latency p50 {p50!r} ms, p95 "
             f"{p95!r} ms; peak memory {peak} bytes")
    del served
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(cell, w0, pool, answers, run.note)
    return Outcome(metrics={"serve_p95_ms": float(p95), "setup_s": setup_s},
                   counts={"requests": len(lat),
                           "clouds": int(sizes[:len(lat)].sum())},
                   readings=readings, attempted=len(lat), failed=failed,
                   memory_peak_bytes=peak, reading=reading)


def check(cell, w0, pool, answers, note) -> dict:
    """Each answer's largest logit gap to the reference's, over the spread
    (standard deviation) of the reference's logits: their median, the
    largest over the batch sizes of each size's median, their 99th
    percentile over all answers and the largest. A missing or misshapen
    answer makes every reading infinite."""
    B = cell.config["hyper"]["test_batch_size"]
    ref = torch.cat([cell.ref.eval_logits(w0, pool[s:s + B], cell.ref_cfg)
                     for s in range(0, len(pool), B)]).cpu().numpy()
    scale = float(ref.std())
    gaps, by_size, missing = [], {}, 0
    for o, b, y in answers:
        if y is None or y.shape != (b, ref.shape[1]):
            missing += 1
            continue
        gaps.append(float(np.abs(y - ref[o:o + b]).max()) / scale)
        by_size.setdefault(int(b), []).append(gaps[-1])
    got = {"median_logit_gap": float(np.median(gaps)),
           "size_median_logit_gap": max(float(np.median(v))
                                        for v in by_size.values()),
           "p99_logit_gap": float(np.percentile(gaps, 99)),
           "logit_gap": max(gaps)} if gaps else {}
    note(f"reference logits' spread {scale!r}; {len(answers)} answers held, "
         f"{missing} missing or misshapen; answers' gaps over the spread: "
         f"{got}")
    if missing or not gaps:
        got = dict.fromkeys(("median_logit_gap", "size_median_logit_gap",
                             "p99_logit_gap", "logit_gap"), float("inf"))
    return got
