"""The train driver: the trainer's own loop body, epoch after epoch.

Set-up builds one training object (the port's model with the seeded
weights, its optimizer and schedule, one `Graphs` for the run, the
step's generator) and drives it through its first steps with the
trainer's `train_epoch` over the trainer's step scan: step 1, steps 2-3
(as one chunk where one epoch holds them; an epoch of one step takes
them one an epoch), then the rest of the chunk step 3 is in (on the
card every chunk a replay of the one captured step graph). It keeps the
weights before step 1, the first gradient as Adam took it (its first
moment after step 1) and the weights after step 3. The window then goes
on from there, chunk after chunk of `scan_steps` steps as `train_epoch`
takes them, each epoch's batch order from `epoch_pairs`, its draws
seeded by `seed_epoch`, its losses fetched at its end by
`fetch_metrics` (and the seg step's predictions by `_fetch_preds`),
until a chunk ends past `--seconds`. Validation and checkpoints are not
in the window.

After the window the reference follows steps 1-3 from the same weights,
batches and generator seed, and `compare` holds the program to it.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.harness import compare, data, weights
from benchmark.harness.core import Outcome, Refused

STEPS_CHECKED = 3


class _Split:
    """What `epoch_pairs` reads of a dataset: its size and train rows."""

    def __init__(self, m: int, train_ind):
        self.m, self.train_ind = m, train_ind

    def __len__(self) -> int:
        return self.m


def port_config(cell, device):
    """The port's config of the cell's configuration file, refused where
    the program would run other values than the file states."""
    from mlsp_tpu_torch.utils import config as C

    cj = cell.config
    cls = getattr(C, cj["port_config"])
    fields = {f.name for f in dataclasses.fields(cls)}
    hyper = cj["hyper"]
    unknown = sorted(set(hyper) - fields)
    if unknown:
        raise Refused(f"{cj['port_config']} has no fields {unknown}")
    cfg = cls(**hyper, device="" if device.type == "cuda" else "cpu")
    cfg = getattr(cfg, cj["recipe"]) if cj.get("recipe") else cfg.resolved()
    moved = {k: (v, getattr(cfg, k)) for k, v in hyper.items()
             if getattr(cfg, k) != v}
    if moved:
        raise Refused(f"the program would run other values than "
                      f"{cell.config_name} states: {moved}")
    return cfg


def make_model(cell, cfg, device, state: dict):
    """The port's model of the configuration, loaded with `state`."""
    from mlsp_tpu_torch.models import make_model as port_make, model_kwargs

    h = cell.config["hyper"]
    model = port_make(h["model"], h["num_class"], device=device,
                      generator=torch.Generator().manual_seed(0),
                      **model_kwargs(cfg))
    if model.k != cell.config["model"]["k"]:
        raise Refused(f"the model's k is {model.k}")
    model.load_state_dict(state, strict=True)
    return model


def make_data(cell, seed: int, device):
    """(src_x, src_y, trgt_x, source split, target split) of the cell."""
    cj, h = cell.config, cell.config["hyper"]
    d, N, nc = cj["data"], h["num_points"], h["num_class"]
    if cj["task"] == "pointda":
        src_x, src_y = data.classification(
            data.derive_seed(seed, 1), d["source_train"], N,
            d["source_noise"], nc, device)
        trgt_x, _ = data.classification(
            data.derive_seed(seed, 2), d["target_train"], N,
            d["target_noise"], nc, device)
        src = _Split(len(src_x), data.split(len(src_x), seed)[0])
        trgt = _Split(len(trgt_x), data.split(len(trgt_x), seed)[0])
    else:
        src_x, src_y = data.segmentation(data.derive_seed(seed, 1),
                                         d["source_train"], N, nc, device)
        trgt_x, _ = data.segmentation(data.derive_seed(seed, 2),
                                      d["target_train"], N, nc, device)
        src, trgt = _Split(len(src_x), None), _Split(len(trgt_x), None)
    return src_x, src_y, trgt_x, src, trgt


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of an epoch's step draws: the trainer's rule,
    SeedSequence((seed, epoch, 1))."""
    return int(np.random.SeedSequence((seed, epoch, 1)).generate_state(1)[0])


def run(run) -> Outcome:
    from mlsp_tpu_torch.ops import kernels
    from mlsp_tpu_torch.train.graphs import Graphs
    from mlsp_tpu_torch.train.pointda_trainer import (
        epoch_pairs,
        fetch_metrics,
        seed_epoch,
        train_epoch,
    )
    from mlsp_tpu_torch.train.pointsegda_trainer import _fetch_preds
    from mlsp_tpu_torch.train.seg_steps import pointsegda_train_scan
    from mlsp_tpu_torch.train.state import make_optimizer
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    cell, dev, seed = run.cell, run.device, run.seed
    seg = cell.config["task"] == "pointsegda"
    cfg = port_config(cell, dev)
    B, S = cfg.batch_size, cfg.scan_steps
    src_x, src_y, trgt_x, src, trgt = make_data(cell, seed, dev)
    spec = cell.ref.spec(cell.ref_cfg)
    w0 = weights.make(spec, data.derive_seed(seed, 3), dev,
                      cell.ref_cfg["pergroup"])
    run.mark("data and weights")
    model = make_model(cell, cfg, dev, w0)
    if hasattr(model, "edge_routes"):
        run.note("EdgeConv routes (edge_impl=%s): %s" % (
            model.edge_impl, ", ".join(model.edge_routes(cfg.num_points,
                                                         dev))))
    run.mark("model and its routes")
    steps_per_epoch = min(len(src.train_ind) if src.train_ind is not None
                          else len(src), len(trgt.train_ind)
                          if trgt.train_ind is not None else len(trgt)) // B
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                steps_per_epoch, cfg.optimizer, cfg.momentum)
    graphs = Graphs() if dev.type == "cuda" else None
    gen = torch.Generator(device=dev)
    scan_fn = pointsegda_train_scan if seg else pointda_train_scan
    names = {p: n for n, p in model.named_parameters()}

    def gather(s, t):
        return src_x[s], src_y[s], trgt_x[t]

    def scan(*chunk):
        return scan_fn(model, opt, sched, *chunk, gen, cfg, graphs)

    def total(step_out):
        return (step_out[0] if seg else step_out)["total"]

    def pairs_of(epoch):
        p = epoch_pairs(src, trgt, B, seed, epoch)
        seed_epoch(gen, seed, epoch)
        return p, torch.from_numpy(np.asarray(p)).to(dev)

    def fetch(outs):
        if seg:
            vals = fetch_metrics([m for m, _ in outs])
            _fetch_preds([p for _, p in outs])
        else:
            vals = fetch_metrics(outs)
        return sum(1 for v in vals if not math.isfinite(v["total"]))

    # ---- set-up: steps 1, 2-3 (each epoch's steps apart), then the rest
    # of the chunk that step 3 is in
    epoch, bad, pending, checked, losses = 0, 0, [], [], []
    pairs, sel = pairs_of(0)
    c = 0
    while len(checked) < STEPS_CHECKED:
        if c >= len(sel):
            bad += fetch(pending)
            epoch, c, pending = epoch + 1, 0, []
            pairs, sel = pairs_of(epoch)
        r = 1 if not checked else min(STEPS_CHECKED - len(checked),
                                      len(sel) - c)
        outs = train_epoch(sel[c:c + r], gather, scan, S)
        pending += outs
        losses += [float(total(o)) for o in outs]
        checked += [(src_x[torch.as_tensor(i)], src_y[torch.as_tensor(i)],
                     trgt_x[torch.as_tensor(j)]) for i, j in pairs[c:c + r]]
        c += r
        if len(checked) == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            grad1 = {names[p]: (st["exp_avg"].detach() / (1.0 - beta1))
                     .clone() for p, st in opt.state.items()
                     if "exp_avg" in st}
    theta3 = {n: p.detach().clone() for n, p in model.named_parameters()}
    rest = min(-c % S, len(sel) - c)
    if rest:
        pending += train_epoch(sel[c:c + rest], gather, scan, S)
        c += rest
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = kernels.launches(), kernels.launches_in_graphs()

    # ---- the window: whole chunks until --seconds have passed
    steps, first_epoch = 0, epoch
    setup_s = run.setup_done()
    with run.trace.window():
        t0 = time.perf_counter()
        while True:
            if c >= len(sel):
                with run.trace.span("fetch_metrics"):
                    bad += fetch(pending)
                pending = []
                if time.perf_counter() - t0 >= run.seconds:
                    break
                epoch += 1
                with run.trace.span("epoch_pairs"):
                    _, sel = pairs_of(epoch)
                c = 0
            with run.trace.span("train_epoch chunk"):
                pending += train_epoch(sel[c:c + S], gather, scan, S)
            r = min(S, len(sel) - c)
            c += r
            steps += r
            if c < len(sel) and time.perf_counter() - t0 >= run.seconds:
                break
        if pending:
            with run.trace.span("fetch_metrics"):
                bad += fetch(pending)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    reading = run.trace.read() if run.trace.on else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    la, lg = kernels.launches(), kernels.launches_in_graphs()
    n_launch = {k: la[k] - launches0[0][k] for k in la}
    n_graph = sum(lg[k] - launches0[1][k] for k in lg)
    run.note(f"window: {steps} steps in {elapsed:.6f} s in epochs "
             f"{first_epoch}-{epoch} ({steps_per_epoch} steps an epoch); "
             "kernel launches "
             f"a step {({k: v / max(steps, 1) for k, v in n_launch.items()})}"
             f", inside replays {n_graph} of {sum(n_launch.values())}; "
             f"peak memory {peak} bytes")

    # ---- the program's state freed, then the reference's three steps
    theta0 = {n: w0[n] for n in theta3}
    del model, opt, sched, graphs, gen, pending, src_x, src_y, trgt_x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(cell, seed, w0, checked, steps_per_epoch, losses, grad1,
                     theta0, theta3, run.note)
    return Outcome(metrics={"train_clouds_per_s": steps * B / elapsed,
                            "setup_s": setup_s},
                   counts={"steps": steps, "clouds": steps * B},
                   readings=readings, attempted=steps, failed=bad,
                   memory_peak_bytes=peak, reading=reading)


def reference_steps(cell, seed: int, w0: dict, batches,
                    steps_per_epoch: int) -> tuple:
    """The reference's first steps from the weights w0 on `batches`, the
    trainer's steps 1, 2, ... of `steps_per_epoch` an epoch: each epoch's
    draws from a generator seeded by `epoch_seed`, the LR of the recipe's
    per-epoch cosine. Returns (losses, the first gradient as its Adam
    took it, the weights after the steps)."""
    from benchmark.reference import plain

    cfg = cell.ref_cfg
    W = {k: v.detach().clone() for k, v in w0.items()}
    names = weights.trainable(cell.ref.spec(cfg))
    for n in names:
        W[n].requires_grad_(True)
    adam = plain.Adam({n: W[n] for n in names}, cfg["lr"], cfg["wd"])
    dev = next(iter(W.values())).device
    g = torch.Generator(device=dev)
    losses, grad1 = [], None
    for i, (src_x, src_y, trgt_x) in enumerate(batches):
        epoch = i // steps_per_epoch
        if i % steps_per_epoch == 0:
            g.manual_seed(epoch_seed(seed, epoch))
        adam.lr = cfg["lr"] * plain.cosine_factor(epoch, cfg["epochs"])
        loss = cell.ref.train_loss(W, src_x, src_y, trgt_x, g, cfg)
        grads = torch.autograd.grad(loss, [W[n] for n in names],
                                    allow_unused=True)
        taken = adam.step(dict(zip(names, grads)))
        grad1 = taken if grad1 is None else grad1
        losses.append(float(loss.detach()))
    return losses, grad1, {n: W[n].detach() for n in names}


def numbers(cell, prog: tuple, ref: tuple, theta0: dict) -> tuple:
    """Every number the comparison can hold, of a program's (losses, first
    gradient, weights after the steps) against the reference's: the
    steps' losses (all, and the first alone), the first gradient and the
    change over the steps by the worst leaf, and the median leaf's
    change. Returns (numbers, what the notes say)."""
    losses, grad1, theta3 = prog
    r_losses, r_grad1, r_theta = ref
    names = list(r_theta)
    g_gap, g_at = compare.leaf_gaps(grad1, r_grad1, names)
    move = compare.moving(r_grad1, names)
    d_p = {n: theta3[n] - theta0[n] for n in move}
    d_r = {n: r_theta[n] - theta0[n] for n in move}
    c_gap, c_at = compare.leaf_gaps(d_p, d_r, move)
    out = {"loss_gap": compare.loss_gap(losses, r_losses),
           "loss1_gap": compare.loss_gap(losses[:1], r_losses[:1]),
           "grad_gap": g_gap, "median_grad_gap": compare.median_gap(
               grad1, r_grad1), "change_gap": c_gap,
           "median_change_gap": compare.median_gap(d_p, d_r)}
    say = (f"reference losses {r_losses}, program {losses}; worst gradient "
           f"leaf {g_at}, worst change leaf {c_at}; {len(names) - len(move)}"
           f" of {len(names)} leaves left out of the change (reference "
           "gradient under a thousandth of the median leaf's)")
    return out, say


def check(cell, seed, w0, batches, steps_per_epoch, losses, grad1, theta0,
          theta3, note) -> dict:
    """Every number the comparison can hold (`numbers`), of the program's
    first steps against the reference's."""
    t0 = time.perf_counter()
    ref = reference_steps(cell, seed, w0, batches, steps_per_epoch)
    got, say = numbers(cell, (losses, grad1, theta3), ref, theta0)
    note(f"{say}; {got}; the reference took {time.perf_counter() - t0:.3f} s")
    return got
