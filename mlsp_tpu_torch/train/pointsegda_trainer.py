"""PointSegDA segmentation DA trainer (counterpart of
`mlsp_tpu/train/pointsegda_trainer.py`, the reference's
`PointSegDA/trainer.py:282-511`).

Each epoch zips shuffled source and target batches of min(|src|, |trgt|,
batch_size) clouds through `train.seg_steps.pointsegda_train_step`,
validates on both domains and keeps the best model by the *lowest source
validation seg loss*; the final test runs on the target test split with
the best epoch's weights. There is no resume, as in the JAX trainer.

Device and host, as the PointDA trainer (`train.pointda_trainer`): every
split is staged on the device once, batches are gathered there with the
epoch's indices (one copy an epoch), the epoch runs as chunks of
`scan_steps` steps, then its tail as one shorter chunk
(`seg_steps.pointsegda_train_scan`: on the card every step a replay of
one captured step graph, under an NCCL mesh with its collectives;
eagerly on the CPU and under gloo), and each step's loss terms,
predictions and labels stay on the device until one fetch at the end of
the epoch, where the train mIoU is computed step by step as the JAX
trainer does. Evaluation runs through the scanned eval (`eval_logits`,
a captured forward on the card) and fetches its logits once per chunk
of batches.

Random streams per epoch from (seed, epoch): the batch order from one
numpy generator shared by the source and then the target iterator (the
JAX trainer's indices), the step draws and dropout from the run's
`torch.Generator` seeded anew each epoch (`pointda_trainer.seed_epoch`).
Each epoch is one
`torch.profiler` range, "mlsp/epoch {epoch}", and its wall time goes into
its `metrics.jsonl` record.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from mlsp_tpu_torch.data.pointsegda import load_pointsegda
from mlsp_tpu_torch.models import make_model, model_kwargs
from mlsp_tpu_torch.parallel.mesh import (
    Mesh,
    points_sharding,
    replicate_for_mesh,
)
from mlsp_tpu_torch.train.graphs import Graphs
from mlsp_tpu_torch.train.guard import check_finite_losses
from mlsp_tpu_torch.train.pointda_trainer import (
    epoch_pairs,
    eval_batches,
    eval_logits,
    fetch_metrics,
    graphs_route,
    seed_epoch,
    train_epoch,
)
from mlsp_tpu_torch.train.seg_steps import (
    check_seg_recipe,
    pointsegda_train_scan,
)
from mlsp_tpu_torch.train.state import make_optimizer
from mlsp_tpu_torch.utils import checkpoint, metrics
from mlsp_tpu_torch.utils.average_meter import MeterDict
from mlsp_tpu_torch.utils.config import (
    PointSegDAConfig,
    trained_seg_heads,
    validate_seg_heads,
)
from mlsp_tpu_torch.utils.device import resolve_device
from mlsp_tpu_torch.utils.logging import IOStream
from mlsp_tpu_torch.utils.summary import model_summary

MAX_LOSS = 9e9


def evaluate_seg(model: torch.nn.Module, data, label: np.ndarray,
                 batch_size: int, mesh: Mesh | None = None,
                 graphs: Graphs | None = None) -> tuple[float, float, float]:
    """(seg loss, mIoU, accuracy) over a split, each averaged per sample
    as the reference does; the trailing batch is repetition-padded and
    only its real clouds count. `data` [M, N, 3] is a numpy array or a
    tensor (staged on the model's device, it is not copied); `label`
    [M, N] numpy. With a mesh the forwards are split over the ranks and
    every rank gets the same metrics (`eval_logits`)."""
    label = np.asarray(label)
    sels, counts = eval_batches(label.shape[0], batch_size)
    if not sels:
        raise ValueError("evaluate_seg: empty evaluation split")
    all_logits = eval_logits(model, data, sels, "seg", mesh,
                             graphs)  # [S, B, N, C]
    seg_loss = miou = acc = 0.0
    for logits, sel, n in zip(all_logits, sels, counts):
        logits, by = logits[:n], label[sel][:n]
        logp = metrics.log_softmax_np(logits)
        seg_loss += -np.take_along_axis(logp, by[..., None], -1).mean() * n
        bm, ba = metrics.seg_metrics(by, logits.argmax(-1))
        miou += bm
        acc += ba
    n_total = float(np.sum(counts))
    return (float(seg_loss / n_total), float(miou / n_total),
            float(acc / n_total))


def _fetch_preds(steps: list) -> list[tuple[np.ndarray, np.ndarray]]:
    """The steps' (predictions, labels) [B, N] as host arrays, in one
    copy."""
    if not steps:
        return []
    both = torch.stack([torch.stack(p) for p in steps]).cpu().numpy()
    return [(p, y) for p, y in both]


def train_pointsegda(cfg: PointSegDAConfig, io: IOStream | None = None,
                     mesh: Mesh | None = None):
    """Run the seg DA training; returns (model with the best epoch's
    weights, results dict with "best" and "test"). With `mesh`, data-
    parallel as `pointda_trainer.train_pointda`: the train predictions of
    each step are the global batch's, so the train mIoU is the single
    process's."""
    cfg = cfg.resolved()
    device = resolve_device(cfg.device or None)
    all_heads = validate_seg_heads(cfg)
    trained = trained_seg_heads(cfg)
    check_seg_recipe(cfg)
    io = io or IOStream(cfg.out_path, f"{cfg.exp_name}_{cfg.src_dataset}_"
                                      f"{cfg.trgt_dataset}")
    io.cprint(str(cfg))

    def load(name, part):
        return load_pointsegda(name, cfg.dataroot, part, cfg.synthetic,
                               cfg.num_points)

    src_train, src_val = load(cfg.src_dataset, "train"), load(cfg.src_dataset,
                                                              "val")
    trgt_train, trgt_val = (load(cfg.trgt_dataset, "train"),
                            load(cfg.trgt_dataset, "val"))
    trgt_test = load(cfg.trgt_dataset, "test")
    staged = {name: (torch.from_numpy(d.data).to(device), d.label)
              for name, d in (("src_train", src_train), ("src_val", src_val),
                              ("trgt_train", trgt_train),
                              ("trgt_val", trgt_val), ("trgt_test", trgt_test))}
    src_x, trgt_x = staged["src_train"][0], staged["trgt_train"][0]
    src_y = torch.from_numpy(src_train.label).to(device)

    # batch = min(len(src), len(trgt), batch_size)  (trainer.py:184)
    B = min(len(src_train), len(trgt_train), cfg.batch_size)
    steps_per_epoch = min(len(src_train), len(trgt_train)) // B
    model = make_model(cfg.model, cfg.num_class, device=device,
                       generator=torch.Generator().manual_seed(cfg.seed),
                       **model_kwargs(cfg))
    # Heads no loss reads keep grad None, so the optimizer leaves them as
    # they are.
    io.cprint(f"heads trained: {', '.join(trained)}; frozen: "
              f"{', '.join(h for h in all_heads if h not in trained)}")
    io.cprint("\n" + model_summary(model))
    replicate_for_mesh(mesh, model, B)
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                steps_per_epoch, cfg.optimizer, cfg.momentum)

    # A copy, not the live state_dict: its tensors would go on training.
    best = {"src_val_loss": MAX_LOSS, "epoch": -1,
            "weights": copy.deepcopy(model.state_dict())}
    ckpt_path = os.path.join(io.path, "model.ckpt")
    io.trim_metrics(0)  # a fresh run: drop any earlier metrics.jsonl

    step_graphs, graphs = graphs_route(cfg, device, mesh, io)
    gen = torch.Generator(device=device)

    def val(name):
        return evaluate_seg(model, *staged[name], cfg.test_batch_size, mesh,
                            graphs)

    def gather(s, t):
        return src_x[s], src_y[s], trgt_x[t]

    def scan(*chunk):
        with points_sharding(mesh):
            return pointsegda_train_scan(model, opt, sched, *chunk, gen, cfg,
                                         graphs, mesh)

    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"mlsp/epoch {epoch}"):
            pairs = epoch_pairs(src_train, trgt_train, B, cfg.seed, epoch)
            seed_epoch(gen, cfg.seed, epoch)
            steps = []
            if pairs:
                sel = torch.from_numpy(np.asarray(pairs)).to(device)  # [P, 2, B]
                steps = train_epoch(sel, gather, scan, cfg.scan_steps)
            meters = MeterDict()
            for m, (p, y) in zip(fetch_metrics([m for m, _ in steps]),
                                 _fetch_preds([p for _, p in steps])):
                meters.update(m, n=B)
                meters.update({"src_train_mIoU":
                               metrics.seg_metrics(y, p)[0] / B}, n=B)
            t_train = time.perf_counter() - t0

            io.print_progress("Source+Target", "Trn", epoch, meters.averages())
            check_finite_losses(meters.averages(), model, opt, sched, epoch,
                                io)
            src_val_loss, src_val_miou, src_val_acc = val("src_val")
            trgt_val_loss, trgt_val_miou, trgt_val_acc = val("trgt_val")
        seconds = {"train": t_train, "epoch": time.perf_counter() - t0}
        io.cprint(
            f"Val - epoch {epoch}: src loss {src_val_loss:.4f} mIoU "
            f"{src_val_miou:.4f} acc {src_val_acc:.4f} | trgt loss "
            f"{trgt_val_loss:.4f} mIoU {trgt_val_miou:.4f} acc "
            f"{trgt_val_acc:.4f}")
        io.log_metrics({
            "epoch": epoch, "seconds": seconds, "step_graphs": step_graphs,
            "train": meters.averages(),
            "src_val": {"loss": src_val_loss, "mIoU": src_val_miou,
                        "acc": src_val_acc},
            "trgt_val": {"loss": trgt_val_loss, "mIoU": trgt_val_miou,
                         "acc": trgt_val_acc},
        })

        # best by the lowest source val seg loss (trainer.py:457-465)
        if src_val_loss < best["src_val_loss"]:
            best.update(src_val_loss=src_val_loss, src_val_miou=src_val_miou,
                        trgt_val_loss=trgt_val_loss,
                        trgt_val_miou=trgt_val_miou,
                        trgt_val_acc=trgt_val_acc, epoch=epoch,
                        weights=copy.deepcopy(model.state_dict()))
            checkpoint.save_train_state(ckpt_path, model, opt, sched, epoch,
                                        {"src_val_loss": src_val_loss})

    io.cprint(f"Best model was found at epoch {best['epoch']}")
    model.load_state_dict(best.pop("weights"))
    test_loss, test_miou, test_acc = evaluate_seg(
        model, *staged["trgt_test"], cfg.test_batch_size, mesh, graphs)
    io.cprint(f"target test seg loss: {test_loss:.4f}, target test seg "
              f"mIOU: {test_miou:.4f}, target test seg accuracy: "
              f"{test_acc:.4f}")
    return model, {"best": best, "test": {"loss": test_loss,
                                          "mIoU": test_miou,
                                          "acc": test_acc}}
