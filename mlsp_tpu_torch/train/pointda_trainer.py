"""PointDA-10 domain-adaptation trainer (counterpart of
`mlsp_tpu/train/pointda_trainer.py`, the reference's
`PointDA/trainer.py:341-611`).

Each epoch zips shuffled source and target batches through
`train.steps.pointda_train_step`, validates on both domains and keeps the
best model by *source* validation accuracy; the final test runs on the
target test split with the best epoch's weights.

Device and host: every split is staged on the device once; batches are
gathered there with the epoch's numpy-shuffled indices (copied once per
epoch). Each step's loss terms stay on the device until the end of the
epoch, when they are fetched in one copy and fed to `MeterDict` in step
order. Evaluation fetches its logits once per split.

Each epoch is one `torch.profiler` range, "mlsp/epoch {epoch}" (a trace
taken with the CLI's --profile_dir shows it beside the kernels), and its
wall time goes into its `metrics.jsonl` record: "seconds" {"train": the
steps up to the fetch of their losses, "epoch": with validation}.

Random streams per epoch, derived from (seed, epoch) and not consumed
across epochs, so that a resumed run repeats the uninterrupted one: the
batch order from `np.random.default_rng(SeedSequence((seed, epoch)))`,
shared by the source and then the target iterator as in the JAX trainer
(the same index order), and the step draws and dropout from a
`torch.Generator` seeded with `SeedSequence((seed, epoch, 1))`.
"""

from __future__ import annotations

import copy
import functools
import os
import time

import numpy as np
import torch

from mlsp_tpu_torch.data.pipeline import batch_indices
from mlsp_tpu_torch.data.pointda import idx_to_label, load_pointda
from mlsp_tpu_torch.models import make_model, model_kwargs
from mlsp_tpu_torch.parallel.mesh import (
    Mesh,
    fetch_global,
    replicate_for_mesh,
    shard_batch,
)
from mlsp_tpu_torch.train.guard import check_finite_losses
from mlsp_tpu_torch.train.state import make_optimizer
from mlsp_tpu_torch.train.steps import check_recipe, pointda_train_step
from mlsp_tpu_torch.utils import checkpoint, metrics
from mlsp_tpu_torch.utils.average_meter import MeterDict
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    trained_heads,
    validate_heads,
)
from mlsp_tpu_torch.utils.device import resolve_device
from mlsp_tpu_torch.utils.logging import IOStream


def eval_batches(n_examples: int, batch_size: int,
                 indices: np.ndarray | None = None):
    """The eval order: consecutive batches of the split (all of it, or
    `indices`), the trailing one repetition-padded to `batch_size`.
    Returns (index arrays of batch_size each, valid counts)."""
    sels, counts = [], []
    for sel in batch_indices(n_examples, batch_size, indices=indices):
        n = sel.shape[0]
        if n < batch_size:
            sel = np.concatenate([sel] * -(-batch_size // n))[:batch_size]
        sels.append(sel)
        counts.append(n)
    return sels, counts


def eval_logits(model: torch.nn.Module, data, sels: list[np.ndarray],
                output: str = "cls", mesh: Mesh | None = None) -> np.ndarray:
    """Logits [S, B, ...] of the batches `data[sels[i]]` (the model's
    `output`: "cls" [B, C] of DGCNN, "seg" [B, N, C] of DGCNNSeg),
    forwarded in eval mode (running BN statistics, no dropout) on the
    model's device; one copy of the indices in, one of the logits out. The
    model's mode is restored afterwards. With a mesh each rank forwards its
    rows of every batch (padded with the batch's last index to a multiple
    of the ranks) and every rank gets all the logits (`fetch_global`)."""
    device = next(model.parameters()).device
    x = torch.as_tensor(data, device=device)
    idx = torch.from_numpy(np.stack(sels)).to(device)
    B = idx.shape[1]
    if mesh is not None:
        pad = -B % mesh.size
        idx = torch.cat([idx, idx[:, -1:].expand(-1, pad)], 1)
        idx = shard_batch(mesh, idx.T).T
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            out = torch.stack([model(x[i])[output] for i in idx])
    finally:
        model.train(was_training)
    if mesh is not None:
        out = fetch_global(out.transpose(0, 1), mesh).transpose(0, 1)[:, :B]
    return out.float().cpu().numpy()


def evaluate(model: torch.nn.Module, data, label: np.ndarray,
             batch_size: int, num_classes: int,
             indices: np.ndarray | None = None,
             mesh: Mesh | None = None) -> dict:
    """Accuracy, balanced accuracy, mean cross-entropy and the confusion
    matrix over a split. `data` [M, N, 3] is a numpy array or a tensor
    (staged on the model's device, it is not copied); `label` [M] numpy.
    The metrics are computed in numpy as the JAX `evaluate` does. With a
    mesh the forwards are split over the ranks (`eval_logits`) and every
    rank gets the same metrics."""
    label = np.asarray(label)
    sels, counts = eval_batches(label.shape[0], batch_size, indices)
    if not sels:
        raise ValueError("evaluate: empty evaluation split")
    all_logits = eval_logits(model, data, sels, mesh=mesh)
    preds, trues, losses = [], [], []
    for logits, sel, n in zip(all_logits, sels, counts):
        logits, by = logits[:n], label[sel][:n]
        logp = metrics.log_softmax_np(logits)
        losses.append(-logp[np.arange(n), by].sum())
        preds.append(logits.argmax(-1))
        trues.append(by)
    preds, trues = np.concatenate(preds), np.concatenate(trues)
    return {
        "acc": metrics.accuracy(trues, preds),
        "balanced_acc": metrics.balanced_accuracy(trues, preds),
        "loss": float(np.sum(losses) / float(np.sum(counts))),
        "conf_mat": metrics.confusion_matrix(trues, preds, num_classes),
    }


def epoch_pairs(src, trgt, batch_size: int, seed: int, epoch: int
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The epoch's (source, target) batch indices: each train split
    shuffled by one generator from (seed, epoch), the source first, full
    batches only, zipped to the shorter."""
    erng = np.random.default_rng(np.random.SeedSequence((seed, epoch)))
    return list(zip(
        batch_indices(len(src), batch_size, indices=src.train_ind,
                      shuffle=True, drop_last=True, rng=erng),
        batch_indices(len(trgt), batch_size, indices=trgt.train_ind,
                      shuffle=True, drop_last=True, rng=erng)))


def epoch_generator(seed: int, epoch: int,
                    device: torch.device) -> torch.Generator:
    """The epoch's generator for the step draws and dropout."""
    s = int(np.random.SeedSequence((seed, epoch, 1)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def fetch_metrics(steps: list[dict]) -> list[dict]:
    """The steps' 0-d device tensors as host floats, in one copy."""
    if not steps:
        return []
    names = list(steps[0])
    vals = torch.stack([torch.stack([m[k].float() for k in names])
                        for m in steps]).cpu().numpy()
    return [dict(zip(names, row)) for row in vals]


def train_pointda(cfg: PointDAConfig, io: IOStream | None = None,
                  mesh: Mesh | None = None):
    """Run the DA training; returns (model with the best epoch's weights,
    results dict with "best" and "test").

    With `mesh` (`parallel.make_mesh`, one process per rank): the model is
    replicated from rank 0, each step takes the global batch and forwards
    the rank's rows with the gradients averaged over the ranks, evaluation
    is split over the ranks and gathered on each, and only rank 0 writes
    files."""
    cfg = cfg.resolved()
    device = resolve_device(cfg.device or None)
    all_heads = validate_heads(cfg)
    trained = trained_heads(cfg)
    check_recipe(cfg)
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    io.cprint(str(cfg))

    load = functools.partial(load_pointda, dataroot=cfg.dataroot,
                             num_points=cfg.num_points,
                             synthetic_fallback=cfg.synthetic, seed=cfg.seed,
                             device=device)
    src_train = load(cfg.src_dataset, partition="train")
    trgt_train = load(cfg.trgt_dataset, partition="train")
    trgt_test = load(cfg.trgt_dataset, partition="test")
    src_x, trgt_x, test_x = (torch.from_numpy(d.data).to(device)
                             for d in (src_train, trgt_train, trgt_test))
    src_y = torch.from_numpy(src_train.label).to(device)

    B = cfg.batch_size
    steps_per_epoch = min(len(src_train.train_ind),
                          len(trgt_train.train_ind)) // B
    model = make_model(cfg.model, cfg.num_class, device=device,
                       generator=torch.Generator().manual_seed(cfg.seed),
                       **model_kwargs(cfg))
    # Heads no loss reads keep grad None, so the optimizer leaves them as
    # they are.
    io.cprint(f"heads trained: {', '.join(trained)}; frozen: "
              f"{', '.join(h for h in all_heads if h not in trained)}")
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                steps_per_epoch, cfg.optimizer, cfg.momentum)

    # A copy, not the live state_dict: its tensors would go on training.
    best = {"src_val_acc": 0.0, "epoch": -1,
            "weights": copy.deepcopy(model.state_dict())}
    ckpt_path = os.path.join(io.path, "model.ckpt")
    start_epoch = 0
    if cfg.resume:
        saved_epoch, saved = checkpoint.load_train_state(cfg.resume, model,
                                                         opt, sched)
        start_epoch = saved_epoch + 1
        best["src_val_acc"] = float((saved or {}).get("src_val_acc", 0.0))
        best["weights"] = copy.deepcopy(model.state_dict())
        io.cprint(f"resumed from {cfg.resume} at epoch {saved_epoch} "
                  f"(best src val acc {best['src_val_acc']:.4f})")
    replicate_for_mesh(mesh, model, B)
    io.trim_metrics(start_epoch)  # drop records the loop will write again

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"mlsp/epoch {epoch}"):
            pairs = epoch_pairs(src_train, trgt_train, B, cfg.seed, epoch)
            gen = epoch_generator(cfg.seed, epoch, device)
            steps = []
            if pairs:
                sel = torch.from_numpy(np.asarray(pairs)).to(device)  # [S, 2, B]
                for s, t in sel:
                    steps.append(pointda_train_step(
                        model, opt, sched, src_x[s], src_y[s], trgt_x[t], gen,
                        cfg, mesh))
            meters = MeterDict()
            for m in fetch_metrics(steps):
                meters.update(m, n=B)
            t_train = time.perf_counter() - t0

            io.print_progress("Source+Target", "Trn", epoch, meters.averages())
            check_finite_losses(meters.averages(), model, opt, sched, epoch, io)

            src_val = evaluate(model, src_x, src_train.label,
                               cfg.test_batch_size, cfg.num_class,
                               src_train.val_ind, mesh)
            trgt_val = evaluate(model, trgt_x, trgt_train.label,
                                cfg.test_batch_size, cfg.num_class,
                                trgt_train.val_ind, mesh)
        seconds = {"train": t_train, "epoch": time.perf_counter() - t0}
        io.cprint(
            f"Val - epoch {epoch}: src acc {src_val['acc']:.4f} "
            f"(bal {src_val['balanced_acc']:.4f}, loss {src_val['loss']:.4f}), "
            f"trgt acc {trgt_val['acc']:.4f} (loss {trgt_val['loss']:.4f})")
        io.log_metrics({
            "epoch": epoch, "seconds": seconds, "train": meters.averages(),
            "src_val": {k: src_val[k] for k in ("acc", "balanced_acc", "loss")},
            "trgt_val": {k: trgt_val[k] for k in ("acc", "balanced_acc", "loss")},
        })

        # model selection by source val acc (trainer.py:589-596)
        if src_val["acc"] > best["src_val_acc"]:
            best.update(src_val_acc=src_val["acc"], src_val_loss=src_val["loss"],
                        trgt_val_acc=trgt_val["acc"],
                        trgt_val_loss=trgt_val["loss"], epoch=epoch,
                        weights=copy.deepcopy(model.state_dict()),
                        conf_mat=trgt_val["conf_mat"])
            checkpoint.save_train_state(ckpt_path, model, opt, sched, epoch,
                                        {"src_val_acc": src_val["acc"]})
        # last.ckpt: progress for --resume, at most save_every - 1 epochs lost
        if cfg.save_every and (epoch + 1) % cfg.save_every == 0:
            checkpoint.save_train_state(
                os.path.join(io.path, "last.ckpt"), model, opt, sched, epoch,
                {"src_val_acc": best["src_val_acc"]})

    io.cprint(f"Best model found at epoch {best['epoch']}, "
              f"source val acc: {best['src_val_acc']:.4f}")
    # the reference prints the best epoch's target-val confusion matrix
    # before the test one (trainer.py:601-602)
    if "conf_mat" in best:
        io.cprint("Best validation model confusion matrix:\n"
                  + str(best["conf_mat"]))
    model.load_state_dict(best.pop("weights"))
    final = evaluate(model, test_x, trgt_test.label, cfg.test_batch_size,
                     cfg.num_class, mesh=mesh)
    io.cprint(f"target test accuracy: {final['acc']:.4f}, "
              f"target test loss: {final['loss']:.4f}")
    io.cprint("Test confusion matrix:\n" + str(final["conf_mat"]))
    io.save_conf_mat(final["conf_mat"], "test_conf_mat.csv", "Target",
                     class_names=[idx_to_label.get(i, str(i))
                                  for i in range(cfg.num_class)])
    return model, {"best": best, "test": final}
