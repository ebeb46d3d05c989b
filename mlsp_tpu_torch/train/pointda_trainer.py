"""PointDA-10 domain-adaptation trainer (counterpart of
`mlsp_tpu/train/pointda_trainer.py`, the reference's
`PointDA/trainer.py:341-611`).

Each epoch zips shuffled source and target batches through
`train.steps.pointda_train_scan`, validates on both domains and keeps the
best model by *source* validation accuracy; the final test runs on the
target test split with the best epoch's weights.

Device and host: every split is staged on the device once; batches are
gathered there with the epoch's numpy-shuffled indices (copied once per
epoch). The epoch runs as chunks of `scan_steps` steps, then the
remaining steps as one shorter chunk, as the JAX trainer runs its scan
and then its jitted single steps (`steps.pointda_train_scan`: on the card
every step, the tail's and `scan_steps` 1's too, is a replay of one
captured CUDA graph of the step, captured at the first chunk of the run,
after any `--resume`; every recipe, PCM at any `mixup_params` too).
Under an NCCL mesh the graph holds the step's collectives; a gloo mesh
takes its steps eagerly (`steps.replays_steps`): the log and every
`metrics.jsonl` record say whether step graphs ran ("step_graphs"). The
log names each EdgeConv layer's route. Each step's loss terms stay on
the device until the end of the epoch, when they are fetched in one copy
and fed to `MeterDict` in step order. Evaluation runs through the
scanned eval forward (`steps.eval_scan`, a captured graph on the card, a
rank's own under an NCCL mesh) and fetches its logits once per chunk of
batches.

Each epoch is one span, "epoch {epoch}" (`utils.profiling.span`: a trace
taken with the CLI's --profile_dir shows the range "mlsp/epoch {epoch}"
beside the kernels), inside it the spans of the batch order, each
chunk's gather and steps, the fetch and the eval forwards and metrics;
its wall time goes into its `metrics.jsonl` record: "seconds" {"train":
the steps up to the fetch of their losses, "epoch": with validation}.

Random streams per epoch, derived from (seed, epoch) and not consumed
across epochs, so that a resumed run repeats the uninterrupted one: the
batch order from `np.random.default_rng(SeedSequence((seed, epoch)))`,
shared by the source and then the target iterator as in the JAX trainer
(the same index order), and the step draws and dropout from one
`torch.Generator` of the run, seeded anew each epoch with
`SeedSequence((seed, epoch, 1))` (in place: a step graph holds it). The
draws do not depend on `scan_steps`, where the JAX trainer's keys split
per chunk.
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
    captures,
    fetch_global,
    points_sharding,
    replicate_for_mesh,
    shard_batch,
)
from mlsp_tpu_torch.train.graphs import Graphs, unstack_steps
from mlsp_tpu_torch.train.guard import check_finite_losses
from mlsp_tpu_torch.train.state import make_optimizer
from mlsp_tpu_torch.train.steps import (
    check_recipe,
    eval_scan,
    pointda_train_scan,
    scan_in_chunks,
)
from mlsp_tpu_torch.utils import checkpoint, metrics
from mlsp_tpu_torch.utils.average_meter import MeterDict
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    trained_heads,
    validate_heads,
)
from mlsp_tpu_torch.utils.device import resolve_device
from mlsp_tpu_torch.utils.logging import IOStream
from mlsp_tpu_torch.utils.profiling import span


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


def eval_index(sels: list[np.ndarray], mesh: Mesh | None) -> np.ndarray:
    """The eval batches' indices [S, B'] as this rank forwards them:
    `sels` stacked; with a mesh, each batch padded with its last index to
    a multiple of the data ranks, then the rank's rows (`shard_batch`)."""
    idx = np.stack(sels)
    if mesh is None:
        return idx
    pad = -idx.shape[1] % mesh.size
    idx = np.concatenate([idx, np.repeat(idx[:, -1:], pad, 1)], 1)
    return shard_batch(mesh, idx.T).T


def eval_logits(model: torch.nn.Module, data, sels: list[np.ndarray],
                output: str = "cls", mesh: Mesh | None = None,
                graphs: Graphs | None = None) -> np.ndarray:
    """Logits [S, B, ...] of the batches `data[sels[i]]` (the model's
    `output`: "cls" [B, C] of DGCNN, "seg" [B, N, C] of DGCNNSeg),
    forwarded in eval mode (running BN statistics, no dropout) on the
    model's device through the scanned eval (`steps.scan_in_chunks` of
    `eval_scan`: on the card a captured eval forward, kept in `graphs`);
    one copy of the indices in, one of the logits out per chunk. The
    model's mode is restored afterwards. With a mesh each rank forwards
    its rows of every batch (`eval_index`; a rank of an NCCL mesh through
    its own captured forward, a gloo rank eagerly; on a points mesh under
    `points_sharding`) and every rank gets all the logits (`fetch_global`
    once a chunk, after its forwards)."""
    device = next(model.parameters()).device

    def scan(m, xs, graphs):
        out = eval_scan(m, xs, graphs, output, mesh)
        return fetch_global(out.transpose(0, 1), mesh).transpose(0, 1)

    with span("eval_logits"):
        x = torch.as_tensor(data, device=device)
        with span("eval_index"):
            idx = torch.from_numpy(eval_index(sels, mesh)).to(device)
        out = scan_in_chunks(scan, model, x[idx], graphs=graphs)
    return out[:, :len(sels[0])]


def evaluate(model: torch.nn.Module, data, label: np.ndarray,
             batch_size: int, num_classes: int,
             indices: np.ndarray | None = None,
             mesh: Mesh | None = None, graphs: Graphs | None = None) -> dict:
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
    all_logits = eval_logits(model, data, sels, mesh=mesh, graphs=graphs)
    with span("eval_metrics"):
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
    with span("epoch_pairs"):
        erng = np.random.default_rng(np.random.SeedSequence((seed, epoch)))
        return list(zip(
            batch_indices(len(src), batch_size, indices=src.train_ind,
                          shuffle=True, drop_last=True, rng=erng),
            batch_indices(len(trgt), batch_size, indices=trgt.train_ind,
                          shuffle=True, drop_last=True, rng=erng)))


def seed_epoch(generator: torch.Generator, seed: int,
               epoch: int) -> torch.Generator:
    """Seed the run's generator in place for `epoch`'s step draws and
    dropout; returns it."""
    s = int(np.random.SeedSequence((seed, epoch, 1)).generate_state(1)[0])
    return generator.manual_seed(s)


def train_epoch(pairs: torch.Tensor, gather, scan, scan_steps: int) -> list:
    """An epoch's steps in the JAX trainer's order: chunks of `scan_steps`
    batches through `scan(*stacked)`, whose outputs are stacked over the
    chunk, the remaining batches as one shorter chunk (every batch, when
    the epoch is shorter; one batch a chunk at `scan_steps` 1). `pairs`
    [P, 2, B] are the (first, second) index rows on the device;
    `gather(first, second)` makes a stacked chunk of them. Returns the
    per-step outputs."""
    S = max(scan_steps, 1)
    out = []
    with span("train_epoch"):
        for c in range(0, len(pairs), S):
            with span("gather"):
                chunk = gather(pairs[c:c + S, 0], pairs[c:c + S, 1])
            out += unstack_steps(scan(*chunk))
    return out


def graphs_route(cfg, device: torch.device, mesh: Mesh | None,
                 io: IOStream) -> tuple[bool, Graphs | None]:
    """Whether the trainer's steps and eval forwards replay graphs (on the
    card, with no mesh or an NCCL one, `parallel.mesh.captures`: chunks,
    the epoch's tail and `scan_steps` 1's single steps alike, every
    recipe), said in the log, and the run's graphs (`Graphs`; None where
    nothing is captured: the CPU, a gloo mesh)."""
    S = cfg.scan_steps
    on = device.type == "cuda" and captures(mesh)
    if on:
        how = (f"chunks of {S} steps and the epoch's tail replay one "
               "captured graph" if S > 1
               else "scan_steps 1: each step replays one captured graph")
        if mesh is not None:
            how += " with the mesh's NCCL collectives"
        how += "; eval forwards replay captured graphs"
        if mesh is not None:
            how += " of the rank's rows"
    else:
        eager = (f"on the {device.type}" if device.type != "cuda"
                 else f"under {mesh.backend} (its collectives cannot be "
                 "captured)")
        how = f"steps run eagerly {eager}; eval forwards run eagerly {eager}"
    io.cprint(f"step graphs: {'on' if on else 'off'} ({how})")
    return on, Graphs() if on else None


def log_edge_routes(model: torch.nn.Module, n: int, device: torch.device,
                    io: IOStream) -> None:
    """Name each EdgeConv layer's route for clouds of `n` points (a DGCNN's
    `edge_routes`; nothing for the other families)."""
    if hasattr(model, "edge_routes"):
        io.cprint(f"EdgeConv routes (edge_impl={model.edge_impl}): "
                  + ", ".join(model.edge_routes(n, device)))


def fetch_metrics(steps: list[dict]) -> list[dict]:
    """The steps' 0-d device tensors as host floats, in one copy."""
    if not steps:
        return []
    names = list(steps[0])
    with span("fetch_metrics"):
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
    files. On a points axis the steps and eval forwards run under
    `points_sharding(mesh)`."""
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
    log_edge_routes(model, src_x.shape[1], device, io)
    step_graphs, graphs = graphs_route(cfg, device, mesh, io)
    gen = torch.Generator(device=device)

    def gather(s, t):
        return src_x[s], src_y[s], trgt_x[t]

    # the steps split their O(N^2) work over a points axis, as JAX's
    # trainer traces them under `points_sharding`
    def scan(*chunk):
        with points_sharding(mesh):
            return pointda_train_scan(model, opt, sched, *chunk, gen, cfg,
                                      graphs, mesh)

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        with span(f"epoch {epoch}"):
            pairs = epoch_pairs(src_train, trgt_train, B, cfg.seed, epoch)
            seed_epoch(gen, cfg.seed, epoch)
            steps = []
            if pairs:
                sel = torch.from_numpy(np.asarray(pairs)).to(device)  # [P, 2, B]
                steps = train_epoch(sel, gather, scan, cfg.scan_steps)
            meters = MeterDict()
            for m in fetch_metrics(steps):
                meters.update(m, n=B)
            t_train = time.perf_counter() - t0

            io.print_progress("Source+Target", "Trn", epoch, meters.averages())
            check_finite_losses(meters.averages(), model, opt, sched, epoch, io)

            src_val = evaluate(model, src_x, src_train.label,
                               cfg.test_batch_size, cfg.num_class,
                               src_train.val_ind, mesh, graphs)
            trgt_val = evaluate(model, trgt_x, trgt_train.label,
                                cfg.test_batch_size, cfg.num_class,
                                trgt_train.val_ind, mesh, graphs)
        seconds = {"train": t_train, "epoch": time.perf_counter() - t0}
        io.cprint(
            f"Val - epoch {epoch}: src acc {src_val['acc']:.4f} "
            f"(bal {src_val['balanced_acc']:.4f}, loss {src_val['loss']:.4f}), "
            f"trgt acc {trgt_val['acc']:.4f} (loss {trgt_val['loss']:.4f})")
        io.log_metrics({
            "epoch": epoch, "seconds": seconds, "step_graphs": step_graphs,
            "train": meters.averages(),
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
                     cfg.num_class, mesh=mesh, graphs=graphs)
    io.cprint(f"target test accuracy: {final['acc']:.4f}, "
              f"target test loss: {final['loss']:.4f}")
    io.cprint("Test confusion matrix:\n" + str(final["conf_mat"]))
    io.save_conf_mat(final["conf_mat"], "test_conf_mat.csv", "Target",
                     class_names=[idx_to_label.get(i, str(i))
                                  for i in range(cfg.num_class)])
    return model, {"best": best, "test": final}
