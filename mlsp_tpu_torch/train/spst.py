"""SPST: self-paced self-training on pseudo-labels (counterpart of
`mlsp_tpu/train/spst.py`, the reference's `PointDA/train_spst.py`).

Load a pretrained PointDA model (a checkpoint of this package, a JAX
`.ckpt`, or with `from_torch` a reference `model.pt`), then for
each round select the target clouds the model is confident about (the
entropy of softmax(softmax(logits)) below `threshold`, the reference's
double-softmax `select_target_by_conf_v2`, `:239-281`, or the max-prob
above it, `:284-313`), and fine-tune on them with their predicted labels
(weight `spl_weight`) beside the source classification (weight
`cls_weight`, or PCM mixup), both weights falling by
`weight_decay_per_epoch` every epoch (`:499-500`). The best model is kept
by source validation accuracy; the best target test among those is
checkpointed apart (`:524-539`).

The learning rate is set once per epoch from torch's cosine in closed
form at the global epoch `round * epochs + epoch`, unclamped, so round 2's
LR rises again (`train.state.torch_cosine_lr`). An epoch's steps run in
chunks of `scan_steps`, the rest as one shorter chunk, as the JAX
package's scan and jitted single steps do (`spst_train_scan`: on the card
every step a replay of one captured step graph, whose loss weights are
0-d tensors on the card); the selection and every evaluation go through
the scanned eval (`pointda_trainer.eval_logits`). One capture serves a
run: the selection changes the number of steps, not their shapes.

Randomness: one numpy generator from `seed` shuffles the target and then
the source batches of every epoch (the JAX trainer's order); the step
draws and dropout come from a `torch.Generator` per global epoch.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import torch

from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.data.pipeline import batch_indices
from mlsp_tpu_torch.data.pointda import load_pointda
from mlsp_tpu_torch.models import (
    POINTDA_MODELS,
    canonical_name,
    make_model,
    model_kwargs,
)
from mlsp_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    all_reduce_grads,
    average_metrics,
    data_parallel,
    points_sharding,
    replicate_for_mesh,
    shard_batch,
)
from mlsp_tpu_torch.train.graphs import Graphs
from mlsp_tpu_torch.train.guard import check_finite_losses
from mlsp_tpu_torch.train.pointda_trainer import (
    eval_batches,
    eval_logits,
    evaluate,
    fetch_metrics,
    graphs_route,
    log_edge_routes,
    seed_epoch,
    train_epoch,
)
from mlsp_tpu_torch.train.state import (
    make_epoch_lr_optimizer,
    set_learning_rate,
    torch_cosine_lr,
)
from mlsp_tpu_torch.train.steps import (
    augment_batch,
    check_generator,
    draw_augment,
    draw_pcm,
    pcm_mix,
    run_chunk,
)
from mlsp_tpu_torch.transforms import augment
from mlsp_tpu_torch.utils import checkpoint, metrics
from mlsp_tpu_torch.utils.average_meter import MeterDict
from mlsp_tpu_torch.utils.config import SPSTConfig
from mlsp_tpu_torch.utils.device import resolve_device
from mlsp_tpu_torch.utils.logging import IOStream


def check_spst(cfg: SPSTConfig) -> None:
    """Raise ValueError for a model that is not a PointDA classifier. SPST
    trains the classifier alone, so every PointDA family qualifies,
    PointNet++ and Point-ViT too."""
    if canonical_name(cfg.model) not in POINTDA_MODELS:
        raise ValueError(f"SPST with model={cfg.model!r}: not a PointDA "
                         f"classifier (one of {POINTDA_MODELS})")


def draw_spst(generator: torch.Generator, t_x: torch.Tensor,
              s_x: torch.Tensor, s_y: torch.Tensor, cfg) -> dict:
    """The step's random transforms, in the JAX step's order: the target's
    rotation about z (no jitter: the pseudo-labelled loader's
    `DataLoad.__getitem__`, `train_spst.py:333-338`), the source's loader
    augmentation (rotation + jitter), then PCM on the source. Returns the
    `draws` of `spst_losses`."""
    g = generator
    rot = augment.axis_rotation(augment.draw_rotation(g, t_x.shape[0]), "z")
    draws = {"t_x": augment.rotate(t_x, rot),
             "s_x": augment_batch(s_x, *draw_augment(g, s_x))}
    if cfg.apply_PCM:
        pcm = draw_pcm(g, s_x.shape[0], s_x.shape[1], cfg.mixup_params)
        draws["mixed"], (draws["ya"], draws["yb"], draws["lam"]) = pcm_mix(
            draws["s_x"], s_y, pcm, cfg.knn_backend)
    return draws


def spst_losses(model, cfg, draws: dict, t_y: torch.Tensor,
                s_y: torch.Tensor, spl_weight: float, cls_weight: float,
                generator: torch.Generator | None):
    """Total loss and its terms for one SPST iteration
    (`train_spst.py:472-498`), from given draws: the target CE weighted by
    `spl_weight`, then the source term, PCM mixup (weighted by
    1 - DefRec_weight and NOT by `cls_weight`, as the reference and the
    JAX package have it) or `cls_weight` times the CE. Train-mode BN; the
    running statistics carry from the target forward to the source one.
    Only the classifier is read: the SSL heads keep grad None. Inside
    `parallel.data_parallel` the draws and labels are the global batch's
    and the forwards take this rank's rows."""
    model.train()
    m = {}
    draws, t_y, s_y = shard_batch(active_mesh(), (draws, t_y, s_y))
    logits = model(draws["t_x"], (), generator)["cls"]
    m["trgt_cls"] = spl_weight * L.cross_entropy(logits, t_y)
    if cfg.apply_PCM:
        logits = model(draws["mixed"], (), generator)["cls"]
        m["src_mixup"] = L.mixup_cross_entropy(
            logits, draws["ya"], draws["yb"], draws["lam"], cfg.DefRec_weight)
        src = m["src_mixup"]
    else:
        logits = model(draws["s_x"], (), generator)["cls"]
        m["src_cls"] = cls_weight * L.cross_entropy(logits, s_y)
        src = m["src_cls"]
    m["total"] = m["trgt_cls"] + src
    return m["total"], m


def spst_train_step(model, opt, t_x, t_y, s_x, s_y, spl_weight: float,
                    cls_weight: float, generator: torch.Generator,
                    cfg, mesh=None) -> dict:
    """One SPST iteration: draw, transform, forward, one backward and one
    optimizer step (the LR is the epoch's, `set_learning_rate`).

    Args:
      model: a port PointDA model, on the data's device.
      opt: from `train.state.make_epoch_lr_optimizer`.
      t_x, s_x: [B, N, 3] float32 clouds (pseudo-labelled target, source);
        t_y, s_y: [B] int64 labels.
      spl_weight, cls_weight: the epoch's loss weights.
      generator: a `torch.Generator` on the data's device.
      cfg: `utils.config.SPSTConfig`.
      mesh: a `parallel.Mesh` to take the step as one of its ranks (the
        batch is the global one, the same on every rank; the draws and
        PCM run on it, the forwards on the rank's rows).

    Returns:
      The loss terms (detached 0-d tensors, still on the device; with a
      mesh, the ranks' average).
    """
    check_generator(generator, t_x)
    draws = draw_spst(generator, t_x, s_x, s_y, cfg)
    opt.zero_grad(set_to_none=True)
    with data_parallel(mesh):
        total, m = spst_losses(model, cfg, draws, t_y, s_y, spl_weight,
                               cls_weight, generator)
        total.backward()
    all_reduce_grads(model, mesh)
    opt.step()
    return average_metrics({name: t.detach() for name, t in m.items()}, mesh)


def spst_train_scan(model, opt, t_xs, t_ys, s_xs, s_ys, spl_weight,
                    cls_weight, generator: torch.Generator, cfg,
                    graphs: Graphs | None = None, mesh=None) -> dict:
    """S SPST iterations (`mlsp_tpu/train/spst.py::spst_train_scan`; see
    `steps.pointda_train_scan`): t_xs, s_xs [S, B, N, 3], t_ys, s_ys
    [S, B]; the epoch's weights, held on the card as 0-d float32 tensors
    that the step graph reads. Returns the loss terms stacked over S."""
    check_generator(generator, t_xs)
    weights = tuple(torch.full((), float(w), device=t_xs.device)
                    for w in (spl_weight, cls_weight))

    def step(tx, ty, sx, sy, spl, cls):
        return spst_train_step(model, opt, tx, ty, sx, sy, spl, cls,
                               generator, cfg, mesh)

    def eager(tx, ty, sx, sy):
        return spst_train_step(model, opt, tx, ty, sx, sy, spl_weight,
                               cls_weight, generator, cfg, mesh)

    return run_chunk("spst", step, eager, (t_xs, t_ys, s_xs, s_ys), weights,
                     model, opt, None, generator, cfg, graphs, mesh)


def select_pseudo_labels(model, data, label: np.ndarray,
                         indices: np.ndarray, batch_size: int,
                         threshold: float, use_entropy: bool, io: IOStream,
                         epoch: int, mesh: Mesh | None = None,
                         graphs: Graphs | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Confidence-gated target selection (`train_spst.py:239-313`).

    Eval-mode forwards of `data[indices]` at `batch_size`, the trailing
    batch padded as `evaluate` pads it; kept where the entropy of
    softmax(softmax(logits)) is below `threshold` (the reference's double
    softmax, `:258`), or with `use_entropy=False` where the max-prob is
    above it. The gate runs in numpy on the fetched logits, as the JAX
    package's does. With a mesh the forwards are split over the ranks and
    every rank selects the same clouds (`eval_logits`).

    Returns (the kept clouds as they are in `data`, unaugmented, on the
    data's device [M, N, 3]; their predicted labels, int64 [M] on the same
    device)."""
    label = np.asarray(label)
    data = torch.as_tensor(data, device=next(model.parameters()).device)
    sels, counts = eval_batches(label.shape[0], batch_size, indices)
    keep_idx, plabels, tlabels = [], [], []
    if sels:
        for logits, sel, n in zip(eval_logits(model, data, sels, mesh=mesh,
                                              graphs=graphs), sels, counts):
            conf = metrics.softmax_np(logits[:n])
            pred = conf.argmax(-1)
            if use_entropy:
                ent = -(conf * metrics.log_softmax_np(conf)).sum(-1)
                keep = ent < threshold
            else:
                keep = conf.max(-1) > threshold
            keep_idx.append(sel[:n][keep])
            plabels.append(pred[keep])
            tlabels.append(label[sel[:n]][keep])
    keep_idx = np.concatenate(keep_idx) if keep_idx else np.zeros(0, np.int64)
    plabels = (np.concatenate(plabels) if plabels
               else np.zeros(0, np.int64)).astype(np.int64)
    if len(plabels):
        io.print_progress("pseudo_label", "for_train", epoch, None,
                          np.concatenate(tlabels), plabels)
    io.cprint(f"pseudo label selection: {len(plabels)}/{len(indices)}")
    sel = torch.from_numpy(keep_idx.astype(np.int64)).to(data.device)
    return data[sel], torch.from_numpy(plabels).to(data.device)


def epoch_pairs(n_selected: int, src, batch_size: int,
                rng: np.random.Generator
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The epoch's (selected target, source) batch indices: the selection
    shuffled by `rng` first, then the source train split, full batches
    only, zipped to the shorter (the JAX trainer's order)."""
    return list(zip(
        batch_indices(n_selected, batch_size, shuffle=True, drop_last=True,
                      rng=rng),
        batch_indices(len(src), batch_size, indices=src.train_ind,
                      shuffle=True, drop_last=True, rng=rng)))


def train_spst(cfg: SPSTConfig, io: IOStream | None = None,
               mesh: Mesh | None = None):
    """SPST fine-tuning; returns (model with the best epoch's weights,
    results dict with "initial", "final", "spl_weight", "cls_weight" and
    "best"). With `mesh`, data-parallel as `pointda_trainer.train_pointda`;
    the selection is the same on every rank."""
    check_spst(cfg)
    device = resolve_device(cfg.device or None)
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    io.cprint(str(cfg))
    rng = np.random.default_rng(cfg.seed)

    def load(name, partition):
        return load_pointda(name, cfg.dataroot, partition, cfg.num_points,
                            cfg.synthetic, cfg.seed, device=device)

    src_train = load(cfg.src_dataset, "train")
    trgt_train = load(cfg.trgt_dataset, "train")
    trgt_test = load(cfg.trgt_dataset, "test")
    src_x, trgt_x, test_x = (torch.from_numpy(d.data).to(device)
                             for d in (src_train, trgt_train, trgt_test))
    src_y = torch.from_numpy(src_train.label).to(device)

    # Every head is built, for checkpoint compatibility with the pretrain
    # stage; the SPST loss reads the classifier only, so the SSL heads keep
    # grad None and the optimizer leaves them as loaded.
    model = make_model(cfg.model, cfg.num_class, device=device,
                       generator=torch.Generator().manual_seed(cfg.seed),
                       **model_kwargs(cfg))
    if cfg.model_file:
        # weights only: the pretrain stage's optimizer is not SPST's
        checkpoint.load_model_weights(model, cfg.model_file, cfg.from_torch)
        io.cprint(f"loaded pretrained model from {cfg.model_file}"
                  + (" (reference torch state_dict)" if cfg.from_torch
                     else ""))
    replicate_for_mesh(mesh, model, cfg.batch_size)
    opt = make_epoch_lr_optimizer(model, cfg.optimizer, cfg.lr, cfg.wd,
                                  cfg.momentum)
    log_edge_routes(model, src_x.shape[1], device, io)
    step_graphs, graphs = graphs_route(cfg, device, mesh, io)
    gen = torch.Generator(device=device)

    def evaluate_on(x, label, indices=None):
        return evaluate(model, x, label, cfg.test_batch_size, cfg.num_class,
                        indices, mesh, graphs)

    initial = evaluate_on(test_x, trgt_test.label)
    io.cprint(f"initial target test accuracy: {initial['acc']:.4f}")

    B = cfg.batch_size
    spl_weight, cls_weight = cfg.spl_weight, cfg.cls_weight
    # A copy, not the live state_dict: its tensors would go on training.
    best = {"src_val_acc": 0.0, "trgt_test_acc": 0.0, "epoch": -1,
            "weights": copy.deepcopy(model.state_dict())}
    curves = {"src_val_acc": [], "src_val_loss": [],
              "trgt_val_acc": [], "trgt_val_loss": []}

    io.trim_metrics(0)  # a fresh run: empty a reused directory's records
    for rnd in range(cfg.rounds):
        pcs, plabels = select_pseudo_labels(
            model, trgt_x, trgt_train.label, trgt_train.train_ind,
            cfg.test_batch_size, cfg.threshold, cfg.use_entropy_selection,
            io, rnd, mesh, graphs)
        if len(pcs) < B:
            # A degenerate round: fewer confident clouds than one batch.
            # The reference would step its epoch loop with no batch and
            # crash on the empty loss average (`train_spst.py:493-505`);
            # the JAX package skips the round's epochs but still applies
            # their weight decay. The LR needs nothing: it is indexed by
            # the global epoch.
            io.cprint(f"round {rnd}: only {len(pcs)} confident samples "
                      f"(< batch_size {B}); skipping train steps, advancing "
                      f"spl/cls weight decay")
            spl_weight -= cfg.weight_decay_per_epoch * cfg.epochs
            cls_weight -= cfg.weight_decay_per_epoch * cfg.epochs
            continue
        for epoch in range(cfg.epochs):
            global_epoch = rnd * cfg.epochs + epoch
            t0 = time.perf_counter()
            lr = torch_cosine_lr(cfg.lr, cfg.epochs, global_epoch)
            set_learning_rate(opt, lr)
            io.cprint(f"spl_weight: {spl_weight:.4f}, cls_weight: "
                      f"{cls_weight:.4f}, lr: {lr:.6f}")
            with torch.profiler.record_function(f"mlsp/spst epoch "
                                                f"{global_epoch}"):
                pairs = epoch_pairs(len(pcs), src_train, B, rng)
                seed_epoch(gen, cfg.seed, global_epoch)
                steps = []
                if pairs:
                    sel = torch.from_numpy(np.asarray(pairs)).to(device)
                    weights = (spl_weight, cls_weight)
                    with points_sharding(mesh):
                        steps = train_epoch(  # sel: [P, 2, B], (trgt, src)
                            sel,
                            lambda t, s: (pcs[t], plabels[t], src_x[s],
                                          src_y[s]),
                            lambda *chunk: spst_train_scan(
                                model, opt, *chunk, *weights, gen, cfg,
                                graphs, mesh),
                            cfg.scan_steps)
                meters = MeterDict()
                for m in fetch_metrics(steps):
                    meters.update(m, n=B)
                t_train = time.perf_counter() - t0
            spl_weight -= cfg.weight_decay_per_epoch
            cls_weight -= cfg.weight_decay_per_epoch
            io.print_progress("SPST", "Trn", global_epoch, meters.averages())
            check_finite_losses(meters.averages(), model, opt, None,
                                global_epoch, io)

            src_val = evaluate_on(src_x, src_train.label, src_train.val_ind)
            trgt_val = evaluate_on(trgt_x, trgt_train.label,
                                   trgt_train.val_ind)
            trgt_tst = evaluate_on(test_x, trgt_test.label)
            for name, v in (("src_val_acc", src_val["acc"]),
                            ("src_val_loss", src_val["loss"]),
                            ("trgt_val_acc", trgt_val["acc"]),
                            ("trgt_val_loss", trgt_val["loss"])):
                curves[name].append(v)
            if io.primary:
                with open(os.path.join(io.path, "finetune_convergence.json"),
                          "w") as f:
                    json.dump(curves, f)
            io.log_metrics({
                "round": rnd, "epoch": global_epoch, "lr": lr,
                "step_graphs": step_graphs,
                "spl_weight": spl_weight, "cls_weight": cls_weight,
                "seconds": {"train": t_train,
                            "epoch": time.perf_counter() - t0},
                "train": meters.averages(),
                "src_val": {"acc": src_val["acc"], "loss": src_val["loss"]},
                "trgt_val": {"acc": trgt_val["acc"],
                             "loss": trgt_val["loss"]},
                "trgt_test": {"acc": trgt_tst["acc"],
                              "loss": trgt_tst["loss"]},
            })

            if src_val["acc"] > best["src_val_acc"]:
                best.update(src_val_acc=src_val["acc"], epoch=global_epoch,
                            weights=copy.deepcopy(model.state_dict()))
                checkpoint.save_train_state(
                    os.path.join(io.path, "model.ckpt"), model, opt, None,
                    global_epoch, {"src_val_acc": src_val["acc"]})
                io.cprint(
                    f"== Best val model at epoch {global_epoch}: src val "
                    f"{src_val['acc']:.4f}, trgt test {trgt_tst['acc']:.4f}")
                if trgt_tst["acc"] > best["trgt_test_acc"]:
                    best["trgt_test_acc"] = trgt_tst["acc"]
                    checkpoint.save_train_state(
                        os.path.join(io.path, "best_model.ckpt"), model, opt,
                        None, global_epoch,
                        {"trgt_test_acc": trgt_tst["acc"]})

    model.load_state_dict(best.pop("weights"))
    final = evaluate_on(test_x, trgt_test.label)
    io.cprint(f"target test accuracy: {final['acc']:.4f}")
    return model, {"initial": initial, "final": final,
                   "spl_weight": spl_weight, "cls_weight": cls_weight,
                   "best": best}
