"""The PointSegDA train iteration (counterpart of
`mlsp_tpu/train/seg_steps.py`, one iteration of `PointSegDA/trainer.py:
292-437`): augmentation, the source segmentation cross-entropy (on
PCM-mixed clouds and labels with `apply_PCM`), and the target branches:
DefRec, normals, density, and the combined DefRec + normal + density
forward on the deformed cloud (`Density_normal_viainput`), then one
backward and one optimizer update.

Against the PointDA step, per the reference: the CE is per point over 8
part classes, the deformed points' weight is mask + 1 (not mask·26 + 1,
`trainer.py:409-412`), and the density labels take `shift` (10) and
pergroup 5. As in `train.steps`, every random number is drawn first
(`pointsegda_train_step`) and `pointsegda_losses` takes the transformed
clouds as inputs, so a test can feed it the JAX step's own.

Fused dispatch as `train.steps`: `pointsegda_train_scan` takes S steps as
S replays of one captured graph on the card, eagerly on the CPU;
`seg_eval_scan` is the scanned eval forward.

Data-parallel (`mesh=`) as `train.steps`: the draws, PCM and the labels on
the global batch, the forwards and losses on the rank's rows, the
gradients and loss terms averaged over the ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.models import SEG_MODELS, canonical_name
from mlsp_tpu_torch.ops.density import density_labels
from mlsp_tpu_torch.ops.normals import estimate_normals
from mlsp_tpu_torch.parallel.mesh import (
    active_mesh,
    all_reduce_grads,
    average_metrics,
    data_parallel,
    fetch_global,
    shard_batch,
)
from mlsp_tpu_torch.train.graphs import Graphs
from mlsp_tpu_torch.train.steps import (
    augment_batch,
    check_generator,
    deform_dispatch,
    draw_augment,
    draw_deform_dispatch,
    draw_pcm,
    eval_scan,
    pcm_mix_segmentation,
    run_chunk,
)


def check_seg_recipe(cfg) -> None:
    """Raise ValueError for a model that is not a segmenter."""
    if canonical_name(cfg.model) not in SEG_MODELS:
        raise ValueError(f"model={cfg.model!r} is not a PointSegDA "
                         f"segmenter (one of {SEG_MODELS})")


def seg_cross_entropy(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean per-point CE of logits [B, N, C] and labels [B, N]."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def _normals(cfg, x):
    """The normal labels of the global clouds x, this rank's rows."""
    return shard_batch(active_mesh(), estimate_normals(
        x, cfg.near, backend=cfg.knn_backend))


def _density(cfg, x):
    """The density labels of the global clouds x, this rank's rows."""
    return shard_batch(active_mesh(), density_labels(
        x, cfg.density_radius, cfg.density_num_class, cfg.pergroup,
        cfg.shift))


def pointsegda_losses(model, cfg, batch: dict, draws: dict,
                      generator: torch.Generator | None):
    """Total loss, its terms and the train predictions for one iteration,
    from given draws.

    Args:
      model: a port segmenter (`check_seg_recipe`), put in train mode
        here. Its forwards run in the JAX step's order, so the BN running
        statistics carry from one to the next.
      cfg: `utils.config.PointSegDAConfig` (resolved).
      batch: "src_x" [B, N, 3], "src_y" [B, N] and "trgt_x" (the augmented
        clouds).
      draws: the random transforms' outputs: "mixed", "mixed_y" (PCM);
        "dx", "dmask" (the deformed target of DefRec_on_trgt); "dx_via",
        "dmask_via" (that of the combined branch).
      generator: for the dropout masks.

    Inside `parallel.data_parallel` the batch and draws are the global
    batch's; the labels are computed on it, the forwards, losses and
    predictions take this rank's rows.

    Returns:
      (total, metrics, (preds, labels)): the scalar loss, its terms named
      as the JAX step's metrics, and the source forward's per-point argmax
      [B, N] with the labels it is scored against (the mixed ones with
      PCM), both detached on the data's device.
    """
    check_seg_recipe(cfg)
    model.train()
    m = {}
    trgt_g = batch["trgt_x"]  # the labels come from the global clouds
    batch, draws = shard_batch(active_mesh(), (batch, draws))
    sx, sy = batch["src_x"], batch["src_y"]
    if cfg.apply_PCM:
        sx, sy = draws["mixed"], draws["mixed_y"]
    logits = model(sx, ("seg",), generator)["seg"]
    total = (1.0 - cfg.DefRec_weight) * seg_cross_entropy(logits, sy)
    m["src_seg"] = total
    preds = logits.detach().argmax(-1)

    # The labels are computed in each branch that reads them, as the JAX
    # step does, so the kNN graphs come in its order.
    trgt = batch["trgt_x"]
    C = cfg.density_num_class

    if cfg.DefRec_on_trgt:
        out = model(draws["dx"], ("defrec",), generator)
        l = L.defrec_loss(out["defrec"], trgt, draws["dmask"],
                          cfg.DefRec_weight)
        m["trgt_DefRec"] = l
        total = total + l

    if cfg.Norm_on_trgt:
        n_gt = _normals(cfg, trgt_g)
        out = model(trgt, ("normal",), generator)
        l = L.normal_loss(out["normal"], n_gt, cfg.normal_pred_weight)
        m["trgt_Normal"] = l
        total = total + l

    if cfg.Density_on_trgt:
        dvec, dval = _density(cfg, trgt_g)
        out = model(trgt, ("density",), generator)
        kl, mae = L.density_loss(
            out["density"].reshape(-1, C), out["density_mse"].reshape(-1),
            dvec.reshape(-1, C), dval.reshape(-1), cfg.Density_weight)
        m["trgt_Density_cls"], m["trgt_Density_mse"] = kl, mae
        total = total + kl + mae

    if cfg.Density_normal_viainput:
        n_gt, (dvec, dval) = _normals(cfg, trgt_g), _density(cfg, trgt_g)
        mask = draws["dmask_via"]
        out = model(draws["dx_via"], ("defrec", "normal", "density"),
                    generator)
        l = L.defrec_loss(out["defrec"], trgt, mask, cfg.DefRec_weight)
        m["trgt_DefRec"] = m.get("trgt_DefRec", 0.0) + l
        total = total + l
        w = L.region_weights(mask, cfg.Density_normal_defpart, boost=1.0)
        if cfg.Normal_ondef:
            nl = L.masked_normal_loss(out["normal"], n_gt, w,
                                      cfg.normal_pred_weight)
            m["trgt_def_normal"] = nl
            total = total + nl
        if cfg.Density_ondef:
            kl, mae = L.density_loss(
                out["density"].reshape(-1, C), out["density_mse"].reshape(-1),
                dvec.reshape(-1, C), dval.reshape(-1), cfg.Density_weight,
                mask=w.reshape(-1))
            m["trgt_def_density_cls"], m["trgt_def_density_mse"] = kl, mae
            total = total + kl + mae
    m["total"] = total
    return total, m, (preds, sy.detach())


def pointsegda_step(model, opt, src_x, src_y, trgt_x,
                    generator: torch.Generator, cfg, mesh=None):
    """`pointsegda_train_step` without the scheduler step: what a step
    graph captures."""
    check_seg_recipe(cfg)
    check_generator(generator, src_x)
    g = generator
    src = augment_batch(src_x, *draw_augment(g, src_x))
    trgt = augment_batch(trgt_x, *draw_augment(g, trgt_x))
    draws = {}
    if cfg.apply_PCM:
        pcm = draw_pcm(g, src.shape[0], src.shape[1], cfg.mixup_params)
        draws["mixed"], draws["mixed_y"] = pcm_mix_segmentation(
            src, src_y, pcm, cfg.knn_backend)
    if cfg.DefRec_on_trgt:
        draws["dx"], draws["dmask"] = deform_dispatch(
            trgt, draw_deform_dispatch(g, trgt, cfg), cfg)
    if cfg.Density_normal_viainput:
        draws["dx_via"], draws["dmask_via"] = deform_dispatch(
            trgt, draw_deform_dispatch(g, trgt, cfg), cfg)

    opt.zero_grad(set_to_none=True)
    with data_parallel(mesh):
        total, m, preds = pointsegda_losses(
            model, cfg, {"src_x": src, "src_y": src_y, "trgt_x": trgt}, draws,
            g)
        total.backward()
    all_reduce_grads(model, mesh)
    opt.step()
    m = average_metrics({name: t.detach() for name, t in m.items()}, mesh)
    return m, tuple(fetch_global(t, mesh) for t in preds)


def pointsegda_train_step(model, opt, sched, src_x, src_y, trgt_x,
                          generator: torch.Generator, cfg, mesh=None):
    """One PointSegDA train iteration: draw, transform, forward, one
    backward, one optimizer step and one scheduler step.

    Args:
      model: a port segmenter, on the data's device.
      opt, sched: from `train.state.make_optimizer`.
      src_x, trgt_x: [B, N, 3] float32 clouds; src_y: [B, N] int64 labels.
      generator: a `torch.Generator` on the data's device.
      cfg: `utils.config.PointSegDAConfig` (resolved).
      mesh: a `parallel.Mesh` to take the step as one of its ranks (the
        batch is the global one, the same on every rank).

    Returns:
      (losses, (preds, labels)): the loss terms as detached 0-d tensors
      and the source forward's predictions with their labels [B, N], all
      still on the device; with a mesh, the ranks' average terms and the
      global batch's predictions.
    """
    out = pointsegda_step(model, opt, src_x, src_y, trgt_x, generator, cfg,
                          mesh)
    sched.step()
    return out


def pointsegda_train_scan(model, opt, sched, src_xs, src_ys, trgt_xs,
                          generator: torch.Generator, cfg,
                          graphs: Graphs | None = None, mesh=None):
    """S PointSegDA train iterations (`mlsp_tpu/train/seg_steps.py::
    pointsegda_train_scan`; see `steps.pointda_train_scan`): src_xs,
    trgt_xs [S, B, N, 3], src_ys [S, B, N]. Returns (losses stacked over
    S, (preds [S, B, N], labels [S, B, N]))."""
    check_seg_recipe(cfg)
    check_generator(generator, src_xs)

    def step(sx, sy, tx):
        return pointsegda_step(model, opt, sx, sy, tx, generator, cfg, mesh)

    def eager(sx, sy, tx):
        return pointsegda_train_step(model, opt, sched, sx, sy, tx,
                                     generator, cfg, mesh)

    return run_chunk("pointsegda", step, eager, (src_xs, src_ys, trgt_xs),
                     (), model, opt, sched, generator, cfg, graphs, mesh)


def seg_eval_scan(model, xs: torch.Tensor,
                  graphs: Graphs | None = None) -> torch.Tensor:
    """Scanned seg eval: xs [S, B, N, 3] -> per-point logits [S, B, N, C]
    (`steps.eval_scan` on the "seg" output)."""
    return eval_scan(model, xs, graphs, output="seg")
