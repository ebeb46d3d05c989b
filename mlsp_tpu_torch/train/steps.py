"""The PointDA train iteration (counterpart of `mlsp_tpu/train/steps.py`).

One `pointda_train_step` is one iteration of the reference trainer
(`PointDA/trainer.py:374-571`) under any recipe of `PointDAConfig`:
augmentation, then the source forwards (DefRec on the source, the PCM
mixup through FPS or the plain classification, the source-side DefRec +
normal + density forward), the target's self-supervised forwards (DefRec,
normals, scan reconstruction, density, the DefRec + normal + density
forward with its labels on the input or carried by the Chamfer nearest
indices) and inline self-paced pseudo-labels, one backward and one
optimizer update. The forwards run in the JAX step's order: train-mode BN
running statistics carry from one to the next.

Randomness comes from one explicit `torch.Generator` (on the data's
device): the step draws every random number first (`draw_*`, each branch
in the JAX step's order), and `pointda_losses` takes the transformed
arrays as inputs, as the JAX step's `debug_aux` returns them, so a test
can feed it the JAX step's own. Every PointDA family runs
(`check_recipe`).

Fused dispatch (`pointda_train_scan`, the JAX package's scan and its
jitted single step): r steps on stacked batches, on the card as r
replays of one captured CUDA graph of the step (`train.graphs`; under an
NCCL mesh with its collectives), on the CPU and under a gloo mesh as r
eager steps; the eval forward likewise (`eval_scan`, `scan_in_chunks`).
A replay takes the step an eager `pointda_train_step` takes from the
same state.

Data-parallel (`mesh=`, see `parallel.mesh`): every rank takes the global
batch and the same generator, so the draws, augmentation, PCM (one FPS on
[2B, N]: a cloud's partner may be another rank's row), the deformations
and the normal and density labels are the single process's; each forward
then takes the rank's rows, the gradients are averaged over the ranks in
one all-reduce before the update, and the returned loss terms are the
ranks' average.
"""

from __future__ import annotations

import numpy as np
import torch

from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.models import POINTDA_MODELS, canonical_name
from mlsp_tpu_torch.ops.chamfer import nearest_index_pair
from mlsp_tpu_torch.ops.density import density_labels
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.normals import estimate_normals
from mlsp_tpu_torch.parallel.mesh import (
    active_mesh,
    all_reduce_grads,
    average_metrics,
    captures,
    data_parallel,
    global_count,
    points_sharding,
    shard_batch,
)
from mlsp_tpu_torch.train.graphs import Graphs, stack_steps
from mlsp_tpu_torch.transforms import augment, deform
from mlsp_tpu_torch.transforms.scan import draw_scan, scan_batch

SSL_HEADS = ("defrec", "normal", "density")


def check_recipe(cfg) -> None:
    """Raise ValueError for a model that is not a PointDA classifier, and
    for PointNet++ under a DefRec branch: it has no DefRec head (the JAX
    step fails mid-trace on the missing output; the port refuses first)."""
    name = canonical_name(cfg.model)
    if name not in POINTDA_MODELS:
        raise ValueError(f"model={cfg.model!r} is not a PointDA classifier "
                         f"(one of {POINTDA_MODELS})")
    if name == "pointnet2" and (cfg.DefRec_on_src or cfg.DefRec_on_trgt):
        raise ValueError("model='pointnet2' has no DefRec head: train it "
                         "with PCM or the source classifier alone")


def augment_batch(x: torch.Tensor, rotation: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """Loader-side train augmentation (`dataloader.py:92-93`): rotation
    [B, 3, 3] (about z, from `draw_augment`), then clipped jitter."""
    return augment.jitter(augment.rotate(x, rotation), noise)


def draw_augment(generator: torch.Generator, x: torch.Tensor):
    """(rotation matrices about z [B, 3, 3], jitter noise [B, N, 3])."""
    angles = augment.draw_rotation(generator, x.shape[0])
    return (augment.axis_rotation(angles, "z"),
            augment.draw_jitter(generator, x.shape))


def deform_dispatch(x: torch.Tensor, draws, cfg):
    """`DefRec_dist` dispatch (`MLSP/mlsp.py:33-46`): collapse a radius
    ball for 'volume_based_radius', a populated voxel otherwise. Returns
    (deformed [B, N, 3], mask [B, N])."""
    if cfg.DefRec_dist == "volume_based_radius":
        return deform.collapse_to_point_batch(x, *draws)
    return deform.deform_batch(x, *draws, n=cfg.num_regions)


def draw_deform_dispatch(generator: torch.Generator, x: torch.Tensor, cfg):
    if cfg.DefRec_dist == "volume_based_radius":
        return deform.draw_collapse(generator, x.shape)
    return deform.draw_deform(generator, x.shape, cfg.num_regions)


def draw_mix_ratio(generator: torch.Generator, a: float,
                   shape: tuple = ()) -> torch.Tensor:
    """PCM's mixing ratios λ ~ Beta(a, a) [shape] float32, drawn on the
    generator's device with nothing read back to the host, so that a step
    graph holds the draw.

    a = 1 (the paper recipe): Beta(1, 1) is uniform on [0, 1), one
    `torch.rand`. a <= 0: λ = 1, no draw. Any other a > 0: two gammas
    G(a) combined in log space as `jax.random.beta` combines them, λ =
    G₁ / (G₁ + G₂), each log G(a) = log G(a + 1) + log(U) / a (the gamma
    from `torch._standard_gamma`, U in (0, 1] from `torch.rand`), which
    stays finite for tiny a where G(a) itself underflows; λ is then in
    [0, 1]. `torch.distributions.Beta` takes no generator."""
    g, dev = generator, generator.device
    if a == 1.0:
        return torch.rand(shape, generator=g, device=dev)
    if a <= 0:
        return torch.ones(shape, device=dev)
    alpha = torch.full((2, *shape), a + 1.0, device=dev)
    log_g = (torch._standard_gamma(alpha, generator=g).log()
             + torch.rand(alpha.shape, generator=g, device=dev).neg_()
             .log1p_().div_(a))
    e = (log_g - log_g.amax(0)).exp_()
    return e[0] / (e[0] + e[1])


def draw_pcm(generator: torch.Generator, batch: int, num_points: int,
             mixup_params: float) -> dict[str, torch.Tensor]:
    """PCM's random numbers, in this order: the batch permutation, λ ~
    Beta(a, a) (`draw_mix_ratio`, a = `mixup_params`), the two FPS start
    indices and the final point permutation. Nothing is read back to the
    host: a step graph holds them at any a."""
    g, dev = generator, generator.device
    draws = {"perm": torch.randperm(batch, generator=g, device=dev),
             "lam": draw_mix_ratio(g, mixup_params)}
    for name in ("start_a", "start_b"):
        draws[name] = torch.randint(0, num_points, (batch,), generator=g,
                                    device=dev)
    draws["points"] = torch.randperm(num_points, generator=g, device=dev)
    return draws


def pcm_mix(x: torch.Tensor, y: torch.Tensor, draws: dict,
            backend: str = "auto"):
    """PCM mixup (`MLSP/PCM.py:6-38`): FPS-sample round(λN) points of each
    cloud and N - round(λN) of a batch-permuted partner, concatenate and
    permute the points. The FPS prefix property gives every prefix length
    from one full-length order per cloud. The 2B clouds (x, then x[perm])
    go through one FPS call: each cloud's order is independent of the
    others', so this equals two calls of B.

    Returns (mixed [B, N, 3], (y, y[perm], λ))."""
    B, N, _ = x.shape
    perm, lam = draws["perm"], draws["lam"]
    num_a = torch.round(lam * N).long()
    xb = x[perm]
    order = fps(torch.cat([x, xb]), N,
                torch.cat([draws["start_a"], draws["start_b"]]), backend)
    va, vb = fps_gather(x, order[:B]), fps_gather(xb, order[B:])
    i = torch.arange(N, device=x.device)
    idx_b = torch.clamp(i - num_a, 0, N - 1)
    mixed = torch.where((i < num_a)[None, :, None], va, vb[:, idx_b])
    return mixed[:, draws["points"]], (y, y[perm], lam)


def pcm_mix_segmentation(x: torch.Tensor, y: torch.Tensor, draws: dict,
                         backend: str = "auto"):
    """Segmentation PCM (`MLSP/PCM.py:40-73`): `pcm_mix` on clouds x
    [B, N, 3] whose point labels y [B, N] move with their points; one FPS
    call on the 2B clouds, the draws of `draw_pcm`.

    Returns (mixed [B, N, 3], mixed labels [B, N])."""
    B, N, _ = x.shape
    perm, lam = draws["perm"], draws["lam"]
    num_a = torch.round(lam * N).long()
    xb, yb = x[perm], y[perm]
    order = fps(torch.cat([x, xb]), N,
                torch.cat([draws["start_a"], draws["start_b"]]), backend)
    oa, ob = order[:B], order[B:]
    va, la = fps_gather(x, oa), torch.gather(y, 1, oa)
    vb, lb = fps_gather(xb, ob), torch.gather(yb, 1, ob)
    i = torch.arange(N, device=x.device)
    idx_b = torch.clamp(i - num_a, 0, N - 1)
    take_a = i < num_a
    mixed = torch.where(take_a[None, :, None], va, vb[:, idx_b])
    mixed_y = torch.where(take_a[None, :], la, lb[:, idx_b])
    pp = draws["points"]
    return mixed[:, pp], mixed_y[:, pp]


def _ssl_recipe_losses(cfg, logits, x_orig, mask, normal_gt, dvec, dval,
                       prefix, m):
    """DefRec + normal + density on the deformed cloud
    (`PointDA/trainer.py:434-455` source, `:544-565` target). The DefRec
    term adds to one already in `m`: DefRec_on_trgt and the combined branch
    both emit `trgt_DefRec`, which the reference sums (trainer.py:471,545)."""
    total = L.defrec_loss(logits["defrec"], x_orig, mask, cfg.DefRec_weight)
    m[f"{prefix}_DefRec"] = m.get(f"{prefix}_DefRec", 0.0) + total
    w = L.region_weights(mask, cfg.Density_normal_defpart)
    if cfg.Normal_ondef:
        nl = L.masked_normal_loss(logits["normal"], normal_gt, w,
                                  cfg.normal_pred_weight)
        m[f"{prefix}_def_normal"] = nl
        total = total + nl
    if cfg.Density_ondef:
        C = cfg.density_num_class
        kl, mae = L.density_loss(
            logits["density"].reshape(-1, C),
            logits["density_mse"].reshape(-1),
            dvec.reshape(-1, C), dval.reshape(-1), cfg.Density_weight,
            mask=w.reshape(-1))
        m[f"{prefix}_def_density_cls"] = kl
        m[f"{prefix}_def_density_mse"] = mae
        total = total + kl + mae
    return total


def _chamfer_recipe_losses(cfg, logits, x_orig, mask, normal_gt, dvec, dval,
                           m):
    """`Density_normal_viachamfer` (`mlsp_tpu/train/steps.py:262-293`): the
    DefRec term, then the normal and density labels carried between the
    DefRec prediction and the original cloud by their nearest indices
    (`mlsp.findindexs` + `calc_def_*`)."""
    total = L.defrec_loss(logits["defrec"], x_orig, mask, cfg.DefRec_weight)
    m["trgt_DefRec"] = m.get("trgt_DefRec", 0.0) + total
    idx_pair = nearest_index_pair(logits["defrec"], x_orig, mask)
    w = L.region_weights(mask, cfg.Density_normal_defpart)
    if cfg.Normal_ondef:
        nl = L.transported_normal_loss(logits["normal"], normal_gt, w,
                                       idx_pair, cfg.normal_pred_weight)
        m["trgt_def_normal"] = nl
        total = total + nl
    if cfg.Density_ondef:
        kl, mae = L.transported_density_loss(
            logits["density"], logits["density_mse"], dvec, dval, w,
            idx_pair, cfg.Density_weight)
        m["trgt_def_density_cls"] = kl
        m["trgt_def_density_mse"] = mae
        total = total + kl + mae
    return total


def spl_loss(cls: torch.Tensor, cfg, m) -> torch.Tensor:
    """Inline self-paced pseudo-labels (`mlsp_tpu/train/steps.py:295-317`;
    the reference's generators, `PointDA/trainer.py:265-293`): the model's
    own argmax as the label, kept where the confidence (a softmax without
    gradient) passes the gate: max-prob > gamma, or with `apply_SPL_v2`
    the entropy of softmax(conf) < gamma_v2 (the reference's double
    softmax, trainer.py:285). NLL over the kept samples divided by
    max(#kept, 1)."""
    conf = torch.softmax(cls.detach().float(), -1)
    pseudo = conf.argmax(-1)
    if cfg.apply_SPL_v2:
        ent = -(conf * torch.log_softmax(conf, -1)).sum(-1)
        keep = (ent < cfg.gamma_v2).float()
    else:
        keep = (conf.amax(-1) > cfg.gamma).float()
    logp = torch.log_softmax(cls.float(), -1)
    nll = -torch.gather(logp, -1, pseudo[:, None])[:, 0]
    loss = (nll * keep).sum() / global_count(keep.sum(), 1.0)
    m["trgt_SPL"] = loss
    m["trgt_SPL_selected"] = keep.mean()
    return loss


def pointda_losses(model, cfg, batch: dict, draws: dict,
                   generator: torch.Generator | None):
    """Total loss and its terms for one iteration, from given draws.

    Args:
      model: a port PointDA model (`check_recipe`); put in train mode (eval-mode BN with
        `cfg.debug_bn_eval`). Its forwards run in the JAX step's order, so
        the BN running statistics carry from one to the next.
      cfg: `utils.config.PointDAConfig`.
      batch: "src_x" [B, N, 3] and "trgt_x" (the augmented clouds),
        "src_y" [B].
      draws: the random transforms' outputs, by branch: "src_dx",
        "src_dmask" (DefRec_on_src); "mixed", "ya", "yb", "lam" (PCM);
        "src_dx_via", "src_dmask_via" (Density_normal_viainput_onsrc);
        "trgt_dx", "trgt_dmask" (DefRec_on_trgt); "sx", "smask"
        (Scan_on_trgt); "dx", "dmask" (the deformed target of
        Density_normal_viainput or _viachamfer).
      generator: for the dropout masks.

    Inside `parallel.data_parallel` the batch and draws are the global
    batch's: the labels are computed on it, and the forwards and losses
    take this rank's rows.

    Returns:
      (total, metrics): the scalar loss and a dict of its terms, named as
      the JAX step's metrics.
    """
    check_recipe(cfg)
    model.train(not cfg.debug_bn_eval)
    m = {}
    mesh = active_mesh()
    # the labels come from the global clouds, the forwards take the rank's
    src_g, trgt_g = batch["src_x"], batch["trgt_x"]
    batch, draws = shard_batch(mesh, (batch, draws))
    src, trgt = batch["src_x"], batch["trgt_x"]
    C = cfg.density_num_class

    def forward(x, heads=()):
        return model(x, heads, generator)

    def normals(x):
        return shard_batch(mesh, estimate_normals(x, cfg.near,
                                                  backend=cfg.knn_backend))

    def densities(x):
        return shard_batch(mesh, density_labels(x, cfg.radius, C,
                                                cfg.pergroup))

    def labels(x):
        return normals(x), *densities(x)

    total = 0.0
    # ---- source supervised ----
    if cfg.DefRec_on_src:
        out = forward(draws["src_dx"], ("defrec",))
        m["src_DefRec"] = L.defrec_loss(out["defrec"], src, draws["src_dmask"],
                                        cfg.DefRec_weight)
        total = total + m["src_DefRec"]

    if cfg.apply_PCM:
        out = forward(draws["mixed"])
        m["src_mixup"] = L.mixup_cross_entropy(
            out["cls"], draws["ya"], draws["yb"], draws["lam"],
            cfg.DefRec_weight)
        total = total + m["src_mixup"]
    else:
        out = forward(src)
        m["src_cls"] = (1.0 - cfg.DefRec_weight) * L.cross_entropy(
            out["cls"], batch["src_y"])
        total = total + m["src_cls"]

    if cfg.Density_normal_viainput_onsrc:
        n_gt, dvec, dval = labels(src_g)
        out = forward(draws["src_dx_via"], SSL_HEADS)
        total = total + _ssl_recipe_losses(cfg, out, src,
                                           draws["src_dmask_via"], n_gt,
                                           dvec, dval, "src", m)

    # ---- target self-supervised ----
    if cfg.DefRec_on_trgt:
        out = forward(draws["trgt_dx"], ("defrec",))
        m["trgt_DefRec"] = L.defrec_loss(out["defrec"], trgt,
                                         draws["trgt_dmask"],
                                         cfg.DefRec_weight)
        total = total + m["trgt_DefRec"]

    if cfg.Norm_on_trgt:
        n_gt = normals(trgt_g)
        out = forward(trgt, ("normal",))
        m["trgt_Normal"] = L.normal_loss(out["normal"], n_gt,
                                         cfg.normal_pred_weight)
        total = total + m["trgt_Normal"]

    if cfg.Scan_on_trgt:
        out = forward(draws["sx"], ("scan",))
        m["trgt_Rec_scan"] = L.scan_rec_loss(out["scan"], trgt, draws["smask"],
                                             cfg.Scan_Rec_weight)
        total = total + m["trgt_Rec_scan"]

    if cfg.Density_on_trgt:
        dvec, dval = densities(trgt_g)
        out = forward(trgt, ("density",))
        kl, mae = L.density_loss(
            out["density"].reshape(-1, C), out["density_mse"].reshape(-1),
            dvec.reshape(-1, C), dval.reshape(-1), cfg.Density_weight)
        m["trgt_Density_cls"], m["trgt_Density_mse"] = kl, mae
        total = total + kl + mae

    # The Chamfer-transported labels are an alternative to the input ones,
    # as in the JAX step (an elif): the first flag set wins.
    if cfg.Density_normal_viainput or cfg.Density_normal_viachamfer:
        n_gt, dvec, dval = labels(trgt_g)
        out = forward(draws["dx"], SSL_HEADS)
        if cfg.Density_normal_viainput:
            total = total + _ssl_recipe_losses(cfg, out, trgt, draws["dmask"],
                                               n_gt, dvec, dval, "trgt", m)
        else:
            total = total + _chamfer_recipe_losses(
                cfg, out, trgt, draws["dmask"], n_gt, dvec, dval, m)

    if cfg.apply_SPL or cfg.apply_SPL_v2:
        total = total + spl_loss(forward(trgt)["cls"], cfg, m)

    m["total"] = total
    return total, m


def draw_step(generator: torch.Generator, src: torch.Tensor,
              src_y: torch.Tensor, trgt: torch.Tensor, cfg) -> dict:
    """Every random transform of the recipe on the augmented clouds, drawn
    branch by branch in the JAX step's order (its keys 2, 4, 6, 8, 11 and
    14): the `draws` of `pointda_losses`."""
    g = generator
    draws = {}

    def deformed(x):
        return deform_dispatch(x, draw_deform_dispatch(g, x, cfg), cfg)

    if cfg.DefRec_on_src:
        draws["src_dx"], draws["src_dmask"] = deformed(src)
    if cfg.apply_PCM:
        pcm = draw_pcm(g, src.shape[0], src.shape[1], cfg.mixup_params)
        draws["mixed"], (draws["ya"], draws["yb"], draws["lam"]) = pcm_mix(
            src, src_y, pcm, cfg.knn_backend)
    if cfg.Density_normal_viainput_onsrc:
        draws["src_dx_via"], draws["src_dmask_via"] = deformed(src)
    if cfg.DefRec_on_trgt:
        draws["trgt_dx"], draws["trgt_dmask"] = deformed(trgt)
    if cfg.Scan_on_trgt:
        draws["sx"], draws["smask"] = scan_batch(
            trgt, *draw_scan(g, trgt.shape[0]))
    if cfg.Density_normal_viainput or cfg.Density_normal_viachamfer:
        draws["dx"], draws["dmask"] = deformed(trgt)
    return draws


def check_generator(generator: torch.Generator, x: torch.Tensor) -> None:
    """Raise ValueError unless `generator` lives on x's device."""
    gdev = generator.device
    if gdev.type == "cuda" and gdev.index is None:
        gdev = torch.device("cuda", torch.cuda.current_device())
    if gdev != x.device:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"batch on {x.device}")


def pointda_step(model, opt, src_x, src_y, trgt_x,
                 generator: torch.Generator, cfg, mesh=None) -> dict:
    """`pointda_train_step` without the scheduler step: what a step graph
    captures."""
    check_recipe(cfg)
    check_generator(generator, src_x)
    g = generator
    src = augment_batch(src_x, *draw_augment(g, src_x))
    trgt = augment_batch(trgt_x, *draw_augment(g, trgt_x))
    draws = draw_step(g, src, src_y, trgt, cfg)

    opt.zero_grad(set_to_none=True)
    with data_parallel(mesh):
        total, m = pointda_losses(
            model, cfg, {"src_x": src, "src_y": src_y, "trgt_x": trgt}, draws,
            g)
        total.backward()
    all_reduce_grads(model, mesh)
    opt.step()
    return average_metrics({name: t.detach() for name, t in m.items()}, mesh)


def pointda_train_step(model, opt, sched, src_x, src_y, trgt_x,
                       generator: torch.Generator, cfg, mesh=None) -> dict:
    """One PointDA train iteration: draw, transform, forward, one backward,
    one optimizer step and one scheduler step.

    Args:
      model: a port PointDA model, on the data's device.
      opt, sched: from `train.state.make_optimizer`.
      src_x, trgt_x: [B, N, 3] float32 clouds; src_y: [B] int64 labels.
      generator: a `torch.Generator` on the data's device.
      cfg: `utils.config.PointDAConfig` (e.g. `PointDAConfig().paper_recipe`).
      mesh: a `parallel.Mesh` to take the step as one of its ranks: the
        batch is the global one, the same on every rank.

    Returns:
      The loss terms (detached 0-d tensors, still on the device; with a
      mesh, the ranks' average).
    """
    m = pointda_step(model, opt, src_x, src_y, trgt_x, generator, cfg, mesh)
    sched.step()
    return m


def replays_steps(x: torch.Tensor, mesh) -> bool:
    """Whether `run_chunk` takes the steps on `x` as replays of a step
    graph: on the card, without a mesh or with NCCL's
    (`parallel.mesh.captures`), every recipe at any `scan_steps`; on the
    CPU and under a gloo mesh, eager steps. (Patched to False, it gives
    the card's eager route, the reference that replays are held to.)"""
    return x.is_cuda and captures(mesh)


def run_chunk(kind: str, step, eager_step, inputs, consts, model, opt,
              sched, generator, cfg, graphs: Graphs | None, mesh):
    """r steps on the stacked `inputs` [r, ...]: a chunk of
    `cfg.scan_steps`, an epoch's tail of fewer, or one step. On the CPU
    and under a gloo mesh (`replays_steps`), `eager_step(*batch)` r times;
    on the card (without a mesh or with NCCL's) r replays of
    the graph of `step(*batch, *consts)` (`graphs`' own, or a new one; a
    step of a mesh holds its collectives), then r scheduler steps. The
    graph is keyed by one step's shapes and holds max(r, scan_steps)
    steps, so an epoch's chunks and its tail share one capture. The
    replays read the LR as it is: a chunk whose steps the schedule gives
    different LRs (one that crosses an epoch) raises ValueError. A capture
    that fails raises: nothing falls back to eager steps. Returns the
    outputs stacked over r."""
    r = inputs[0].shape[0]
    if not replays_steps(inputs[0], mesh):
        return stack_steps([eager_step(*batch) for batch in zip(*inputs)])
    if sched is not None and any(
            len({f(sched.last_epoch + i) for i in range(r)}) > 1
            for f in sched.lr_lambdas):
        raise ValueError(f"a chunk of {r} steps from step "
                         f"{sched.last_epoch} crosses a change of the LR "
                         "schedule; a step graph reads one LR a chunk")
    key = (kind, cfg, tuple(tuple(t.shape[1:]) for t in inputs))
    graph = (graphs or Graphs()).train_step(key, step, inputs, consts, model,
                                            opt, generator, cfg.scan_steps)
    out = graph.run(inputs, consts)
    if sched is not None:
        for _ in range(r):
            sched.step()
    return out


def pointda_train_scan(model, opt, sched, src_xs, src_ys, trgt_xs,
                       generator: torch.Generator, cfg,
                       graphs: Graphs | None = None, mesh=None) -> dict:
    """S PointDA train iterations (`mlsp_tpu/train/steps.py::
    pointda_train_scan`, and for S = 1 its jitted `pointda_train_step`):
    on the card S replays of one captured graph of the step (under an
    NCCL mesh with its collectives), on the CPU and under a gloo mesh S
    `pointda_train_step`s. The same steps either way: the draws come from
    `generator` in the same order, and the schedule's LR is the same for
    every step of a chunk (chunks end at epochs; see `run_chunk`).

    Args:
      src_xs, trgt_xs: [S, B, N, 3]; src_ys: [S, B].
      graphs: a `train.graphs.Graphs` that keeps the captured graph for
        the next chunk (without one, each call captures anew).
      The rest as `pointda_train_step`.

    Returns:
      The loss terms stacked over S (a dict of [S] tensors).
    """
    check_recipe(cfg)
    check_generator(generator, src_xs)

    def step(sx, sy, tx):
        return pointda_step(model, opt, sx, sy, tx, generator, cfg, mesh)

    def eager(sx, sy, tx):
        return pointda_train_step(model, opt, sched, sx, sy, tx, generator,
                                  cfg, mesh)

    return run_chunk("pointda", step, eager, (src_xs, src_ys, trgt_xs), (),
                     model, opt, sched, generator, cfg, graphs, mesh)


# Batches per eval/selection dispatch (`mlsp_tpu/train/steps.py`): bounds
# the staged input to chunk x B x N x 3 floats on the device; one eval
# graph of that many batches serves a split, its remainder too.
EVAL_SCAN_CHUNK = 64


def eval_scan(model, xs: torch.Tensor, graphs: Graphs | None = None,
              output: str = "cls", mesh=None) -> torch.Tensor:
    """Scanned eval: xs [S, B, N, 3] -> the model's `output` [S, B, ...]
    ("cls" logits [S, B, C]) in eval mode (running BN statistics, no
    dropout); on the card, without a mesh or as a rank of an NCCL one
    (`parallel.mesh.captures`), one replay of a captured eval forward per
    batch; on the CPU and under a gloo mesh a loop of forwards. With a
    mesh, xs are the rank's rows, forwarded under `points_sharding(mesh)`
    (a points axis's gathers inside the graph). The model's mode is
    restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(), points_sharding(mesh):
            def forward(x):
                return model(x)[output]

            if not xs.is_cuda or not captures(mesh):
                return torch.stack([forward(x) for x in xs])
            graph = (graphs or Graphs()).eval_forward(
                model, output, forward, xs[0],
                max(EVAL_SCAN_CHUNK, xs.shape[0]), mesh)
            return graph.run(xs)
    finally:
        model.train(was_training)


def scan_in_chunks(scan_fn, model, batches, chunk: int | None = None,
                   graphs: Graphs | None = None) -> np.ndarray:
    """`scan_fn(model, xs, graphs=graphs)` over equal-shape batches (a
    list of [B, ...] arrays or tensors, or one stacked [S, B, ...] tensor)
    in chunks of at most `chunk` (default `EVAL_SCAN_CHUNK`), on the
    model's device; returns the stacked [S, ...] outputs as float numpy."""
    chunk = chunk or EVAL_SCAN_CHUNK
    device = next(model.parameters()).device
    outs = []
    for s in range(0, len(batches), chunk):
        part = batches[s:s + chunk]
        xs = (part if isinstance(part, torch.Tensor)
              else torch.stack([torch.as_tensor(b) for b in part]))
        outs.append(scan_fn(model, xs.to(device), graphs=graphs)
                    .float().cpu().numpy())
    return np.concatenate(outs)
