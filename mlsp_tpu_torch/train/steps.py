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


def draw_pcm(generator: torch.Generator, batch: int, num_points: int,
             mixup_params: float) -> dict[str, torch.Tensor]:
    """PCM's random numbers: the batch permutation, λ ~ Beta(a, a), the two
    FPS start indices and the final point permutation.

    λ: with a = 1 (the paper recipe) Beta(1, 1) is uniform on [0, 1), drawn
    with `torch.rand` from the generator; for another a > 0 it comes from a
    numpy generator seeded by one draw of this generator
    (`torch.distributions.Beta` takes no generator); a <= 0 gives λ = 1.
    """
    g, dev = generator, generator.device
    draws = {"perm": torch.randperm(batch, generator=g, device=dev)}
    if mixup_params == 1.0:
        draws["lam"] = torch.rand((), generator=g, device=dev)
    elif mixup_params > 0:
        seed = int(torch.randint(0, 2 ** 62, (), generator=g, device=dev))
        lam = np.random.default_rng(seed).beta(mixup_params, mixup_params)
        draws["lam"] = torch.tensor(lam, dtype=torch.float32, device=dev)
    else:
        draws["lam"] = torch.ones((), device=dev)
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
    loss = (nll * keep).sum() / keep.sum().clamp_min(1.0)
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

    Returns:
      (total, metrics): the scalar loss and a dict of its terms, named as
      the JAX step's metrics.
    """
    check_recipe(cfg)
    model.train(not cfg.debug_bn_eval)
    m = {}
    src, trgt = batch["src_x"], batch["trgt_x"]
    C = cfg.density_num_class

    def forward(x, heads=()):
        return model(x, heads, generator)

    def labels(x):
        return (estimate_normals(x, cfg.near, backend=cfg.knn_backend),
                *density_labels(x, cfg.radius, C, cfg.pergroup))

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
        n_gt, dvec, dval = labels(src)
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
        n_gt = estimate_normals(trgt, cfg.near, backend=cfg.knn_backend)
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
        dvec, dval = density_labels(trgt, cfg.radius, C, cfg.pergroup)
        out = forward(trgt, ("density",))
        kl, mae = L.density_loss(
            out["density"].reshape(-1, C), out["density_mse"].reshape(-1),
            dvec.reshape(-1, C), dval.reshape(-1), cfg.Density_weight)
        m["trgt_Density_cls"], m["trgt_Density_mse"] = kl, mae
        total = total + kl + mae

    # The Chamfer-transported labels are an alternative to the input ones,
    # as in the JAX step (an elif): the first flag set wins.
    if cfg.Density_normal_viainput or cfg.Density_normal_viachamfer:
        n_gt, dvec, dval = labels(trgt)
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


def pointda_train_step(model, opt, sched, src_x, src_y, trgt_x,
                       generator: torch.Generator, cfg) -> dict:
    """One PointDA train iteration: draw, transform, forward, one backward,
    one optimizer step and one scheduler step.

    Args:
      model: a port PointDA model, on the data's device.
      opt, sched: from `train.state.make_optimizer`.
      src_x, trgt_x: [B, N, 3] float32 clouds; src_y: [B] int64 labels.
      generator: a `torch.Generator` on the data's device.
      cfg: `utils.config.PointDAConfig` (e.g. `PointDAConfig().paper_recipe`).

    Returns:
      The loss terms (detached 0-d tensors, still on the device).
    """
    check_recipe(cfg)
    check_generator(generator, src_x)
    g = generator
    src = augment_batch(src_x, *draw_augment(g, src_x))
    trgt = augment_batch(trgt_x, *draw_augment(g, trgt_x))
    draws = draw_step(g, src, src_y, trgt, cfg)

    opt.zero_grad(set_to_none=True)
    total, m = pointda_losses(
        model, cfg, {"src_x": src, "src_y": src_y, "trgt_x": trgt}, draws, g)
    total.backward()
    opt.step()
    sched.step()
    return {name: t.detach() for name, t in m.items()}
