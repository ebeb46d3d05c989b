"""The PointDA train iteration (counterpart of `mlsp_tpu/train/steps.py`).

One `pointda_train_step` is one iteration of the reference trainer
(`PointDA/trainer.py:374-571`) under the paper recipe: augmentation, PCM
mixup (FPS), the source classification forward, the on-device normal and
cardinality labels of the target, the voxel deformation, the DefRec +
normal + density forward, one backward and one Adam update.

Randomness comes from one explicit `torch.Generator` (on the data's
device): the step draws every random number first (`draw_*`), and
`pointda_losses` takes the transformed arrays as inputs, as the JAX step's
`debug_aux` returns them, so a test can feed it the JAX step's own.

The other branches of the JAX step (DefRec on the source or target alone,
Norm/Scan/Density on the target, the Chamfer-transported labels, inline
SPL, the source-side labels) raise NotImplementedError; ROADMAP.md queues
them.
"""

from __future__ import annotations

import numpy as np
import torch

from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.ops.density import density_labels
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.normals import estimate_normals
from mlsp_tpu_torch.transforms import augment, deform

SSL_HEADS = ("defrec", "normal", "density")
_NOT_PORTED = ("DefRec_on_src", "DefRec_on_trgt", "Norm_on_trgt",
               "Scan_on_trgt", "Density_on_trgt", "Density_normal_viachamfer",
               "Density_normal_viainput_onsrc", "apply_SPL", "apply_SPL_v2")


def check_recipe(cfg) -> None:
    """Raise NotImplementedError for a branch the port does not run yet."""
    on = [f for f in _NOT_PORTED if getattr(cfg, f)]
    if on or cfg.model != "dgcnn":
        what = on or [f"model={cfg.model!r}"]
        raise NotImplementedError(
            f"{', '.join(what)}: not ported to PyTorch yet (see ROADMAP.md)")


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
    from one full-length order per cloud (2 FPS calls with npoint = N).

    Returns (mixed [B, N, 3], (y, y[perm], λ))."""
    B, N, _ = x.shape
    perm, lam = draws["perm"], draws["lam"]
    num_a = torch.round(lam * N).long()
    xb = x[perm]
    va = fps_gather(x, fps(x, N, draws["start_a"], backend))
    vb = fps_gather(xb, fps(xb, N, draws["start_b"], backend))
    i = torch.arange(N, device=x.device)
    idx_b = torch.clamp(i - num_a, 0, N - 1)
    mixed = torch.where((i < num_a)[None, :, None], va, vb[:, idx_b])
    return mixed[:, draws["points"]], (y, y[perm], lam)


def _ssl_recipe_losses(cfg, logits, x_orig, mask, normal_gt, dvec, dval,
                       prefix, m):
    """DefRec + normal + density on the deformed cloud
    (`PointDA/trainer.py:544-565`)."""
    total = L.defrec_loss(logits["defrec"], x_orig, mask, cfg.DefRec_weight)
    m[f"{prefix}_DefRec"] = total
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


def pointda_losses(model, cfg, batch: dict, draws: dict,
                   generator: torch.Generator | None):
    """Total loss and its terms for one iteration, from given draws.

    Args:
      model: the port `DGCNN`; put in train mode (eval-mode BN with
        `cfg.debug_bn_eval`). Its two forwards run in order, so the BN
        running statistics carry from the first to the second.
      cfg: `utils.config.PointDAConfig`.
      batch: "src_x" [B, N, 3] and "trgt_x" (the augmented clouds),
        "src_y" [B].
      draws: the random transforms' outputs: "mixed", "ya", "yb", "lam"
        (PCM) and "dx", "dmask" (the deformed target and its mask).
      generator: for the dropout masks.

    Returns:
      (total, metrics): the scalar loss and a dict of its terms, named as
      the JAX step's metrics.
    """
    check_recipe(cfg)
    model.train(not cfg.debug_bn_eval)
    m = {}
    if cfg.apply_PCM:
        logits = model(draws["mixed"], (), generator)
        total = L.mixup_cross_entropy(logits["cls"], draws["ya"], draws["yb"],
                                      draws["lam"], cfg.DefRec_weight)
        m["src_mixup"] = total
    else:
        logits = model(batch["src_x"], (), generator)
        total = (1.0 - cfg.DefRec_weight) * L.cross_entropy(logits["cls"],
                                                             batch["src_y"])
        m["src_cls"] = total

    if cfg.Density_normal_viainput:
        trgt = batch["trgt_x"]
        n_gt = estimate_normals(trgt, cfg.near, backend=cfg.knn_backend)
        dvec, dval = density_labels(trgt, cfg.radius, cfg.density_num_class,
                                    cfg.pergroup)
        logits = model(draws["dx"], SSL_HEADS, generator)
        total = total + _ssl_recipe_losses(cfg, logits, trgt, draws["dmask"],
                                           n_gt, dvec, dval, "trgt", m)
    m["total"] = total
    return total, m


def pointda_train_step(model, opt, sched, src_x, src_y, trgt_x,
                       generator: torch.Generator, cfg) -> dict:
    """One PointDA train iteration: draw, transform, forward, one backward,
    one Adam step and one scheduler step.

    Args:
      model: the port `DGCNN`, on the data's device.
      opt, sched: from `train.state.make_optimizer`.
      src_x, trgt_x: [B, N, 3] float32 clouds; src_y: [B] int64 labels.
      generator: a `torch.Generator` on the data's device.
      cfg: `utils.config.PointDAConfig` (e.g. `PointDAConfig().paper_recipe`).

    Returns:
      The loss terms (detached 0-d tensors, still on the device).
    """
    check_recipe(cfg)
    gdev = generator.device
    if gdev.type == "cuda" and gdev.index is None:
        gdev = torch.device("cuda", torch.cuda.current_device())
    if gdev != src_x.device:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"batch on {src_x.device}")
    g = generator
    src = augment_batch(src_x, *draw_augment(g, src_x))
    trgt = augment_batch(trgt_x, *draw_augment(g, trgt_x))
    draws = {}
    if cfg.apply_PCM:
        pcm = draw_pcm(g, src.shape[0], src.shape[1], cfg.mixup_params)
        draws["mixed"], (draws["ya"], draws["yb"], draws["lam"]) = pcm_mix(
            src, src_y, pcm, cfg.knn_backend)
    if cfg.Density_normal_viainput:
        draws["dx"], draws["dmask"] = deform_dispatch(
            trgt, draw_deform_dispatch(g, trgt, cfg), cfg)

    opt.zero_grad(set_to_none=True)
    total, m = pointda_losses(
        model, cfg, {"src_x": src, "src_y": src_y, "trgt_x": trgt}, draws, g)
    total.backward()
    opt.step()
    sched.step()
    return {name: t.detach() for name, t in m.items()}
