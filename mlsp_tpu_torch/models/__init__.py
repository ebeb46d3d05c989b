"""PyTorch models of the port (channels-last, reference state_dict layout).

Every family of `mlsp_tpu.models.make_model`, under its names and
aliases: DGCNN and DGCNNSeg, PointNet, PointNet++ (SSG), PointTransformer,
the Hengshuang family (classifier and segmenter) and Point-ViT (`vit`,
with its constructor-only `encoder_type` and `use_absolute`).
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.models.dgcnn import DGCNN
from mlsp_tpu_torch.models.dgcnn_seg import DGCNNSeg
from mlsp_tpu_torch.models.hengshuang import HengshuangSeg, HengshuangTransformer
from mlsp_tpu_torch.models.layers import init_parameters
from mlsp_tpu_torch.models.pointnet import PointNet
from mlsp_tpu_torch.models.pointnet2 import PointNet2SSG
from mlsp_tpu_torch.models.transformer import PointTransformer
from mlsp_tpu_torch.models.vit import PointViT
from mlsp_tpu_torch.utils import chipcal
from mlsp_tpu_torch.utils.device import resolve_device

__all__ = ["DGCNN", "DGCNNSeg", "HengshuangSeg", "HengshuangTransformer",
           "PointNet", "PointNet2SSG", "PointTransformer", "PointViT",
           "canonical_name",
           "make_model", "model_kwargs"]

_MODELS = {m.NAME: m for m in (DGCNN, DGCNNSeg, PointNet, PointNet2SSG,
                               PointTransformer, HengshuangTransformer,
                               HengshuangSeg, PointViT)}
_ALIASES = {"pointnet2_ssg": "pointnet2", "transformer": "point_transformer",
            "hengshuang_transformer": "hengshuang"}
POINTDA_MODELS = ("dgcnn", "pointnet", "pointnet2", "point_transformer",
                  "hengshuang", "vit")
SEG_MODELS = ("dgcnn_seg", "hengshuang_seg")


def canonical_name(name: str) -> str:
    """The model's own name for `name` or a JAX alias of it; raises
    ValueError for an unknown name."""
    name = _ALIASES.get(name.lower(), name.lower())
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}")
    return name


def model_kwargs(cfg, name: str | None = None) -> dict:
    """The constructor keywords a config gives model `name` (default
    `cfg.model`), as the JAX trainers and `evaluation._build_model` build
    it: `dropout` always, `knn_backend` for every family but PointNet
    (which builds no graph), DGCNN's and DGCNNSeg's density head sizes,
    DGCNN's precision and EdgeConv route (`compute_dtype`, and the
    `head_dtype`, `gather_dtype` and `edge_impl` the config has:
    `dgcnn_dtype_kwargs`), the seg trainer's `compute_dtype` for
    DGCNNSeg (JAX's eval builds DGCNNSeg in float32), and the config's
    `transformer_dim` as the Hengshuang models' `d_model` where the
    config has one (`PointDAConfig`, `EvalConfig`; the seg trainer and
    SPST build them at the default width)."""
    from mlsp_tpu_torch.utils.config import PointSegDAConfig

    name = canonical_name(name or cfg.model)
    kw = {"dropout": cfg.dropout}
    if name != "pointnet":
        kw["knn_backend"] = cfg.knn_backend
    if name in ("dgcnn", "dgcnn_seg"):
        kw.update(density_num_cls=cfg.density_num_class, pergroup=cfg.pergroup)
    if name == "dgcnn":
        kw["compute_dtype"] = cfg.compute_dtype
        for key in ("head_dtype", "gather_dtype", "edge_impl"):
            if getattr(cfg, key, ""):
                kw[key] = getattr(cfg, key)
    if name == "dgcnn_seg" and isinstance(cfg, PointSegDAConfig):
        kw["compute_dtype"] = cfg.compute_dtype
    if name in ("hengshuang", "hengshuang_seg") and hasattr(
            cfg, "transformer_dim"):
        kw["d_model"] = cfg.transformer_dim
    return kw


def make_model(name: str, num_classes: int, *,
               device: str | torch.device | None = None,
               generator: torch.Generator | None = None, **kw
               ) -> torch.nn.Module:
    """Build a model with weights drawn from `generator` (seed 0 if None),
    on `device` (the CUDA card if None; raises without one), in eval mode.
    `name` may be a JAX alias (`pointnet2_ssg`, `transformer`,
    `hengshuang_transformer`). A DGCNN with `edge_impl="auto"` on the card
    has the card's EdgeConv calibration measured first, if this process
    has none (`utils.chipcal.calibrated`), as the JAX `make_model` does
    outside any trace."""
    cls = _MODELS[canonical_name(name)]
    device = resolve_device(device)
    model = cls(num_classes=num_classes, **kw)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    if isinstance(model, DGCNN) and model.edge_impl == "auto" and (
            device.type == "cuda"):
        chipcal.calibrated(device)
    return model.to(device).eval()
