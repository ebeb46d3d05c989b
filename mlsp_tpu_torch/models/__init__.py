"""PyTorch models of the port (channels-last, reference state_dict layout).

DGCNN (PointDA) and DGCNNSeg (PointSegDA) are ported; the other families
of `mlsp_tpu.models` are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from mlsp_tpu_torch.models.dgcnn import DGCNN
from mlsp_tpu_torch.models.dgcnn_seg import DGCNNSeg
from mlsp_tpu_torch.models.layers import init_parameters
from mlsp_tpu_torch.utils.device import resolve_device

__all__ = ["DGCNN", "DGCNNSeg", "make_model"]

_MODELS = {"dgcnn": DGCNN, "dgcnn_seg": DGCNNSeg}
_NOT_PORTED = ("pointnet", "pointnet2", "pointnet2_ssg",
               "point_transformer", "transformer", "hengshuang",
               "hengshuang_transformer", "hengshuang_seg", "vit")


def make_model(name: str, num_classes: int, *,
               device: str | torch.device | None = None,
               generator: torch.Generator | None = None, **kw
               ) -> torch.nn.Module:
    """Build a model with weights drawn from `generator` (seed 0 if None),
    on `device` (the CUDA card if None; raises without one), in eval mode."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: see ROADMAP.md")
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}")
    device = resolve_device(device)
    model = _MODELS[name](num_classes=num_classes, **kw)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.to(device).eval()
