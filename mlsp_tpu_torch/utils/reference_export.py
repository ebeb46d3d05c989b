"""Write the port's models as reference PyTorch `model.pt` files
(counterpart of `mlsp_tpu/utils/torch_export.py`; the `export`
subcommand).

The port's state_dict is the reference's layout for DGCNN, PointNet,
PointTransformer and the Hengshuang family, so the export copies it, less
what the reference model cannot hold:
  * PointTransformer: the q/k/v biases (the reference's qkv is bias-free;
    nonzero ones are dropped with a warning) and the DefRec head (the
    reference's is a CUDA propagation pyramid): the reference loads the
    file with strict=False, as it loads pretrained transformers
    (`Models.py:458`);
  * HengshuangSeg: the DefRec head (`PointTransformerSeg` has none).
DGCNNSeg's linear edge blocks go back into the reference's conv pairs:
with D0, D1 the diff chain and C0 (+ c0), C1 (+ c1) the center chain,
V = D1, W_d = D0, W_c solves D1 W_c = C1 C0 by a float64 pseudo-inverse,
b_a = 0 and b_b = C1 c0 + c1. It is exact when D1 has full rank; a
relative residual above 1e-4 warns. PointNet++ and Point-ViT have no
reference layout: ValueError.

The solve is a copy of `export_dgcnn_seg`'s; nothing of JAX is imported.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from torch import nn

FAMILIES = ("dgcnn", "pointnet", "dgcnn_seg", "point_transformer",
            "hengshuang", "hengshuang_seg")
# Residual ‖D1·W_c − C1·C0‖/‖C1·C0‖ above which the seg double-block
# solve is reported as lossy (D1 effectively rank-deficient).
_SOLVE_RTOL = 1e-4


def _qkv_biases(sd: dict, title: str) -> None:
    """Drop each block's q/k/v bias, warning where one is not ~0."""
    for key in [k for k in sd if k.endswith("attn.qkv.bias")]:
        b = sd.pop(key)
        bmax = float(b.abs().max())
        if bmax > 1e-6:
            dst = key[:-len(".attn.qkv.bias")]
            warnings.warn(
                f"{title}.{dst}: flax qkv biases (max {bmax:.2e}) dropped "
                "— the reference qkv is bias-free", stacklevel=3)


def _conv_pairs(sd: dict) -> None:
    """DGCNNSeg's `shared_layers.edge{1,2,3}` -> `shared_layers.conv1-5`."""
    def pop(key) -> np.ndarray:
        return sd.pop(key).double().numpy()

    def put(dst, w, b):
        sd[dst + ".weight"] = torch.from_numpy(
            w.astype(np.float32)).reshape(*w.shape, 1, 1)
        sd[dst + ".bias"] = torch.from_numpy(b.astype(np.float32))

    for i, (conv_a, conv_b) in enumerate((("conv1", "conv2"),
                                          ("conv3", "conv4"),
                                          ("conv5", None))):
        e = f"shared_layers.edge{i + 1}"
        d0, c0 = pop(f"{e}.w_diff0.weight"), pop(f"{e}.w_center0.weight")
        b0 = pop(f"{e}.w_center0.bias")
        if conv_b is None:
            put(f"shared_layers.{conv_a}", np.concatenate([d0, c0], 1), b0)
            continue
        d1, c1 = pop(f"{e}.w_diff1.weight"), pop(f"{e}.w_center1.weight")
        b1 = pop(f"{e}.w_center1.bias")
        # the float32 products and the float64 solve of export_dgcnn_seg
        f32 = np.float32
        target = (c1.astype(f32) @ c0.astype(f32)).astype(np.float64)
        wc = (np.linalg.pinv(d1) @ target).astype(f32)
        denom = float(np.linalg.norm(target)) or 1.0
        resid = float(np.linalg.norm(d1.astype(f32) @ wc - target)) / denom
        if resid > _SOLVE_RTOL:
            warnings.warn(
                f"DGCNN_DefRec.shared_layers.{conv_a}: second-stage diff map "
                f"is rank-deficient; export residual {resid:.2e} — the torch "
                "model will only approximate this block", stacklevel=3)
        put(f"shared_layers.{conv_a}", np.concatenate([d0, wc], 1),
            np.zeros(d1.shape[0]))
        put(f"shared_layers.{conv_b}", d1,
            c1.astype(f32) @ b0.astype(f32) + b1.astype(f32))


def export_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The reference state_dict of `model` (a port model of `FAMILIES`),
    as CPU float32 tensors (`num_batches_tracked` int64)."""
    name = model.NAME
    if name not in FAMILIES:
        raise ValueError(
            "export supports dgcnn/pointnet/dgcnn_seg/point_transformer/"
            f"hengshuang/hengshuang_seg, not {name!r}")
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if name == "point_transformer":
        _qkv_biases(sd, "PointTransformer")
    if name in ("point_transformer", "hengshuang_seg"):
        sd = {k: v for k, v in sd.items() if not k.startswith("DefRec.")}
    if name == "dgcnn_seg":
        _conv_pairs(sd)
    return sd


def save(state_dict: dict[str, torch.Tensor], path: str) -> None:
    """Write an exported state_dict as a reference-loadable `model.pt`."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.contiguous() for k, v in state_dict.items()}, path)
