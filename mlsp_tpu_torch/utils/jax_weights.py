"""Carry JAX-package DGCNN and DGCNNSeg checkpoints over to the port.

Counterpart of `mlsp_tpu/utils/torch_export.py::export_dgcnn` and
`export_dgcnn_seg`: flax variables, as nested dicts of arrays (`params`
and `batch_stats`), become the port's state_dict, which is the reference's
(but for DGCNNSeg's linear edge blocks, which keep the JAX names:
`models/dgcnn_seg.py`). Plain dict walking and numpy only: nothing of JAX
is imported.

Layout translations:
  * Dense kernel [in, out] -> 1x1 conv weight [out, in, 1(, 1)] or Linear
    weight [out, in].
  * EdgeConv (w_diff, w_center) -> one conv weight [W_d | W_c].
  * BatchNorm: scale -> weight, bias -> bias, batch_stats mean/var ->
    running_mean/running_var, plus `num_batches_tracked` = 0.
  * Density head: the frozen bins `fc2.weight` = pergroup * arange(num_cls).

`dgcnn_grads_from_jax` and `dgcnn_seg_grads_from_jax` map a gradient
tree the same way (parameters only), so tests can compare gradients; no
optimizer state is carried.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Converter:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats")  # None: parameters only
        self.out: dict[str, torch.Tensor] = {}

    @staticmethod
    def node(tree: Mapping, path: tuple[str, ...]) -> Mapping:
        for key in path:
            if key not in tree:
                raise KeyError("/".join(path))
            tree = tree[key]
        return tree

    def dense(self, dst: str, path: tuple[str, ...], rank: int | None) -> None:
        """rank None: Linear weight [out, in]; 1 or 2: conv [out, in, 1(, 1)]."""
        leaf = self.node(self.params, path)
        w = np.asarray(leaf["kernel"], np.float32).T
        self.out[dst + ".weight"] = _f32(w.reshape(w.shape + (1,) * (rank or 0)))
        if "bias" in leaf:
            self.out[dst + ".bias"] = _f32(leaf["bias"])

    def bn(self, dst: str, path: tuple[str, ...]) -> None:
        p = self.node(self.params, path)
        self.out[dst + ".weight"] = _f32(p["scale"])
        self.out[dst + ".bias"] = _f32(p["bias"])
        if self.stats is None:
            return
        s = self.node(self.stats, path)
        self.out[dst + ".running_mean"] = _f32(s["mean"])
        self.out[dst + ".running_var"] = _f32(s["var"])
        self.out[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def densebn(self, dst: str, path: tuple[str, ...], rank: int | None,
                dst_bn: str | None = None) -> None:
        """DenseBN -> `dst.{conv|fc}.0/1` (dst_bn None) or `dst` + `dst_bn`."""
        if dst_bn is None:
            key = "conv" if rank else "fc"
            dst, dst_bn = f"{dst}.{key}.0", f"{dst}.{key}.1"
        self.dense(dst, path + ("Dense_0",), rank)
        self.bn(dst_bn, path + ("BatchNorm_0",))


def _edge_block(params: Mapping, i: int) -> str:
    for prefix in ("EdgeConvM_", "EdgeConv_"):
        if f"{prefix}{i}" in params:
            return f"{prefix}{i}"
    raise KeyError(f"EdgeConv block {i}")


def dgcnn_state_dict_from_jax(variables: Mapping,
                              pergroup: float = 2.0) -> dict[str, torch.Tensor]:
    """flax DGCNN variables (a model initialised with every head) -> the
    port's `DGCNN` state_dict, loadable with `strict=True`.

    Takes both EdgeConv forms of the JAX model (`EdgeConvM_i`, moments, and
    `EdgeConv_i`, direct). Raises ValueError if a part is missing.
    """
    out = _convert(_Converter(variables))
    num_cls = out["Density_cls.mlp3.weight"].shape[0]
    out["Density_cls.fc2.weight"] = pergroup * torch.arange(
        num_cls, dtype=torch.float32)[None, :]
    return out


def dgcnn_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    """A JAX DGCNN gradient tree (the `params` structure, no
    `batch_stats`) -> {port parameter name: gradient}, for every trainable
    parameter of the port's `DGCNN` (the frozen density bins have none).
    The same layout translations as the weights, so a test can hold the
    port's `.grad`s against `jax.grad`."""
    return _convert(_Converter({"params": grads}))


def _convert(cv: _Converter) -> dict[str, torch.Tensor]:
    try:
        t = ("TransformNet_0",)
        for j in range(3):
            cv.densebn(f"input_transform_net.conv2d{j + 1}",
                       t + (f"DenseBN_{j}",), 2)
        cv.densebn("input_transform_net.fc1", t + ("DenseBN_3",), None)
        cv.densebn("input_transform_net.fc2", t + ("DenseBN_4",), None)
        cv.dense("input_transform_net.fc3", t + ("Dense_0",), None)

        for i in range(4):
            blk = _edge_block(cv.params, i)
            wd = np.asarray(cv.node(cv.params, (blk, "w_diff"))["kernel"]).T
            wc = np.asarray(cv.node(cv.params, (blk, "w_center"))["kernel"]).T
            w = np.concatenate([wd, wc], axis=1)  # [out, 2 cin]
            cv.out[f"conv{i + 1}.conv.0.weight"] = _f32(w[:, :, None, None])
            # direct form: a BatchNorm_0 child; moments form: the BN's
            # parameters and stats sit on the block itself
            bn_path = ((blk, "BatchNorm_0") if "BatchNorm_0" in cv.params[blk]
                       else (blk,))
            cv.bn(f"conv{i + 1}.conv.1", bn_path)

        cv.densebn("conv5", ("DenseBN_0",), 1, dst_bn="bn5")

        for j in range(2):
            cv.densebn(f"C.mlp{j + 1}", ("Classifier_0", f"DenseBN_{j}"), None)
        cv.dense("C.mlp3", ("Classifier_0", "Dense_0"), None)

        for dst, src in (("DefRec", "DefRec"), ("Norm_pred", "NormPred"),
                         ("Rec_scan", "RecScan")):
            for j in range(3):
                cv.densebn(f"{dst}.conv{j + 1}", (src, f"DenseBN_{j}"), 1,
                           dst_bn=f"{dst}.bn{j + 1}")
            cv.dense(f"{dst}.conv4", (src, "Dense_0"), 1)

        d = "Density_cls"
        cv.densebn(f"{d}.conv1", ("DensityCls", "DenseBN_0"), 1,
                   dst_bn=f"{d}.bn1")
        for j in range(2):
            cv.densebn(f"{d}.mlp{j + 1}", ("DensityCls", f"DenseBN_{j + 1}"),
                       None)
        cv.dense(f"{d}.mlp3", ("DensityCls", "Dense_0"), None)
    except KeyError as e:
        raise ValueError(
            f"DGCNN variables lack {e.args[0]} (was the model initialised "
            "with all heads?)") from e
    return cv.out


def dgcnn_seg_state_dict_from_jax(variables: Mapping, pergroup: float = 5.0
                                  ) -> dict[str, torch.Tensor]:
    """flax DGCNNSeg variables (a model initialised with every head) -> the
    port's `DGCNNSeg` state_dict, loadable with `strict=True`. Raises
    ValueError if a part is missing."""
    out = _convert_seg(_Converter(variables))
    num_cls = out["Density_cls.mlp3.weight"].shape[0]
    out["Density_cls.fc2.weight"] = pergroup * torch.arange(
        num_cls, dtype=torch.float32)[None, :]
    return out


def dgcnn_seg_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    """A JAX DGCNNSeg gradient tree (the `params` structure) -> {port
    parameter name: gradient} for every trainable parameter of the port's
    `DGCNNSeg`."""
    return _convert_seg(_Converter({"params": grads}))


def _convert_seg(cv: _Converter) -> dict[str, torch.Tensor]:
    try:
        t = ("SegTransformNet_0",)
        for j in range(3):
            cv.dense(f"input_transform_net.conv2d{j + 1}.conv.0",
                     t + (f"Dense_{j}",), 2)
        cv.dense("input_transform_net.fc1.fc.0", t + ("Dense_3",), None)
        cv.dense("input_transform_net.fc2.fc.0", t + ("Dense_4",), None)
        cv.dense("input_transform_net.fc3", t + ("Dense_5",), None)

        for i, depth in enumerate((2, 2, 1)):
            blk = f"LinearEdgeBlock_{i}"
            for j in range(depth):
                for name in (f"w_diff{j}", f"w_center{j}"):
                    cv.dense(f"shared_layers.edge{i + 1}.{name}", (blk, name),
                             None)
        cv.dense("shared_layers.conv6", ("Dense_0",), 1)

        for dst, src in (("seg", "seg"), ("DefRec", "DefRec"),
                         ("Norm_pred", "NormPred")):
            for j in range(3):
                cv.densebn(f"{dst}.conv{j + 1}", (src, f"DenseBN_{j}"), 1,
                           dst_bn=f"{dst}.bn{j + 1}")
            cv.dense(f"{dst}.conv4", (src, "Dense_0"), 1)

        d = "Density_cls"
        cv.densebn(f"{d}.conv1", ("DensityCls", "DenseBN_0"), 1,
                   dst_bn=f"{d}.bn1")
        for j in range(2):
            cv.densebn(f"{d}.mlp{j + 1}", ("DensityCls", f"DenseBN_{j + 1}"),
                       None)
        cv.dense(f"{d}.mlp3", ("DensityCls", "Dense_0"), None)
    except KeyError as e:
        raise ValueError(
            f"DGCNNSeg variables lack {e.args[0]} (was the model initialised "
            "with all heads?)") from e
    return cv.out
