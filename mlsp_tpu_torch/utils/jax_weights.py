"""Carry JAX-package checkpoints over to the port, for every ported model.

Counterpart of `mlsp_tpu/utils/torch_export.py` (`export_dgcnn`,
`export_dgcnn_seg`, `export_pointnet`, `export_point_transformer`,
`export_hengshuang`; Point-ViT has no exporter): flax variables, as
nested dicts of arrays (`params` and `batch_stats`), become the port's
state_dict, which is the reference's
but for what the reference cannot hold: DGCNNSeg's linear edge blocks keep
the JAX names (`models/dgcnn_seg.py`), PointTransformer adds its q/k/v
biases and DefRec head, HengshuangSeg its DefRec head, and PointNet++,
which has no reference layout, keeps the flax module paths
(`models/pointnet2.py`), as do Point-ViT's parts that PointTransformer
lacks (`models/vit.py`). Plain dict walking and numpy only: nothing of JAX
is imported.

Layout translations:
  * Dense kernel [in, out] -> 1x1 conv weight [out, in, 1(, 1)] or Linear
    weight [out, in].
  * EdgeConv (w_diff, w_center) -> one conv weight [W_d | W_c].
  * BatchNorm: scale -> weight, bias -> bias, batch_stats mean/var ->
    running_mean/running_var, plus `num_batches_tracked` = 0.
  * Density head: the frozen bins `fc2.weight` = pergroup * arange(num_cls).

The `*_grads_from_jax` functions map a gradient tree the same way
(parameters only), so tests can compare gradients; no optimizer state is
carried. Each model's variables must come from a model initialised with
all of its heads (and, for the Hengshuang classifier, the decoder that its
DefRec head runs); a missing part raises ValueError.
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


def _transform_net(cv: _Converter, dst: str, src: str | tuple) -> None:
    """A flax `TransformNet` (either mode; `src` its name or path) -> the
    reference `transform_net`: 2-D 1x1 convs conv2d1-3, then fc1, fc2
    (with BN) and fc3."""
    src = (src,) if isinstance(src, str) else tuple(src)
    for j in range(3):
        cv.densebn(f"{dst}.conv2d{j + 1}", src + (f"DenseBN_{j}",), 2)
    cv.densebn(f"{dst}.fc1", src + ("DenseBN_3",), None)
    cv.densebn(f"{dst}.fc2", src + ("DenseBN_4",), None)
    cv.dense(f"{dst}.fc3", src + ("Dense_0",), None)


def _classifier(cv: _Converter, dst: str, src: str) -> None:
    for j in range(2):
        cv.densebn(f"{dst}.mlp{j + 1}", (src, f"DenseBN_{j}"), None)
    cv.dense(f"{dst}.mlp3", (src, "Dense_0"), None)


def _point_head(cv: _Converter, dst: str, src: str) -> None:
    """A flax `PointMLPHead` -> conv1-3 with bn1-3, conv4 (1-D convs)."""
    for j in range(3):
        cv.densebn(f"{dst}.conv{j + 1}", (src, f"DenseBN_{j}"), 1,
                   dst_bn=f"{dst}.bn{j + 1}")
    cv.dense(f"{dst}.conv4", (src, "Dense_0"), 1)


def _checked(convert, what: str):
    """Run `convert()`, turning a missing part into a ValueError."""
    try:
        return convert()
    except KeyError as e:
        raise ValueError(
            f"{what} variables lack {e.args[0]} (was the model initialised "
            "with all heads?)") from e


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
        _transform_net(cv, "input_transform_net", "TransformNet_0")

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

        _classifier(cv, "C", "Classifier_0")
        for dst, src in (("DefRec", "DefRec"), ("Norm_pred", "NormPred"),
                         ("Rec_scan", "RecScan")):
            _point_head(cv, dst, src)

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
            _point_head(cv, dst, src)

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


# ---------------------------------------------------------------------------
# PointNet (`export_pointnet`)
# ---------------------------------------------------------------------------


def _convert_pointnet(cv: _Converter) -> dict[str, torch.Tensor]:
    _transform_net(cv, "trans_net1", "TransformNet_0")
    _transform_net(cv, "trans_net2", "trans_net2")
    for j in range(5):
        cv.densebn(f"conv{j + 1}", (f"DenseBN_{j}",), 2)
    _classifier(cv, "C", "Classifier_0")
    _point_head(cv, "DefRec", "DefRec")
    return cv.out


def pointnet_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax PointNet variables (initialised with the DefRec head) -> the
    port's `PointNet` state_dict, which is `export_pointnet`'s."""
    return _checked(lambda: _convert_pointnet(_Converter(variables)),
                    "PointNet")


def pointnet_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    return _checked(lambda: _convert_pointnet(_Converter({"params": grads})),
                    "PointNet")


# ---------------------------------------------------------------------------
# PointNet++ (no exporter: the flax module paths, `models/pointnet2.py`)
# ---------------------------------------------------------------------------


def _convert_flax_paths(cv: _Converter, tree: Mapping = None,
                        path: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """Every Dense (a node with a "kernel") and BatchNorm (with a "scale")
    under its flax path, '/' as '.'."""
    tree = cv.params if tree is None else tree
    for name, sub in tree.items():
        p = path + (name,)
        if "kernel" in sub:
            cv.dense(".".join(p), p, None)
        elif "scale" in sub:
            cv.bn(".".join(p), p)
        else:
            _convert_flax_paths(cv, sub, p)
    return cv.out


def pointnet2_state_dict_from_jax(variables: Mapping
                                  ) -> dict[str, torch.Tensor]:
    """flax PointNet2SSG variables -> the port's `PointNet2SSG` state_dict
    (the flax module paths)."""
    return _checked(lambda: _convert_flax_paths(_Converter(variables)),
                    "PointNet2SSG")


def pointnet2_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    return _checked(lambda: _convert_flax_paths(_Converter({"params": grads})),
                    "PointNet2SSG")


# ---------------------------------------------------------------------------
# PointTransformer (`export_point_transformer`, plus q/k/v biases and DefRec)
# ---------------------------------------------------------------------------


def _group_encoder(cv: _Converter, ge: tuple[str, ...]) -> None:
    """A flax `GroupEncoder` -> the reference `Encoder` under `encoder.`."""
    cv.densebn("encoder.first_conv.0", ge + ("DenseBN_0",), 1,
               dst_bn="encoder.first_conv.1")
    cv.dense("encoder.first_conv.3", ge + ("Dense_0",), 1)
    for stage, bn, d_g, d_h, d_out in (
            ("add_conv1", "BatchNorm_0", "Dense_1", "Dense_2", "Dense_3"),
            ("second_conv", "BatchNorm_1", "Dense_4", "Dense_5", "Dense_6")):
        # the sum of two Denses is the reference's conv over [global | h]
        g, h = (cv.node(cv.params, ge + (d,)) for d in (d_g, d_h))
        w = np.concatenate([np.asarray(g["kernel"], np.float32).T,
                            np.asarray(h["kernel"], np.float32).T], axis=1)
        cv.out[f"encoder.{stage}.0.weight"] = _f32(w[:, :, None])
        cv.out[f"encoder.{stage}.0.bias"] = _f32(g["bias"])
        cv.bn(f"encoder.{stage}.1", ge + (bn,))
        cv.dense(f"encoder.{stage}.3", ge + (d_out,), 1)


def _convert_point_transformer(cv: _Converter) -> dict[str, torch.Tensor]:
    _group_encoder(cv, ("GroupEncoder_0",))
    _token_backbone(cv, ("pos_embed_0",), ("pos_embed_1",), ("norm",))
    cv.dense("cls_head_finetune.0", ("cls_head_0",), None)
    cv.dense("cls_head_finetune.3", ("cls_head_1",), None)
    _point_head(cv, "DefRec", "DefRec")
    return cv.out


def _token_backbone(cv: _Converter, pos0: tuple[str, ...],
                    pos1: tuple[str, ...], norm: tuple[str, ...]) -> None:
    """reduce_dim, the tokens, the pos embed (flax paths `pos0` for the
    3 -> 128 Dense, `pos1` for the 128 -> D one), the blocks and the final
    LayerNorm (`norm`): PointTransformer's and Point-ViT's, under the
    reference's names."""
    cv.dense("reduce_dim", ("reduce_dim",), None)
    for name in ("cls_token", "cls_pos"):
        cv.out[name] = _f32(cv.node(cv.params, (name,)))
    cv.dense("pos_embed.0", pos0, None)
    cv.dense("pos_embed.2", pos1, None)
    depth = sum(1 for k in cv.params if k.startswith("block"))
    for i in range(depth):
        src, dst = f"block{i}", f"blocks.blocks.{i}"
        _layer_norm(cv, f"{dst}.norm1", (src, "LayerNorm_0"))
        _layer_norm(cv, f"{dst}.norm2", (src, "LayerNorm_1"))
        mha = cv.node(cv.params, (src, "MultiHeadDotProductAttention_0"))
        ws, bs = [], []
        for nm in ("query", "key", "value"):
            k = np.asarray(cv.node(mha, (nm,))["kernel"], np.float32)
            ws.append(k.reshape(k.shape[0], -1).T)  # [D, H, Dh] -> [D, D]
            bs.append(np.asarray(mha[nm]["bias"], np.float32).reshape(-1))
        cv.out[f"{dst}.attn.qkv.weight"] = _f32(np.concatenate(ws, axis=0))
        cv.out[f"{dst}.attn.qkv.bias"] = _f32(np.concatenate(bs))
        out = cv.node(mha, ("out",))
        ko = np.asarray(out["kernel"], np.float32)  # [H, Dh, D]
        cv.out[f"{dst}.attn.proj.weight"] = _f32(
            ko.reshape(-1, ko.shape[-1]).T)
        cv.out[f"{dst}.attn.proj.bias"] = _f32(out["bias"])
        cv.dense(f"{dst}.mlp.fc1", (src, "Dense_0"), None)
        cv.dense(f"{dst}.mlp.fc2", (src, "Dense_1"), None)
    _layer_norm(cv, "norm", norm)


def _layer_norm(cv: _Converter, dst: str, path: tuple[str, ...]) -> None:
    p = cv.node(cv.params, path)
    cv.out[dst + ".weight"] = _f32(p["scale"])
    cv.out[dst + ".bias"] = _f32(p["bias"])


def point_transformer_state_dict_from_jax(variables: Mapping
                                          ) -> dict[str, torch.Tensor]:
    """flax PointTransformer variables (initialised with the DefRec head)
    -> the port's `PointTransformer` state_dict: every key
    `export_point_transformer` emits, with its array, plus
    `blocks.blocks.{i}.attn.qkv.bias` and `DefRec.*`."""
    return _checked(lambda: _convert_point_transformer(_Converter(variables)),
                    "PointTransformer")


def point_transformer_grads_from_jax(grads: Mapping
                                     ) -> dict[str, torch.Tensor]:
    return _checked(
        lambda: _convert_point_transformer(_Converter({"params": grads})),
        "PointTransformer")


# ---------------------------------------------------------------------------
# Hengshuang family (`export_hengshuang`, plus HengshuangSeg's DefRec)
# ---------------------------------------------------------------------------


def _vector_attention(cv: _Converter, dst: str, path: tuple[str, ...]) -> None:
    """flax `VectorAttention` (Dense_0..8 in call order) -> the reference
    `TransformerBlock`; each two-layer MLP is created outer first."""
    for j, name in enumerate(("fc1", "w_qs", "w_ks", "w_vs", "fc_delta.2",
                              "fc_delta.0", "fc_gamma.2", "fc_gamma.0",
                              "fc2")):
        cv.dense(f"{dst}.{name}", path + (f"Dense_{j}",), None)


def _convert_hengshuang(cv: _Converter) -> dict[str, torch.Tensor]:
    bb = ("Backbone_0",)
    nblocks = sum(1 for k in cv.node(cv.params, bb)
                  if k.startswith("TransitionDown_"))
    cv.dense("backbone.fc1.2", bb + ("Dense_0",), None)  # the outer Linear
    cv.dense("backbone.fc1.0", bb + ("Dense_1",), None)
    _vector_attention(cv, "backbone.transformer1", bb + ("VectorAttention_0",))
    for i in range(nblocks):
        sa = f"backbone.transition_downs.{i}.sa"
        for j in range(2):
            cv.densebn(f"{sa}.mlp_convs.{j}",
                       bb + (f"TransitionDown_{i}", f"DenseBN_{j}"), 2,
                       dst_bn=f"{sa}.mlp_bns.{j}")
        _vector_attention(cv, f"backbone.transformers.{i}",
                          bb + (f"VectorAttention_{i + 1}",))
    seg = "seg_fc1" in cv.params
    for j, src in enumerate(("seg_fc1", "seg_fc2", "seg_out") if seg
                            else ("Dense_0", "Dense_1", "Dense_2")):
        cv.dense(f"{'fc3' if seg else 'cls_head_finetune'}.{2 * j}", (src,),
                 None)
    ud = ("UpDecoder_0",)
    for j in range(3):
        cv.dense(f"fc2.{2 * j}", ud + (f"Dense_{j}",), None)
    _vector_attention(cv, "transformer2", ud + ("VectorAttention_0",))
    for j in range(nblocks):
        for k, fc in enumerate(("fc1", "fc2")):
            cv.densebn(f"transition_ups.{j}.{fc}.0",
                       ud + (f"TransitionUp_{j}", f"DenseBN_{k}"), None,
                       dst_bn=f"transition_ups.{j}.{fc}.2")
        _vector_attention(cv, f"transformers.{j}",
                          ud + (f"VectorAttention_{j + 1}",))
    _point_head(cv, "DefRec", "DefRec")
    return cv.out


def hengshuang_state_dict_from_jax(variables: Mapping
                                   ) -> dict[str, torch.Tensor]:
    """flax HengshuangTransformer variables (initialised with the DefRec
    head, which builds the decoder) or HengshuangSeg variables (with the
    seg and DefRec heads) -> the port's model's state_dict: every key
    `export_hengshuang` emits, with its array, plus HengshuangSeg's
    `DefRec.*`."""
    return _checked(lambda: _convert_hengshuang(_Converter(variables)),
                    "Hengshuang")


def hengshuang_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    return _checked(lambda: _convert_hengshuang(_Converter({"params": grads})),
                    "Hengshuang")


# ---------------------------------------------------------------------------
# Point-ViT (no exporter: PointTransformer's names where the modules are
# shared, flax paths for the rest, `models/vit.py`)
# ---------------------------------------------------------------------------

_VIT_ENCODERS = {"RelativeGroupEncoder_0", "DgcnnGroupEncoder_0",
                 "PointnetGroupEncoder_0"}


def _convert_vit(cv: _Converter) -> dict[str, torch.Tensor]:
    if "GroupEncoder_0" in cv.params:  # encoder_type "pointnet"
        _group_encoder(cv, ("GroupEncoder_0",))
    for enc in _VIT_ENCODERS & set(cv.params):
        for name, sub in cv.params[enc].items():
            if name.startswith("TransformNet_") or name == "trans_net2":
                _transform_net(cv, f"{enc}.{name}", (enc, name))
            else:
                _convert_flax_paths(cv, {name: sub}, (enc,))
    # flax names the pos embed's Denses by creation order: the outer
    # (128 -> D) Dense_0 first, then the inner (3 -> 128) Dense_1
    _token_backbone(cv, ("Dense_1",), ("Dense_0",), ("LayerNorm_0",))
    cv.dense("head_fc1", ("head_fc1",), None)
    cv.dense("head_fc2", ("head_fc2",), None)
    _point_head(cv, "DefRec", "DefRec")
    return cv.out


def vit_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax PointViT variables (any `encoder_type`, initialised with the
    DefRec head) -> the port's `PointViT` state_dict (`models/vit.py`)."""
    return _checked(lambda: _convert_vit(_Converter(variables)), "PointViT")


def vit_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    return _checked(lambda: _convert_vit(_Converter({"params": grads})),
                    "PointViT")


def state_dict_from_jax(name: str, variables: Mapping,
                        pergroup: float | None = None
                        ) -> dict[str, torch.Tensor]:
    """The flax variables of model `name` (the port's own name) -> its
    state_dict; `pergroup` sets DGCNN's and DGCNNSeg's density bins (their
    defaults if None)."""
    bins = {} if pergroup is None else {"pergroup": pergroup}
    convert = {
        "dgcnn": lambda v: dgcnn_state_dict_from_jax(v, **bins),
        "dgcnn_seg": lambda v: dgcnn_seg_state_dict_from_jax(v, **bins),
        "pointnet": pointnet_state_dict_from_jax,
        "pointnet2": pointnet2_state_dict_from_jax,
        "point_transformer": point_transformer_state_dict_from_jax,
        "hengshuang": hengshuang_state_dict_from_jax,
        "hengshuang_seg": hengshuang_state_dict_from_jax,
        "vit": vit_state_dict_from_jax,
    }
    if name not in convert:
        raise ValueError(f"no JAX weight conversion for model {name!r}")
    return convert[name](variables)
