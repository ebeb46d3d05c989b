"""Load reference PyTorch `model.pt` files into the port's models
(counterpart of `mlsp_tpu/utils/torch_import.py`; `--from_torch`).

The reference trainers save `torch.save(model.state_dict())`
(`utils/log.py:31-41`). The port's models keep the reference's state_dict
layout, so for DGCNN, PointNet, PointTransformer and the Hengshuang family
a key maps to the key of the same name; DGCNNSeg is the one translation:
its reference conv pairs become the port's linear edge blocks
(`models/dgcnn_seg.py`),

    edge value  = V (W_d (x_j - x_i) + W_c x_i + b_a) + b_b
    diff chain  : w_diff0 = W_d,      w_diff1 = V       (no biases)
    center chain: w_center0 = W_c (+ b_a), w_center1 = V (+ b_b).

The JAX package's rules, kept:
  * a DataParallel `module.` prefix is stripped;
  * DGCNN, PointNet and DGCNNSeg load strictly: a missing key or a shape
    mismatch raises `CheckpointMismatchError`, which lists every missing
    key grouped by module prefix (the reference's
    `get_missing_parameters_message`) and every mismatched shape;
  * PointTransformer (a plain state_dict, or a Point-BERT
    `{"base_model": ...}` file through `strip_pretrain_prefixes`) and the
    Hengshuang family load with strict=False: the same report is a
    warning and the layers it names stay at init;
  * keys of the file that nothing reads are reported in a warning
    (`get_unexpected_parameters_message`);
  * a BatchNorm that is only partly in the file stays wholly at init;
  * the density head's frozen bins `Density_cls.fc2.weight` are checked
    against the model's `pergroup` (a mismatch raises), never loaded;
  * the reference attention's qkv has no bias: a missing
    `attn.qkv.bias` loads as zeros.
The port's DefRec heads that the reference file cannot hold
(PointTransformer's; HengshuangSeg's) stay at init, and a warning names
them. PointNet++ and Point-ViT have no reference layout: ValueError.

The messages are the JAX package's, word for word. Nothing of JAX is
imported.
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np
import torch
from torch import nn


class CheckpointMismatchError(ValueError):
    """A torch checkpoint does not match the target model."""


FAMILIES = ("dgcnn", "pointnet", "dgcnn_seg", "point_transformer",
            "hengshuang", "hengshuang_seg")
_STRICT = {"dgcnn": True, "pointnet": True, "dgcnn_seg": True,
           "point_transformer": False, "hengshuang": False,
           "hengshuang_seg": False}
_TITLES = {"dgcnn": "DGCNN", "pointnet": "PointNet",
           "dgcnn_seg": "DGCNN_DefRec", "point_transformer": "PointTransformer",
           "hengshuang": "Hengshuang", "hengshuang_seg": "Hengshuang"}


def _group_checkpoint_keys(keys):
    """Group keys by the prefix up to the final '.' (`checkpoint.py:84-102`)."""
    groups = defaultdict(list)
    for key in keys:
        pos = key.rfind(".")
        if pos >= 0:
            groups[key[:pos]].extend([key[pos + 1:]])
        else:
            groups[key].extend([])
    return groups


def _group_to_str(group) -> str:
    if not group:
        return ""
    if len(group) == 1:
        return "." + group[0]
    return ".{" + ", ".join(group) + "}"


def get_missing_parameters_message(keys) -> str:
    """Keys the model mapping needs but the checkpoint lacks
    (`utils/checkpoint.py:16-30`)."""
    groups = _group_checkpoint_keys(keys)
    msg = "Some model parameters or buffers are not found in the checkpoint:\n"
    msg += "\n".join("  " + k + _group_to_str(v) for k, v in groups.items())
    return msg


def get_unexpected_parameters_message(keys) -> str:
    """Checkpoint keys not used by the model mapping
    (`utils/checkpoint.py:33-47`)."""
    groups = _group_checkpoint_keys(keys)
    msg = "The checkpoint state_dict contains keys that are not used by the model:\n"
    msg += "\n".join("  " + k + _group_to_str(v) for k, v in groups.items())
    return msg


def strip_pretrain_prefixes(ckpt: dict) -> dict:
    """The reference's pretraining-checkpoint key surgery
    (`Models.py:447-455`): take ckpt['base_model'], drop 'module.', keep
    'transformer_q.*' (except its cls_head) and 'base_model.*' stripped of
    their prefixes; every other key is deleted."""
    base = {k.replace("module.", ""): v for k, v in ckpt["base_model"].items()}
    out = {}
    for k, v in base.items():
        if k.startswith("transformer_q") and not k.startswith(
                "transformer_q.cls_head"):
            out[k[len("transformer_q."):]] = v
        elif k.startswith("base_model"):
            out[k[len("base_model."):]] = v
    return out


def load_torch_state_dict(path: str) -> dict:
    """A reference `model.pt` (or, for PointTransformer, a Point-BERT
    pretraining checkpoint, reduced by `strip_pretrain_prefixes`) as a
    CPU state_dict without the `module.` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "base_model" in ckpt:
        return strip_pretrain_prefixes(ckpt)
    return {k.removeprefix("module."): v for k, v in ckpt.items()}


class _MissingKey(KeyError):
    def __init__(self, key: str):
        super().__init__(key)
        self.key = key


class _Mapper:
    """Tracks consumed source keys, missing keys and shape mismatches while
    mapping a torch state_dict onto the port's."""

    def __init__(self, sd: dict, target: dict, title: str):
        self.sd, self.target, self.title = sd, target, title
        self.out: dict[str, torch.Tensor] = {}
        self.consumed: set[str] = set()
        self.missing: list[str] = []
        self.bad_shapes: list[str] = []

    def src(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise _MissingKey(key)
        self.consumed.add(key)
        return self.sd[key]

    def src_opt(self, key: str):
        if key in self.sd:
            self.consumed.add(key)
            return self.sd[key]
        return None

    def unit(self, fn, *args) -> None:
        """Run one mapping unit; record (don't raise) its missing key."""
        try:
            fn(*args)
        except _MissingKey as e:
            self.missing.append(e.key)

    def put(self, dst: str, value) -> None:
        want = self.target[dst]
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(want.shape):
            self.bad_shapes.append(f"{dst}: checkpoint {tuple(value.shape)} "
                                   f"!= model {tuple(want.shape)}")
            return
        self.out[dst] = value.to(want.dtype)

    def module(self, keys: list[str], optional: dict | None = None) -> None:
        """One layer, key for key; `optional` maps a key to the value it
        takes when the file lacks it. A layer the file holds only in part
        (a BatchNorm without its running statistics) is recorded as
        missing and stays wholly at init."""
        optional = optional or {}
        lacking = [k for k in keys if k not in self.sd and k not in optional
                   and not k.endswith("num_batches_tracked")]
        if lacking:
            self.missing.extend(lacking)
            self.consumed.update(k for k in keys if k in self.sd)
            return
        for k in keys:
            v = self.src_opt(k)
            v = optional.get(k) if v is None else v
            if v is not None:
                self.put(k, v)

    def finish(self, strict: bool) -> dict[str, torch.Tensor]:
        problems = []
        if self.missing:
            problems.append(get_missing_parameters_message(sorted(self.missing)))
        if self.bad_shapes:
            problems.append(
                "Checkpoint tensors with mismatched shapes:\n  "
                + "\n  ".join(self.bad_shapes))
        if problems:
            msg = (f"checkpoint does not match {self.title}:\n"
                   + "\n".join(problems))
            if strict:
                raise CheckpointMismatchError(msg)
            warnings.warn(msg, stacklevel=3)
        unexpected = sorted(
            k for k in self.sd
            if k not in self.consumed and not k.endswith("num_batches_tracked"))
        if unexpected:
            warnings.warn(get_unexpected_parameters_message(unexpected),
                          stacklevel=3)
        return self.out


def _modules(keys) -> dict[str, list[str]]:
    """The port's state_dict keys grouped by layer, in state_dict order."""
    groups: dict[str, list[str]] = {}
    for k in keys:
        groups.setdefault(k.rpartition(".")[0] or k, []).append(k)
    return groups


def _check_density_bins(m: _Mapper, src: str, pergroup: float) -> None:
    """The frozen expectation layer: the checkpoint's bin width must be the
    model's pergroup."""
    w = m.src_opt(f"{src}.fc2.weight")
    if w is None:
        return
    w = np.asarray(w.detach().cpu(), np.float32).reshape(-1)
    ckpt_pergroup = float(w[1] - w[0]) if len(w) > 1 else pergroup
    want = ckpt_pergroup * np.arange(len(w))
    if not np.allclose(w, want, atol=1e-4):
        raise ValueError(f"{src}.fc2 weights are not linear pergroup*i bins")
    if abs(ckpt_pergroup - pergroup) > 1e-4:
        raise ValueError(
            f"checkpoint density bin width {ckpt_pergroup} != model "
            f"pergroup {pergroup}; rebuild with pergroup={ckpt_pergroup}")


def _edge_blocks(m: _Mapper) -> set[str]:
    """DGCNNSeg: the reference's `shared_layers` conv pairs -> the port's
    linear edge blocks. Returns the port keys they fill."""
    def w2(t):
        return t.reshape(t.shape[0], t.shape[1])

    def block(i: int, conv_a: str, conv_b: str | None, cin: int) -> None:
        wa = w2(m.src(f"{conv_a}.weight"))
        ba = m.src(f"{conv_a}.bias")
        pairs = {"w_diff0.weight": wa[:, :cin], "w_center0.weight": wa[:, cin:],
                 "w_center0.bias": ba}
        if conv_b is not None:
            wb = w2(m.src(f"{conv_b}.weight"))
            pairs.update({"w_diff1.weight": wb, "w_center1.weight": wb,
                          "w_center1.bias": m.src(f"{conv_b}.bias")})
        for k, v in pairs.items():
            m.put(f"shared_layers.edge{i}.{k}", v)

    m.unit(block, 1, "shared_layers.conv1", "shared_layers.conv2", 3)
    m.unit(block, 2, "shared_layers.conv3", "shared_layers.conv4", 64)
    m.unit(block, 3, "shared_layers.conv5", None, 64)
    return {k for k in m.target if k.startswith("shared_layers.edge")}


def import_state_dict(model: nn.Module, sd: dict) -> dict[str, torch.Tensor]:
    """Map a reference state_dict `sd` onto `model` (a port model of one of
    `FAMILIES`). Returns the model's full state_dict with the file's
    tensors in place (the rest as the model holds it); raises or warns as
    the module docstring says."""
    name = model.NAME
    if name not in FAMILIES:
        raise ValueError(
            f"from_torch supports dgcnn/pointnet/dgcnn_seg/"
            f"point_transformer/hengshuang, not {name!r}")
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    target = model.state_dict()
    m = _Mapper(sd, target, _TITLES[name])
    done = _edge_blocks(m) if name == "dgcnn_seg" else set()
    kept = []  # port layers the reference cannot hold: left at init
    for prefix, keys in _modules(target).items():
        if prefix == "Density_cls.fc2":
            _check_density_bins(m, "Density_cls", model.config["pergroup"])
            continue
        if set(keys) <= done:
            continue
        if prefix.startswith("DefRec") and (
                name in ("point_transformer", "hengshuang_seg")
                or (name == "hengshuang" and "DefRec.conv1.weight" not in sd)):
            kept.append(prefix)
            continue
        optional = {k: torch.zeros_like(target[k]) for k in keys
                    if k.endswith("attn.qkv.bias")}
        m.module(keys, optional)
    out = m.finish(_STRICT[name])
    if kept:
        warnings.warn(f"{_TITLES[name]}: the reference checkpoint has no "
                      f"{kept[0].split('.')[0]} head; kept at init: "
                      + ", ".join(kept), stacklevel=2)
    return {**target, **out}


def load_reference(model: nn.Module, path: str) -> nn.Module:
    """Load the reference `model.pt` at `path` into `model` (on its
    device)."""
    model.load_state_dict(import_state_dict(model, load_torch_state_dict(path)),
                          strict=True)
    return model
