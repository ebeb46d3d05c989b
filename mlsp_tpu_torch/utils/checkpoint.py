"""Train-state checkpoints of the port (counterpart of
`mlsp_tpu/utils/checkpoint.py`), in its own `torch.save` format:

    {"format": FORMAT, "model": state_dict, "optimizer": ..., "scheduler":
     ..., "epoch": int, "metrics": dict}

Tensors are saved as CPU copies and loaded with `weights_only=True` and
`map_location="cpu"`; `load_state_dict` then copies them onto the
model's device. The optimizer keeps its own learning-rate objects (a
float on the CPU, a tensor on the card that a step graph reads, filled
with the saved LR) and its `capturable`/`fused` flags, and Adam's step
counts go where it keeps them (on the card when capturable, on the CPU
otherwise, as a fresh optimizer does). So a checkpoint written on the
card loads on the CPU and the other way round.

`load_model_weights` also reads the two foreign formats: the JAX
package's msgpack `.ckpt` (any file that is no `torch.save` archive;
`utils/jax_checkpoint.py`, its params and batch stats through the
family's converter of `utils/jax_weights.py`) and, with `from_torch`, a
reference `model.pt` (`utils/reference_import.py`). Resuming with the
optimizer (`load_train_state`) takes the port's own format only: a JAX
`.ckpt` carries optax state, which the port's optimizers cannot take.
"""

from __future__ import annotations

import os
import zipfile

import torch

from mlsp_tpu_torch.utils import jax_checkpoint, jax_weights, reference_import
from mlsp_tpu_torch.utils.device import process_index

FORMAT = "mlsp_tpu_torch/train-state-v1"


def _cpu(obj):
    """`obj` with every tensor inside dicts, lists and tuples copied to the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_train_state(path: str, model: torch.nn.Module, opt=None, sched=None,
                     epoch: int = 0, metrics: dict | None = None) -> None:
    """Write the model's weights, the optimizer's and scheduler's state,
    the epoch and `metrics`. Only process 0 writes; the file appears
    atomically."""
    if process_index() != 0:
        return
    payload = {
        "format": FORMAT,
        "model": _cpu(model.state_dict()),
        "optimizer": _cpu(opt.state_dict()) if opt is not None else None,
        "scheduler": _cpu(sched.state_dict()) if sched is not None else None,
        "epoch": int(epoch),
        "metrics": dict(metrics or {}),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _exists(path: str) -> None:
    if not path or not os.path.exists(path):
        raise FileNotFoundError(f"model checkpoint not found: {path!r}")


def _read(path: str) -> dict:
    _exists(path)
    # torch.save writes a zip archive; anything else (a JAX msgpack .ckpt)
    # never reaches the unpickler
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"checkpoint {path!r} is not a {FORMAT} file: a JAX .ckpt does "
            "not resume here (its optax optimizer state is not carried); "
            "load_model_weights reads its weights")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or raw.get("format") != FORMAT:
        raise ValueError(f"checkpoint {path!r} is not a {FORMAT} file")
    return raw


def _jax_state_dict(model: torch.nn.Module, path: str) -> dict:
    """A JAX `.ckpt`'s params and batch stats as `model`'s state_dict."""
    raw = jax_checkpoint.read_train_state(path)
    try:
        return jax_weights.state_dict_from_jax(
            model.NAME, {"params": raw["params"],
                         "batch_stats": raw["batch_stats"]},
            model.config.get("pergroup"))
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"checkpoint {path!r} does not match the model "
                         f"being restored ({model.NAME}): {e}") from e


def _check_model_state(model: torch.nn.Module, state: dict, path: str) -> None:
    """Name every key whose shape differs, or that is missing or extra,
    before `load_state_dict` (whose message stops at the first kind)."""
    want = model.state_dict()
    bad = [f"{k}: ckpt {tuple(state[k].shape)} != model {tuple(v.shape)}"
           for k, v in want.items() if k in state
           and tuple(state[k].shape) != tuple(v.shape)]
    bad += [f"{k}: missing from ckpt" for k in want if k not in state]
    bad += [f"{k}: not in model" for k in state if k not in want]
    if bad:
        raise ValueError(
            f"checkpoint {path!r} does not match the model being restored "
            f"(wrong num_class/width/model config?): " + "; ".join(bad))


def load_model_weights(model: torch.nn.Module, path: str,
                       from_torch: bool = False) -> torch.nn.Module:
    """Load the weights (and BatchNorm statistics) of a checkpoint into
    `model`, on the model's device: the port's own format, a JAX `.ckpt`
    or, with `from_torch`, a reference `model.pt`. Any optimizer state
    is ignored."""
    _exists(path)
    if from_torch:
        return reference_import.load_reference(model, path)
    state = (_read(path)["model"] if zipfile.is_zipfile(path)
             else _jax_state_dict(model, path))
    _check_model_state(model, state, path)
    model.load_state_dict(state, strict=True)
    return model


def load_train_state(path: str, model: torch.nn.Module, opt=None,
                     sched=None) -> tuple[int, dict]:
    """Restore a checkpoint written by `save_train_state` into `model` and,
    where given, `opt` and `sched` (all on the model's device). Returns
    (epoch, metrics)."""
    raw = _read(path)
    _check_model_state(model, raw["model"], path)
    model.load_state_dict(raw["model"], strict=True)
    for what, obj in (("optimizer", opt), ("scheduler", sched)):
        if obj is None:
            continue
        if raw[what] is None:
            raise ValueError(f"checkpoint {path!r} holds no {what} state")
        if what == "optimizer":
            _load_optimizer(obj, raw[what])
        else:
            obj.load_state_dict(raw[what])
    return raw["epoch"], raw["metrics"]


_OWN_KEYS = ("lr", "capturable", "fused", "foreach")


def _load_optimizer(opt: torch.optim.Optimizer, state: dict) -> None:
    """`opt.load_state_dict(state)`, keeping the optimizer's own LR objects
    (filled with the loaded LRs) and route flags; the step counts moved to
    the device the route keeps them on."""
    own = [{k: g[k] for k in _OWN_KEYS if k in g} for g in opt.param_groups]
    opt.load_state_dict(state)
    for group, kept in zip(opt.param_groups, own):
        lr = float(group["lr"])
        if isinstance(kept.get("lr"), torch.Tensor):
            kept["lr"].fill_(lr)
        else:
            kept["lr"] = lr
        group.update(kept)
        on_card = bool(group.get("capturable") or group.get("fused"))
        for p in group["params"]:
            step = opt.state.get(p, {}).get("step")
            if isinstance(step, torch.Tensor):
                opt.state[p]["step"] = step.to(
                    p.device if on_card else "cpu", torch.float32)
