"""Serving bundles (counterpart of `mlsp_tpu/serving.py`).

Two formats, named by `meta.json`'s "format":

    weights bundle ("mlsp_tpu_torch/state_dict-v1")
      weights.pt   the model's state_dict (the port's layout)
      meta.json    model name and config, task, shape metadata
    AOT bundle ("torch.export/pt2-v1", the JAX package's StableHLO bundle)
      eval_fn.pt2  the eval forward as a `torch.export` program, weights
                   inside, with a symbolic batch and a fixed point count
      meta.json    task, model name, shape metadata

`ServingModel` rebuilds a weights bundle's model from this package (its
kernels run on the card) and loads an AOT bundle with `torch.export.load`
alone: no model class, no model code. A bundle of a classifier
(`task="pointda"`) serves class logits [B, num_class], one of a segmenter
(`task="pointsegda"`) per-point logits [B, N, num_class].
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from mlsp_tpu_torch.utils.profiling import span

FORMAT = "mlsp_tpu_torch/state_dict-v1"
AOT_FORMAT = "torch.export/pt2-v1"
_WEIGHTS_FILE = "weights.pt"
_FN_FILE = "eval_fn.pt2"
_META_FILE = "meta.json"


def _task_of(model) -> str:
    from mlsp_tpu_torch.models import SEG_MODELS

    return "pointsegda" if model.NAME in SEG_MODELS else "pointda"


class EvalForward(torch.nn.Module):
    """The eval forward a bundle serves: x [B, N, 3] -> the classifier's
    "cls" logits, or with `task="pointsegda"` the segmenter's "seg"
    logits."""

    def __init__(self, model: torch.nn.Module, task: str):
        super().__init__()
        self.model = model
        self.heads, self.output = ((("seg",), "seg") if task == "pointsegda"
                                   else ((), "cls"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, self.heads)[self.output]


def _write_meta(path: str, meta: dict) -> dict:
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def save_serving_bundle(model, path: str, num_points: int = 1024,
                        num_class: int = 10) -> dict:
    """Write `model` (a port model of any family, classifier or
    segmenter) as a weights bundle directory: its weights, its name and
    its constructor config, from which `ServingModel` rebuilds it, and the
    task its class implies. The bundle serves any batch size; the point
    count is fixed."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, _WEIGHTS_FILE))
    return _write_meta(path, {
        "task": _task_of(model), "model": model.NAME,
        "model_kwargs": model.config, "batch_size": None,
        "num_points": num_points, "num_class": num_class, "format": FORMAT})


def save_aot_bundle(model, path: str, num_points: int = 1024,
                    num_class: int = 10) -> dict:
    """Freeze `model`'s eval forward into an AOT bundle directory: a
    `torch.export` program with a symbolic batch (`Dim("b", min=1)`) and
    `num_points` fixed, its weights inside, written with
    `torch.export.save`. The program is traced on the CPU.

    Build the model with `knn_backend="torch"`: the program then holds the
    plain kNN and FPS, which run on every device, as the JAX package's
    bundle forces its XLA kNN so that one artifact serves on CPU and TPU.
    The card's kernels are loaded with ctypes and cannot be traced into a
    program in any case."""
    from torch.export import Dim, export

    os.makedirs(path, exist_ok=True)
    task = _task_of(model)
    fwd = EvalForward(copy.deepcopy(model), task).cpu().eval()
    x = torch.zeros(2, num_points, 3)
    with torch.no_grad():
        ep = export(fwd, (x,), dynamic_shapes={"x": {0: Dim("b", min=1)}})
    torch.export.save(ep, os.path.join(path, _FN_FILE))
    return _write_meta(path, {
        "task": task, "model": model.NAME, "batch_size": None,
        "num_points": num_points, "num_class": num_class,
        "format": AOT_FORMAT})


class ServingModel:
    """A loaded bundle: `predict(x)` returns class logits [B, num_class]
    (`task="pointda"`) or per-point logits [B, N, num_class]
    (`task="pointsegda"`).

    Runs on `device`, the CUDA card if None (raises without one). An AOT
    bundle is moved to it with `move_to_device_pass`, so a bundle written
    on the CPU serves on the card, and the reverse.
    """

    def __init__(self, path: str, device: str | torch.device | None = None):
        from mlsp_tpu_torch.utils.device import resolve_device

        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        self.device = resolve_device(device)
        fmt = self.meta.get("format")
        if fmt == AOT_FORMAT:
            from torch.export.passes import move_to_device_pass

            ep = torch.export.load(os.path.join(path, _FN_FILE))
            self._fn = move_to_device_pass(ep, self.device).module()
        elif fmt == FORMAT:
            from mlsp_tpu_torch.models import make_model

            model = make_model(self.meta["model"], self.meta["num_class"],
                               device=self.device,
                               **self.meta["model_kwargs"])
            state = torch.load(os.path.join(path, _WEIGHTS_FILE),
                               map_location=self.device, weights_only=True)
            model.load_state_dict(state, strict=True)
            self.model = model
            self._fn = EvalForward(model, self.meta.get("task", "pointda"))
        else:
            raise ValueError(f"{path}: not a {FORMAT} or {AOT_FORMAT} bundle "
                             f"(format {fmt!r})")

    def predict(self, x) -> np.ndarray:
        """x [B, N, 3] (numpy or tensor) -> logits, [B, num_class] or
        [B, N, num_class]. N is fixed by the bundle, B is any. Spans: the
        "request", and in it "request_copy_in", "request_forward",
        "request_copy_out"."""
        N = self.meta["num_points"]
        if x.ndim != 3 or tuple(x.shape[1:]) != (N, 3):
            raise ValueError(
                f"bundle expects ('any', {N}, 3) inputs, got {tuple(x.shape)}")
        with span("request"):
            with span("request_copy_in"):
                x = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
            with torch.inference_mode():
                with span("request_forward"):
                    y = self._fn(x)
                with span("request_copy_out"):
                    return y.float().cpu().numpy()


def load_serving_bundle(path: str,
                        device: str | torch.device | None = None) -> ServingModel:
    return ServingModel(path, device=device)
