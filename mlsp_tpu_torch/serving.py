"""Serving bundles (counterpart of `mlsp_tpu/serving.py`).

    bundle/
      weights.pt   the model's state_dict (the port's layout)
      meta.json    model name and config, shape and format metadata

The JAX package freezes its eval program as StableHLO, which cannot be
read without JAX. This bundle holds only weights: `ServingModel` rebuilds
the model from this package and loads them strictly. `meta["format"]`
names the format.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mlsp_tpu_torch.models import SEG_MODELS, make_model

FORMAT = "mlsp_tpu_torch/state_dict-v1"
_WEIGHTS_FILE = "weights.pt"
_META_FILE = "meta.json"


def save_serving_bundle(model, path: str, num_points: int = 1024,
                        num_class: int = 10) -> dict:
    """Write `model` (a port PointDA classifier of any family) as a
    serving bundle directory: its weights, its name and its constructor
    config, from which `ServingModel` rebuilds it. The bundle serves any
    batch size; the point count is fixed. A segmenter raises
    NotImplementedError (segmentation bundles: ROADMAP.md)."""
    if model.NAME in SEG_MODELS:
        raise NotImplementedError(
            f"serving bundles for the segmenter {model.NAME!r} are not "
            "ported yet (see ROADMAP.md)")
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, _WEIGHTS_FILE))
    meta = {"task": "pointda", "model": model.NAME,
            "model_kwargs": model.config,
            "batch_size": None, "num_points": num_points,
            "num_class": num_class, "format": FORMAT}
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ServingModel:
    """A loaded bundle: `predict(x)` returns class logits.

    Runs on `device`, the CUDA card if None (raises without one).
    """

    def __init__(self, path: str, device: str | torch.device | None = None):
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} bundle "
                             f"(format {self.meta.get('format')!r})")
        self.model = make_model(self.meta["model"], self.meta["num_class"],
                                device=device, **self.meta["model_kwargs"])
        self.device = next(self.model.parameters()).device
        state = torch.load(os.path.join(path, _WEIGHTS_FILE),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state, strict=True)

    def predict(self, x) -> np.ndarray:
        """x [B, N, 3] (numpy or tensor) -> class logits [B, num_class]."""
        N = self.meta["num_points"]
        if x.ndim != 3 or tuple(x.shape[1:]) != (N, 3):
            raise ValueError(
                f"bundle expects ('any', {N}, 3) inputs, got {tuple(x.shape)}")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self.model(x)["cls"].cpu().numpy()


def load_serving_bundle(path: str,
                        device: str | torch.device | None = None) -> ServingModel:
    return ServingModel(path, device=device)
