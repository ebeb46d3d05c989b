"""Standalone checkpoint evaluation, batch inference and export
(counterpart of `mlsp_tpu/train/evaluation.py`): `run_eval` reports a
split's metrics, `run_infer` writes per-cloud (PointDA) or per-point
(PointSegDA) predictions and class probabilities to an .npz, `run_export`
writes a reference-loadable `model.pt`. The port serves
`task="pointda"` with every PointDA family (dgcnn, pointnet, pointnet2,
point_transformer, hengshuang, vit, and the JAX aliases) and
`task="pointsegda"` with `dgcnn_seg` and `hengshuang_seg`, building each
model as `mlsp_tpu/train/evaluation.py::_build_model` does
(`models.model_kwargs`: `--knn_backend` reaches every family that builds
a graph or samples points). The weights come from the port's own
checkpoint, a JAX `.ckpt` or, with `--from_torch`, a reference
`model.pt` (`utils/checkpoint.py::load_model_weights`). The forwards of `run_eval`
and `run_infer` go through the scanned eval (`steps.scan_in_chunks`: on
the card one captured graph of the eval forward, replayed once a batch).
`run_aot_export` freezes the eval forward into an AOT serving bundle
(`serving`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mlsp_tpu_torch import serving
from mlsp_tpu_torch.data.pointda import idx_to_label, load_pointda
from mlsp_tpu_torch.data.pointsegda import load_pointsegda
from mlsp_tpu_torch.models import (
    SEG_MODELS,
    canonical_name,
    make_model,
    model_kwargs,
)
from mlsp_tpu_torch.train.pointda_trainer import (
    eval_batches,
    eval_logits,
    evaluate,
)
from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
from mlsp_tpu_torch.utils import checkpoint, metrics, reference_export
from mlsp_tpu_torch.utils.config import EvalConfig
from mlsp_tpu_torch.utils.device import resolve_device
from mlsp_tpu_torch.utils.logging import IOStream


def _setup(cfg: EvalConfig, io: IOStream):
    """The split and the model with the checkpoint's weights. Returns
    (model, data, label, indices): `indices` picks the train or val part
    of the PointDA train partition (`dataloader.py:70-73`), None for its
    test partition and for every PointSegDA split (a partition of its
    own)."""
    if cfg.task not in ("pointda", "pointsegda"):
        raise ValueError(f"unknown task {cfg.task!r}")
    seg = cfg.task == "pointsegda"
    if (canonical_name(cfg.model) in SEG_MODELS) != seg:
        raise ValueError(f"model={cfg.model!r} does not serve "
                         f"task={cfg.task!r}")
    device = resolve_device(cfg.device or None)
    if seg:
        ds = load_pointsegda(cfg.dataset, cfg.dataroot, cfg.split,
                             cfg.synthetic, cfg.num_points)
        indices = None
    else:
        partition = "train" if cfg.split in ("train", "val") else "test"
        ds = load_pointda(cfg.dataset, cfg.dataroot, partition,
                          cfg.num_points, cfg.synthetic, cfg.seed,
                          device=device)
        indices = {"train": ds.train_ind, "val": ds.val_ind}.get(cfg.split)
    return _load_model(cfg, io, device), ds.data, ds.label, indices


def _load_model(cfg: EvalConfig, io: IOStream, device=None,
                aot: bool = False):
    """The model with the weights of `cfg.model_file` (the port's format,
    a JAX `.ckpt`, or with `from_torch` a reference `model.pt`). With
    `aot`, a DGCNN takes the "moments" EdgeConv route, as the JAX
    package pins it for its bundles."""
    kw = model_kwargs(cfg)
    if aot and canonical_name(cfg.model) == "dgcnn":
        kw["edge_impl"] = "moments"
    model = make_model(cfg.model, cfg.num_class,
                       device=device or resolve_device(cfg.device or None),
                       **kw)
    checkpoint.load_model_weights(model, cfg.model_file, cfg.from_torch)
    io.cprint(f"loaded {cfg.model_file}"
              + (" (reference torch state_dict)" if cfg.from_torch else ""))
    return model


def run_eval(cfg: EvalConfig, io: IOStream | None = None) -> dict:
    """Evaluate a checkpoint on one split; returns the metrics (also
    printed as one JSON line)."""
    cfg = cfg.resolved()
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    model, data, label, indices = _setup(cfg, io)
    if cfg.task == "pointsegda":
        loss, miou, acc = evaluate_seg(model, data, label,
                                       cfg.test_batch_size)
        result = {"dataset": cfg.dataset, "split": cfg.split,
                  "loss": round(float(loss), 6), "miou": round(float(miou), 6),
                  "acc": round(float(acc), 6)}
        io.cprint(json.dumps(result))
        return result
    r = evaluate(model, data, label, cfg.test_batch_size, cfg.num_class,
                 indices)
    io.cprint("Confusion matrix:\n" + str(r["conf_mat"]))
    io.save_conf_mat(r["conf_mat"], "eval_conf_mat.csv", "Eval",
                     class_names=[idx_to_label.get(i, str(i))
                                  for i in range(cfg.num_class)])
    result = {"dataset": cfg.dataset, "split": cfg.split,
              "acc": round(float(r["acc"]), 6),
              "balanced_acc": round(float(r["balanced_acc"]), 6),
              "loss": round(float(r["loss"]), 6)}
    io.cprint(json.dumps(result))
    return result


def run_infer(cfg: EvalConfig, io: IOStream | None = None) -> dict:
    """Batch inference over one split: writes `pred` [M] int64, `prob`
    [M, num_class] float32 (softmax), `label` [M] and `index` [M] (the
    dataset index of each row) to `cfg.output` (default
    `{exp_dir}/predictions.npz`); for PointSegDA `pred` [M, N], `prob`
    [M, N, num_class] and `label` [M, N]. Returns a summary (also printed
    as one JSON line), whose accuracy is per cloud or per point."""
    cfg = cfg.resolved()
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    model, data, label, indices = _setup(cfg, io)
    sels, counts = eval_batches(label.shape[0], cfg.test_batch_size, indices)
    if not sels:
        raise ValueError("run_infer: empty split")
    logits = eval_logits(model, data, sels,
                         "seg" if cfg.task == "pointsegda" else "cls")
    logits = np.concatenate([lg[:n] for lg, n in zip(logits, counts)])
    order = np.concatenate([sel[:n] for sel, n in zip(sels, counts)])
    pred = logits.argmax(-1).astype(np.int64)
    true = label[order]

    out_path = cfg.output or os.path.join(io.path, "predictions.npz")
    np.savez_compressed(out_path, pred=pred,
                        prob=np.exp(metrics.log_softmax_np(logits)),
                        label=true, index=order)
    summary = {"output": out_path, "dataset": cfg.dataset, "split": cfg.split,
               "n": int(pred.shape[0]),
               "acc": round(float(np.mean(pred == true)), 6)}
    io.cprint(json.dumps(summary))
    return summary


def run_export(cfg: EvalConfig, io: IOStream | None = None) -> dict:
    """Export a checkpoint as a reference-loadable torch `model.pt`
    (`cfg.output`, default `{exp_dir}/model.pt`), the inverse of
    `--from_torch`: from the port's own checkpoint, a JAX `.ckpt` or, with
    `--from_torch`, a reference `model.pt` (a normaliser). Every family is
    strict-loadable by the reference but PointTransformer (backbone and
    classifier head: the reference loads it with strict=False). Returns
    {"output", "model", "keys"} (also printed as one JSON line)."""
    cfg = cfg.resolved()
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    if canonical_name(cfg.model) not in reference_export.FAMILIES:
        raise ValueError(
            "export supports dgcnn/pointnet/dgcnn_seg/point_transformer/"
            f"hengshuang/hengshuang_seg, not {cfg.model!r}")
    if (canonical_name(cfg.model) in SEG_MODELS) != (
            cfg.task == "pointsegda"):
        raise ValueError(
            f"model {cfg.model!r} does not belong to task {cfg.task!r}: "
            "seg backbones require --task pointsegda; classification "
            "backbones require --task pointda")
    sd = reference_export.export_state_dict(_load_model(cfg, io))
    out_path = cfg.output or os.path.join(io.path, "model.pt")
    reference_export.save(sd, out_path)
    summary = {"output": out_path, "model": cfg.model, "keys": len(sd)}
    io.cprint(json.dumps(summary))
    return summary


def run_aot_export(cfg: EvalConfig, io: IOStream | None = None) -> dict:
    """Freeze a checkpoint into an AOT serving bundle (`aot`), as
    `mlsp_tpu/train/evaluation.py::run_aot_export` does.

    Writes `cfg.output` (a directory; default `{exp_dir}/serving_bundle`)
    with the `torch.export` eval program and its metadata
    (`serving.save_aot_bundle`), then checks it: the bundle, reloaded,
    against the live model on a seeded batch of `test_batch_size`. The
    model is built with `knn_backend="torch"` whatever `cfg` says: the
    program holds the plain kNN and FPS, so one artifact serves on the
    CPU and on the card, as the JAX package forces its XLA kNN into its
    bundle, and a DGCNN the "moments" EdgeConv route, as the JAX package
    pins it. Returns the summary (also printed as one JSON line), with
    `selfcheck_max_diff`."""
    cfg = dataclasses.replace(cfg.resolved(), knn_backend="torch")
    io = io or IOStream(cfg.out_path, cfg.exp_name)
    model = _load_model(cfg, io, aot=True)
    out_dir = cfg.output or os.path.join(io.path, "serving_bundle")
    meta = serving.save_aot_bundle(model, out_dir, num_points=cfg.num_points,
                                   num_class=cfg.num_class)

    # self-check: the frozen program must reproduce the live model
    device = next(model.parameters()).device
    bundle = serving.load_serving_bundle(out_dir, device=device)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(
        (cfg.test_batch_size, cfg.num_points, 3)) * 0.5).astype(np.float32)
    frozen = bundle.predict(x)
    with torch.inference_mode():
        live = serving.EvalForward(model, cfg.task)(
            torch.from_numpy(x).to(device)).float().cpu().numpy()
    max_diff = float(np.abs(frozen - live).max())
    summary = {"output": out_dir, "model": cfg.model, "task": cfg.task,
               **meta, "selfcheck_max_diff": max_diff}
    # The two programs may round distances apart and flip a near-tie kNN
    # edge (the JAX package's allowance); a broken bundle is far off.
    if max_diff > 2e-2:
        raise RuntimeError(
            f"AOT bundle self-check failed: max diff {max_diff}")
    io.cprint(json.dumps(summary))
    return summary
