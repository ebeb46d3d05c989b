"""Classification and segmentation metrics. Semantics of the reference's
sklearn calls (`utils/log.py:48-59`, `PointSegDA/trainer.py:224-233`):
balanced accuracy is the mean per-class recall over the classes present in
y_true; the seg mIoU of a shape is the macro IoU over the labels in its
truth or prediction.

Where each number is computed: everything but `seg_stats` is numpy on the
host, a copy of `mlsp_tpu/utils/metrics.py` (classification eval, SPST
selection, `run_infer`, the seg train mIoU, and the JAX-parity tests).
The seg eval (`pointsegda_trainer.evaluate_seg`) reduces its fetched
logits on the model's device with `seg_stats` to per-cloud loss sums and
integer counts, fetches those, and finishes the mIoU and accuracy on the
host with `seg_sums`, equal bit for bit to `seg_metrics` on the same
predictions.
"""

from __future__ import annotations

import numpy as np
import torch


def log_softmax_np(logits: np.ndarray) -> np.ndarray:
    """Numerically stable log-softmax over the last axis."""
    m = logits.max(-1, keepdims=True)
    e = logits - m
    return e - np.log(np.exp(e).sum(-1, keepdims=True))


def softmax_np(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if y_true.size else 0.0


def balanced_accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    recalls = [(y_pred[y_true == c] == c).mean() for c in np.unique(y_true)]
    return float(np.mean(recalls)) if recalls else 0.0


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def jaccard_macro(y_true, y_pred) -> float:
    """Macro-averaged IoU over the labels present in y_true or y_pred
    (sklearn `jaccard_score(average="macro")` with its default labels)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(np.unique(y_true), np.unique(y_pred))
    ious = []
    for c in labels:
        inter = ((y_true == c) & (y_pred == c)).sum()
        union = ((y_true == c) | (y_pred == c)).sum()
        ious.append(inter / union if union else 0.0)
    return float(np.mean(ious)) if ious else 0.0


def seg_metrics(labels, preds) -> tuple[float, float]:
    """Sums over the batch's shapes of the per-shape mIoU and accuracy of
    labels and preds [B, N]; the caller divides by the sample count."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    miou = acc = 0.0
    for b in range(labels.shape[0]):
        miou += jaccard_macro(labels[b], preds[b])
        acc += (labels[b] == preds[b]).mean()
    return miou, acc


def seg_stats(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-cloud statistics [..., 2 + 3C] float64 of logits [..., N, C]
    and integer labels [..., N], computed where they are: the sum over
    the points of -log_softmax(logits)[label] in float64, the count of
    points whose argmax (the first maximum) is the label, then for each
    part c < C the points predicted c and labelled c, predicted c, and
    labelled c. The counts are exact in float64; integer and fixed-shape
    reductions only, so equal inputs give equal bits on the card."""
    y = labels.long()
    logp = torch.log_softmax(logits.double(), -1)
    nll = -logp.gather(-1, y[..., None])[..., 0].sum(-1, keepdim=True)
    pred = logits.argmax(-1)
    parts = torch.arange(logits.shape[-1], device=logits.device)
    p1, y1 = pred[..., None] == parts, y[..., None] == parts
    counts = torch.cat([(pred == y).sum(-1, keepdim=True),
                        (p1 & y1).sum(-2), p1.sum(-2), y1.sum(-2)], -1)
    return torch.cat([nll, counts.double()], -1)


def seg_sums(stats: np.ndarray, num_points: int) -> tuple[float, float,
                                                          float]:
    """Sums over the clouds of `seg_stats` [B, 2 + 3C] of the loss (the
    per-point losses' sum), the per-cloud mIoU and accuracy: the last two
    in `seg_metrics`' arithmetic (the IoU over the parts in the cloud's
    truth or prediction, int64 over int64, their `np.mean`), so equal to
    it bit for bit on the same predictions."""
    C = (stats.shape[-1] - 2) // 3
    counts = stats[:, 1:].astype(np.int64)
    correct = counts[:, 0]
    inter, pred_n, true_n = (counts[:, 1:1 + C], counts[:, 1 + C:1 + 2 * C],
                             counts[:, 1 + 2 * C:])
    union = pred_n + true_n - inter
    miou = acc = 0.0
    for b in range(stats.shape[0]):
        present = union[b] > 0
        miou += float(np.mean(inter[b][present] / union[b][present]))
        acc += correct[b] / num_points
    return float(np.sum(stats[:, 0])), miou, acc
