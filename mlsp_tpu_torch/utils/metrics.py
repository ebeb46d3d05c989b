"""Classification and segmentation metrics in numpy (a copy of
`mlsp_tpu/utils/metrics.py`). Semantics of the reference's sklearn calls
(`utils/log.py:48-59`, `PointSegDA/trainer.py:224-233`): balanced accuracy
is the mean per-class recall over the classes present in y_true; the seg
mIoU of a shape is the macro IoU over the labels in its truth or
prediction.
"""

from __future__ import annotations

import numpy as np


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
