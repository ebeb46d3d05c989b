"""Classification metrics in numpy (a copy of the classification part of
`mlsp_tpu/utils/metrics.py`; the segmentation metrics come with the
PointSegDA slice). Semantics of the reference's sklearn calls
(`utils/log.py:48-59`): balanced accuracy is the mean per-class recall over
the classes present in y_true.
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
