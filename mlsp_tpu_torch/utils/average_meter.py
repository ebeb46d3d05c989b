"""Running means of the trainer's loss terms (a copy of
`mlsp_tpu/utils/average_meter.py`): host floats in, sample-weighted means
out, in the order the steps ran."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Sample-weighted running mean of one scalar metric."""

    __slots__ = ("val", "sum", "count")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0  # most recent value
        self.sum = 0.0
        self.count = 0.0

    def update(self, value: float, n: float = 1.0) -> None:
        self.val = float(value)
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MeterDict:
    """One `AverageMeter` per metric name, fed from step metric dicts of
    scalars or [S]-shaped arrays (S steps, each weighted by `n` samples)."""

    def __init__(self):
        self._meters: dict[str, AverageMeter] = {}

    def __getitem__(self, name: str) -> AverageMeter:
        return self._meters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._meters

    def update(self, metrics: dict, n: float = 1.0) -> None:
        for name, v in metrics.items():
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            self._meters.setdefault(name, AverageMeter()).update(
                float(arr.mean()), n * arr.size)

    def averages(self) -> dict[str, float]:
        return {name: m.avg for name, m in self._meters.items()}
