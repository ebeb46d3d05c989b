"""The comparisons that decide `correct`.

Training: each of the first steps' loss against the reference's; the
first gradient as the optimizer took it, and the parameters' change over
the first steps, each by its worst leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. A leaf whose reference
gradient is under a thousandth of the median leaf's moves by round-off
alone under Adam and is left out of the change.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3  # of the median leaf's gradient norm


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items() if v is not None}


def leaf_gaps(prog: dict, ref: dict, names) -> tuple[float, str]:
    """(the worst leaf's gap of norms, its name) over `names`; a leaf
    that one side lacks reads 1."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn[k] for k in names if k in rn)
    worst, at = 0.0, ""
    for k in names:
        if (k in pn) != (k in rn):
            gap = 1.0
        elif k not in rn:
            continue
        else:
            gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def median_gap(prog: dict, ref: dict) -> float:
    """The median leaf's gap of norms (each over the larger of its own and
    the median leaf's reference norm)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return statistics.median(abs(pn.get(k, 0.0) - rn[k]) / max(rn[k], med,
                                                              1e-30)
                             for k in rn)


def moving(ref_grads: dict, names) -> list[str]:
    """The leaves whose reference gradient is not negligible."""
    rn = _norms(ref_grads)
    med = statistics.median(rn[k] for k in names if k in rn)
    return [k for k in names if rn.get(k, 0.0) >= NEGLIGIBLE * med]


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap of the steps' losses."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))
