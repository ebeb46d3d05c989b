"""Abort on a non-finite loss (counterpart of `mlsp_tpu/train/guard.py`).

The trainer checks each epoch's averaged loss terms; on the first
non-finite one it saves the state for a post-mortem, then raises.
"""

from __future__ import annotations

import os

import numpy as np

from mlsp_tpu_torch.utils import checkpoint


def check_finite_losses(meters_avg: dict, model, opt, sched, epoch: int,
                        io) -> None:
    """Raise FloatingPointError if an averaged loss term is not finite,
    after saving the train state to `{exp_dir}/nonfinite_crash.ckpt`."""
    bad = sorted(k for k, v in meters_avg.items() if not np.isfinite(v))
    if not bad:
        return
    path = os.path.join(io.path, "nonfinite_crash.ckpt")
    try:
        checkpoint.save_train_state(path, model, opt, sched, epoch,
                                    {"nonfinite_terms": ",".join(bad)})
        saved = f"; state saved to {path}"
    except (OSError, RuntimeError) as e:  # the report must not mask the crash
        saved = f"; state save failed ({e})"
    msg = (f"non-finite loss at epoch {epoch}: {', '.join(bad)} (training "
           f"diverged: lower the lr or check the input data){saved}")
    io.cprint(msg)
    raise FloatingPointError(msg)
