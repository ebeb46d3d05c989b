"""Optimizer and schedule of the PointDA train step (counterpart of
`mlsp_tpu/train/state.py`).

`torch.optim.Adam(lr, weight_decay=wd)` adds wd·param to the gradient
before the moment updates: the coupled L2 decay of the reference
(`PointDA/trainer.py:258-260`), which the JAX package builds as
`add_decayed_weights` placed before `scale_by_adam`. The learning rate
follows a cosine over epochs, stepped once per epoch
(`CosineAnnealingLR(T_max=epochs)`), written as a per-step `LambdaLR`.

Heads that no loss of the recipe reads (the scan head of the paper recipe)
keep `grad=None` when the step clears gradients with
`zero_grad(set_to_none=True)`, so Adam skips them: the freeze the JAX
package builds with `untrained_decay_mask`. A zero gradient instead would
let the L2 term move them.
"""

from __future__ import annotations

import math

import torch


def cosine_per_epoch(epochs: int, steps_per_epoch: int):
    """LR factor at optimizer step `step`:
    (1 + cos(π · min(step // steps_per_epoch, epochs) / epochs)) / 2."""

    def factor(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1), epochs)
        return 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return factor


def make_optimizer(model: torch.nn.Module, lr: float, wd: float, epochs: int,
                   steps_per_epoch: int
                   ) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (betas 0.9, 0.999, eps 1e-8, coupled L2 `wd`) over the model's
    trainable parameters, and its per-epoch cosine schedule; call
    `sched.step()` after every `opt.step()`."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=wd)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, cosine_per_epoch(epochs, steps_per_epoch))
    return opt, sched
