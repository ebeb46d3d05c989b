"""Optimizers and learning-rate schedules of the train steps (counterpart of
`mlsp_tpu/train/state.py`).

- ADAM: `torch.optim.Adam(lr, weight_decay=wd)` adds wd·param to the
  gradient before the moment updates, the coupled L2 decay of the
  reference (`PointDA/trainer.py:258-260`), which the JAX package builds
  as `add_decayed_weights` placed before `scale_by_adam`.
- SGD: `add_decayed_weights → trace(momentum) → scale_by_lr` in JAX, which
  is `torch.optim.SGD(momentum, weight_decay=wd)` with no dampening and
  no Nesterov term.
- ADAMW: `scale_by_adam`, then decoupled decay of the parameters with more
  than one dimension (not biases or BatchNorm), then `scale_by_lr`: torch's
  AdamW over two parameter groups, the second without decay.

The trainers' learning rate follows a cosine over epochs, stepped once per
epoch (`CosineAnnealingLR(T_max=epochs)`), or with `scheduler="step"` a
StepLR, each written as a per-step `LambdaLR`. SPST sets its learning
rate once per epoch instead (`set_learning_rate`), from torch's cosine in
closed form, unclamped (`torch_cosine_lr`).

Heads that no loss of the recipe reads keep `grad=None` when the step
clears gradients with `zero_grad(set_to_none=True)`, so every optimizer
here skips them, weight decay and momentum included: the freeze the JAX
package builds with `untrained_decay_mask`. A zero gradient instead would
let the decay term move them.

On the card every optimizer can be captured into a step graph
(`train.graphs`): Adam and AdamW are built with `capturable=True` (their
step counts live on the card) in torch's multi-tensor form, SGD with
`fused=True`, and each with its learning rate as a float32 0-d tensor on
the card, which the schedulers and `set_learning_rate` fill in place, so
that a replay reads the current LR. The capturable Adam update divides
by the LR, but only after it adds eps: at LR 0 (SPST's cosine reaches
it) it leaves every parameter as it is, one whose second moment is 0
too. On the CPU the LR is a float, as before.
"""

from __future__ import annotations

import math

import torch

OPTIMIZERS = ("ADAM", "SGD", "ADAMW")


def cosine_per_epoch(epochs: int, steps_per_epoch: int):
    """LR factor at optimizer step `step`:
    (1 + cos(π · min(step // steps_per_epoch, epochs) / epochs)) / 2."""

    def factor(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1), epochs)
        return 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return factor


def step_schedule(decay_epochs: int, decay_rate: float,
                  steps_per_epoch: int):
    """StepLR's factor at optimizer step `step` (the reference's
    `build_opti_sche` StepLR path): decay_rate ** (epoch // decay_epochs)."""

    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return decay_rate ** (epoch // decay_epochs)

    return factor


def torch_cosine_lr(base_lr: float, t_max: int, epoch: int) -> float:
    """torch `CosineAnnealingLR(T_max=t_max)` in closed form at scheduler
    step `epoch`, deliberately NOT clamped at t_max: torch's schedule is
    periodic, so past T_max the LR rises back toward `base_lr`. SPST
    creates the scheduler once with T_max=epochs and steps it every epoch
    of every round (`train_spst.py:163,501`), so round 2's LR climbs
    again. The closed form, not torch's recursive scheduler, which drifts
    from it in float."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / t_max))


def _check_name(name: str) -> str:
    name = name.upper()
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r}: expected one of {OPTIMIZERS}")
    return name


def _build(params: list, name: str, lr: float, wd: float,
           momentum: float) -> torch.optim.Optimizer:
    dev = params[0].device if params else torch.device("cpu")
    card = dev.type == "cuda"
    # on the card: the LR as a tensor, filled in place (`set_learning_rate`)
    lr_arg = torch.full((), lr, device=dev) if card else lr
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr_arg, momentum=momentum,
                               dampening=0.0, weight_decay=wd,
                               nesterov=False, fused=card or None)
    if name == "ADAMW":
        decay = [p for p in params if p.ndim > 1]
        rest = [p for p in params if p.ndim <= 1]
        return torch.optim.AdamW(
            [{"params": decay, "weight_decay": wd},
             {"params": rest, "weight_decay": 0.0}],
            lr=lr_arg, betas=(0.9, 0.999), eps=1e-8, capturable=card,
            foreach=card or None)
    return torch.optim.Adam(params, lr=lr_arg, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd, capturable=card,
                            foreach=card or None)


def make_optimizer(model: torch.nn.Module, lr: float, wd: float, epochs: int,
                   steps_per_epoch: int, name: str = "ADAM",
                   momentum: float = 0.9, scheduler: str = "cos",
                   decay_epochs: int = 50, decay_rate: float = 0.5
                   ) -> tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer `name` (ADAM, SGD or ADAMW; see the module docstring)
    over the model's trainable parameters, and its schedule: "cos" the
    per-epoch cosine, "step" StepLR (x decay_rate every decay_epochs),
    anything else a constant LR. Call `sched.step()` after every
    `opt.step()`."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = _build(params, _check_name(name), lr, wd, momentum)
    if scheduler == "cos":
        factor = cosine_per_epoch(epochs, steps_per_epoch)
    elif scheduler == "step":
        factor = step_schedule(decay_epochs, decay_rate, steps_per_epoch)
    else:
        def factor(step: int) -> float:
            return 1.0
    for group in opt.param_groups:
        # a float base LR, whatever the group's LR is (a tensor on the card)
        group["initial_lr"] = lr
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def make_epoch_lr_optimizer(model: torch.nn.Module, name: str, lr: float,
                            wd: float, momentum: float
                            ) -> torch.optim.Optimizer:
    """An optimizer without a scheduler, for a trainer that sets the LR
    once per epoch whatever its number of steps (`set_learning_rate`):
    SPST, whose epochs take as many steps as its selection allows. SGD, or
    Adam with coupled L2 for ADAM and ADAMW alike, as the JAX package's
    `make_epoch_lr_optimizer` and the reference's `train_spst.py` build it."""
    name = _check_name(name)
    params = [p for p in model.parameters() if p.requires_grad]
    return _build(params, "SGD" if name == "SGD" else "ADAM", lr, wd,
                  momentum)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the LR of every parameter group of `opt` (in place where it is
    a tensor)."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def lr_tensors(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    """The distinct LR tensors of `opt`'s parameter groups (groups built
    together share one). Raises ValueError for a float LR: a step graph
    would hold it as a constant."""
    out = []
    for group in opt.param_groups:
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor):
            raise ValueError("the optimizer's LR is a float: build it with "
                             "make_optimizer on the card")
        if not any(lr is t for t in out):
            out.append(lr)
    return out
