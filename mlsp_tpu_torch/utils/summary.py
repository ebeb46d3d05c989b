"""Parameter counts per top-level module (counterpart of
`mlsp_tpu/utils/summary.py`, the torchsummary printout of
`PointSegDA/trainer.py:199`).

Only trainable parameters count: the density head's frozen bins
(`Density_cls.fc2.weight`) are a constant in the JAX package, so both
packages give the same total.
"""

from __future__ import annotations

import torch


def model_summary(model: torch.nn.Module) -> str:
    """A printable table of each top-level module's trainable parameters
    and the total."""
    lines = ["-" * 46, f"{'Module':<30}{'Params':>14}", "-" * 46]
    total = 0
    for name, sub in sorted(model.named_children()):
        n = sum(p.numel() for p in sub.parameters() if p.requires_grad)
        total += n
        lines.append(f"{name:<30}{n:>14,}")
    lines += ["-" * 46, f"{'Total params':<30}{total:>14,}", "-" * 46]
    return "\n".join(lines)
