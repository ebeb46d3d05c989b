"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` if given, else the CUDA card.

    Without a card and without an explicit device this raises: an entry
    point never carries on silently on the CPU. Pass device="cpu" for that.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def process_index() -> int:
    """This process's rank in an initialised `torch.distributed` group,
    else 0. Only rank 0 writes experiment files and checkpoints."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
