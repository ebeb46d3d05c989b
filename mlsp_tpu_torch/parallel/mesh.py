"""Data-parallel training over `torch.distributed` (counterpart of
`mlsp_tpu/parallel/mesh.py`).

The JAX package shards each batch over the `data` axis of a device mesh
and replicates the parameters; XLA all-reduces the gradients, and a mean
over the batch axis (BatchNorm's statistics, a loss's normaliser) is a
mean over the *global* batch. A run on a mesh is the same program on the
global batch. The port keeps that contract with one process per card
(`torchrun`), NCCL between cards and gloo on the CPU:

- every rank holds the global batch and draws its random transforms from
  the same generator, then forwards its own rows (`shard_batch`: a
  contiguous block, as JAX's `P("data")` lays them out);
- inside `data_parallel(mesh)` BatchNorm takes its statistics over the
  global rows, dropout keeps the rank's rows of the global batch's mask,
  and count-normalised losses divide by the global count (`global_sum`,
  `global_count`; differentiable, so the backward sums across ranks);
- after the backward, one flattened all-reduce averages the gradients
  (`all_reduce_grads`), and the loss terms are averaged for the metrics
  and the non-finite guard (`average_metrics`).

On the card (NCCL) a chunk of `scan_steps` steps replays one captured
CUDA graph of the step with its collectives inside (`train.graphs`); the
graph's warm-up runs them first, so each communicator exists before the
capture. Gloo ranks take their chunks eagerly.

Each rank's loss is R times its share of the single-process loss (a mean
over its rows, or a sum over the global count divided by R), so the
averaged gradient is the single process's, up to the rounding of the
cross-rank sums. Eval forwards split their batches over the ranks and
gather the logits on every rank (`fetch_global`), so metrics, model
selection and SPST's pseudo-labels are the same everywhere.

A `points` axis (the JAX package's sharding of one cloud's O(N^2)
distances over chips) has no port: `make_mesh(points>1)` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel world as one rank sees it, with its process
    group's backend ("nccl" or "gloo")."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "points": 1}


def captures(mesh: Mesh | None) -> bool:
    """Whether a CUDA graph can hold a step taken as a rank of `mesh`:
    without a mesh, or with NCCL's collectives (NCCL >= 2.9.6 captures
    them, once each communicator exists). Gloo's run on the host and
    cannot be captured."""
    return mesh is None or mesh.backend == "nccl"


def init_distributed(backend: str | None = None, timeout_s: int = 30) -> None:
    """Join the process group that `torchrun` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). `backend`:
    "nccl" for cards, "gloo" for the CPU; None picks NCCL where a card is
    present. `timeout_s` bounds every collective, so a rank whose peer died
    raises instead of hanging (the JAX package's 30 s heartbeat)."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {', '.join(missing)} not set; "
                           "launch with torchrun")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_local_world(backend: str, timeout_s: int = 30) -> None:
    """A world of one process on a free local port: `--mesh_data 1` without
    torchrun."""
    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(data: int | None = None, points: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh of the initialised process group. `data` must equal the
    world size (None takes it); `device` is this rank's (default
    cuda:LOCAL_RANK)."""
    if points != 1:
        raise NotImplementedError(
            "a points mesh axis (--mesh_points > 1) is not ported: it shards "
            "one cloud's O(N^2) distances over chips, which no cloud of the "
            "recipes needs on one card (see ROADMAP.md)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_distributed)")
    size = dist.get_world_size()
    if data is not None and data != size:
        raise ValueError(f"mesh data axis {data} != world size {size}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(dist.get_rank(), size, torch.device(device),
                dist.get_backend())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh | None, tree):
    """This rank's rows of every tensor or array in `tree` (a contiguous
    block of the leading axis); 0-d values are shared as they are. The
    identity without a mesh."""
    if mesh is None:
        return tree

    def rows(t):
        if not isinstance(t, (torch.Tensor, np.ndarray)) or t.ndim == 0:
            return t
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{mesh.size} ranks")
        b = n // mesh.size
        return t[mesh.rank * b:(mesh.rank + 1) * b]

    return _tree_map(rows, tree)


@torch.no_grad()
def replicate(mesh: Mesh | None, model: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `model` from rank 0, in
    place. The identity without a mesh."""
    if mesh is not None:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


def replicate_for_mesh(mesh: Mesh | None, state: torch.nn.Module,
                       batch_size: int) -> torch.nn.Module:
    """Trainer entry: check that the batch splits over the `data` axis,
    then replicate the model. The identity without a mesh."""
    if mesh is None:
        return state
    n_data = mesh.shape["data"]
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the mesh "
            f"data axis ({n_data} devices)"
        )
    return replicate(mesh, state)


def fetch_global(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Every rank's rows of `x`, concatenated in rank order, on every rank
    (an all-gather); `x` itself without a mesh."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


# The mesh whose forwards run now: BatchNorm, dropout and the losses read
# it while a step runs (`data_parallel`), as the JAX package's
# `points_sharding` context is read while a step traces.
_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Run the block's forwards and losses as one rank of `mesh` (nothing
    changes with None)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active_mesh() -> Mesh | None:
    return _ACTIVE


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks of the active mesh, differentiable
    (the backward sums the cotangents over the ranks); `t` itself outside
    `data_parallel`."""
    mesh = _ACTIVE
    if mesh is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def global_count(count: torch.Tensor, floor: float) -> torch.Tensor:
    """A loss normaliser: the batch-wide `count`, at least `floor`, over
    the number of ranks (`count.clamp_min(floor)` without a mesh). A rank
    dividing its own sum by it holds R times its share of the
    single-process loss, as a mean over its rows does."""
    mesh = _ACTIVE
    if mesh is None:
        return count.clamp_min(floor)
    return global_sum(count).clamp_min(floor) / mesh.size


@torch.no_grad()
def all_reduce_grads(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Average every gradient that is not None over the ranks, in one
    flattened all-reduce. Which gradients are None is the same on every
    rank: the recipe is."""
    if mesh is None:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def average_metrics(m: dict, mesh: Mesh | None) -> dict:
    """The step's 0-d loss terms (tensors on the device) averaged over the
    ranks (one all-reduce): the single-process values, the same on every
    rank. Nothing here reads a value on the host, so a step graph holds
    it."""
    if mesh is None or not m:
        return m
    names = list(m)
    vals = torch.stack([m[k].float() for k in names])
    dist.all_reduce(vals)
    vals /= mesh.size
    return dict(zip(names, vals.unbind()))


class points_sharding(contextlib.nullcontext):
    """The JAX package's points-axis context; a no-op here (no points
    axis)."""

    def __init__(self, mesh: Mesh | None = None):
        super().__init__(None)


def active_points_mesh() -> None:
    return None
