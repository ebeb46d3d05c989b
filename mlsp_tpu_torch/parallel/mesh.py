"""Data- and points-parallel training over `torch.distributed`
(counterpart of `mlsp_tpu/parallel/mesh.py`).

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

The `points` axis (`make_mesh(data=D, points=P)`, a world of D x P
ranks) splits each cloud's O(N^2) work by query rows, as the JAX
package's `P("data", "points")` constraint on the distance matrix does.
Rank r has data index r // P and points index r % P (JAX's device
layout); the ranks of one data index form a points group, and those of
one points index a data group. `Mesh.rank` and `Mesh.size` are the data
index and axis: every data collective (BatchNorm's statistics, the loss
normalisers, the metrics, the eval gathers) runs over the data group,
and every rank of a points group holds the same model, batch rows and
draws. Inside `points_sharding(mesh)` each O(N^2) producer (the kNN
graphs, radius counts, Chamfer and its indices, the ball query, the
collapse deformation, 3-NN interpolation) takes its rows of the queries
(`points_rows`: blocks of ceil(N / P)) and gathers the result over the
points group (`split_points`); a differentiable one goes through
`copy_to_points` (identity forward, cotangents summed over the group)
and `gather_from_points` (all-gather forward, this rank's rows of the
cotangent backward), so every rank ends its backward with the single
process's gradient. The gradients are then averaged over the whole world
(`all_reduce_grads`), which keeps the replicas of a points group bit-
equal where the card's atomics round their gradients apart. A run on a
points mesh computes what one process computes, up to rounding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, points) world as one rank sees it: its data index
    `rank` of `size`, its points index `points_rank` of `points`, the
    process group's backend ("nccl" or "gloo"), and its data group
    `group` (the ranks of its points index; None, the default world, when
    points is 1) and points group `points_group` (the ranks of its data
    index)."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    points: int = 1
    points_rank: int = 0
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    points_group: Any = dataclasses.field(default=None, compare=False,
                                          repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "points": self.points}


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
    """The (data, points) mesh of the initialised process group: data x
    points must equal the world size (`data` None takes world // points).
    Every rank builds every data and points group, in the same order.
    `device` is this rank's (default cuda:LOCAL_RANK)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_distributed)")
    world = dist.get_world_size()
    if points < 1:
        raise ValueError(f"mesh points axis {points} < 1")
    if data is None:
        data = world // points
    if data * points != world:
        raise ValueError(f"mesh data x points = {data}x{points} != world "
                         f"size {world}")
    rank = dist.get_rank()
    group = points_group = None
    if points > 1:
        for p in range(points):
            g = dist.new_group([d * points + p for d in range(data)])
            if p == rank % points:
                group = g
        for d in range(data):
            g = dist.new_group([d * points + p for p in range(points)])
            if d == rank // points:
                points_group = g
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(rank // points, data, torch.device(device),
                dist.get_backend(), points, rank % points, group, points_group)


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
    """Broadcast every parameter and buffer of `model` from global rank 0
    over the world, in place. The identity without a mesh."""
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
    """Every data rank's rows of `x`, concatenated in rank order, on every
    rank (an all-gather over the data group); `x` itself without a
    mesh."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
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
    """The sum of `t` over the data ranks of the active mesh,
    differentiable (the backward sums the cotangents over them); `t`
    itself outside `data_parallel`."""
    mesh = _ACTIVE
    if mesh is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=dist.group.WORLD if mesh.group is None
                      else mesh.group)


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
    """Average every gradient that is not None over every rank of the
    world, in one flattened all-reduce. Which gradients are None is the
    same on every rank: the recipe is. The ranks of a points group hold
    the same gradient (up to the rounding of the card's atomics), so this
    is the data ranks' average, and it leaves their replicas bit-equal."""
    if mesh is None:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.size * mesh.points
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def average_metrics(m: dict, mesh: Mesh | None) -> dict:
    """The step's 0-d loss terms (tensors on the device) averaged over the
    data ranks (one all-reduce): the single-process values, the same on
    every rank. Nothing here reads a value on the host, so a step graph
    holds it."""
    if mesh is None or not m:
        return m
    names = list(m)
    vals = torch.stack([m[k].float() for k in names])
    dist.all_reduce(vals, group=mesh.group)
    vals /= mesh.size
    return dict(zip(names, vals.unbind()))


# The points mesh whose O(N^2) producers split their rows now: the ops
# read it (`split_points`), as the JAX package's `pairwise_sqdist` reads
# its `points_sharding` context while a step traces.
_ACTIVE_POINTS: Mesh | None = None


@contextlib.contextmanager
def points_sharding(mesh: Mesh | None):
    """Split the block's O(N^2) producers over the points axis of `mesh`
    (nothing changes with None or a points axis of 1)."""
    global _ACTIVE_POINTS
    active = mesh if mesh is not None and mesh.points > 1 else None
    prev, _ACTIVE_POINTS = _ACTIVE_POINTS, active
    try:
        yield active
    finally:
        _ACTIVE_POINTS = prev


def active_points_mesh() -> Mesh | None:
    return _ACTIVE_POINTS


def points_rows(n: int, mesh: Mesh) -> tuple[int, int]:
    """(q0, nq): this rank's rows [q0, q0 + nq) of n, in blocks of
    ceil(n / points) in points order (the last blocks may be short or
    empty)."""
    per = -(-n // mesh.points)
    q0 = min(mesh.points_rank * per, n)
    return q0, min(per, n - q0)


def gather_points(t: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The points group's rows of t [B, nq, ...] (each rank's
    `points_rows(n, mesh)`) along dim 1: each padded to ceil(n / points)
    so that every rank sends one shape, all-gathered in points order and
    trimmed to n. No gradient (`gather_from_points` has one)."""
    per = -(-n // mesh.points)
    dtype = t.dtype
    t = (t.to(torch.uint8) if dtype == torch.bool else t).contiguous()
    if t.shape[1] < per:
        t = torch.cat([t, t.new_zeros((t.shape[0], per - t.shape[1],
                                       *t.shape[2:]))], 1)
    parts = [torch.empty_like(t) for _ in range(mesh.points)]
    dist.all_gather(parts, t, group=mesh.points_group)
    return torch.cat(parts, 1)[:, :n].to(dtype)


class _CopyToPoints(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the points
    group (each rank's holds the part its rows produced)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.points_group)
        return g, None


class _GatherFromPoints(torch.autograd.Function):
    """All-gather of the rows forward; the backward keeps this rank's
    rows of the cotangent."""

    @staticmethod
    def forward(ctx, rows, n, mesh):
        ctx.q0, ctx.nq = points_rows(n, mesh)
        return gather_points(rows, n, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.q0:ctx.q0 + ctx.nq].contiguous(), None, None


def copy_to_points(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToPoints.apply(x, mesh)


def gather_from_points(rows: torch.Tensor, n: int,
                       mesh: Mesh) -> torch.Tensor:
    return _GatherFromPoints.apply(rows, n, mesh)


def split_points(fn, x: torch.Tensor, *rest) -> torch.Tensor:
    """`fn(x, *rest)`, with each query row of x [B, N, ...] computed once
    over the active points mesh: each rank takes `fn(x[:, q0:q0 + nq],
    *rest)` on its rows (`points_rows`), a tensor [B, nq, ...], and the
    rows are all-gathered along dim 1 over the points group.
    Differentiable: the inputs go through `copy_to_points` and the result
    through `gather_from_points` where a gradient is recorded. Without an
    active points mesh, `fn(x, *rest)`."""
    mesh = _ACTIVE_POINTS
    if mesh is None:
        return fn(x, *rest)
    n = x.shape[1]
    q0, nq = points_rows(n, mesh)
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (x, *rest))
    if grad:
        x, *rest = (copy_to_points(t, mesh) if isinstance(t, torch.Tensor)
                    and t.requires_grad else t for t in (x, *rest))
    out = fn(x[:, q0:q0 + nq], *rest)
    if grad and out.requires_grad:
        return gather_from_points(out, n, mesh)
    return gather_points(out, n, mesh)
