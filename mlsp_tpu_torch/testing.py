"""Check helpers shared by the port's tests and `chip_smoke.py`'s guards.

The library does not use them. They say how far two routes (the kernels
and the plain versions, or the port and the JAX package) may differ, and
let a second run reuse the first run's discrete choices (kNN graphs, FPS
orders), so that only rounding separates the two runs.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import queue
import socket
import time
import traceback
from unittest import mock

import numpy as np
import torch

from mlsp_tpu_torch.ops.knn import knn_gather

_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_fps = importlib.import_module("mlsp_tpu_torch.ops.fps")
_normals = importlib.import_module("mlsp_tpu_torch.ops.normals")

U32 = 2.0 ** -24  # float32 unit roundoff


def knn_set_gap(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
                rows: tuple[int, int] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gap, tol), each [B, N], for two neighbour-index sets [B, N, k] of
    x [B, N, C] (with `rows=(q0, nq)`, [B, nq, k] sets of the queries
    [q0, q0 + nq)): the largest difference of the rows' sorted float64
    distances, and the float32 rounding bound of the distance formula,
    4 (C + 3) u (‖q‖² + max_j ‖x_j‖²). Two correct float32 programs may
    pick different near ties, so rows within tol hold the same
    neighbourhood."""
    xd = x.double()
    q0, nq = (0, x.shape[1]) if rows is None else rows
    sq = xd.square().sum(-1)
    sq_q = sq[:, q0:q0 + nq]
    d = (sq_q[:, :, None] + sq[:, None, :]
         - 2 * xd[:, q0:q0 + nq] @ xd.transpose(1, 2))
    gap = (torch.sort(torch.gather(d, -1, got), -1).values
           - torch.sort(torch.gather(d, -1, want), -1).values).abs().amax(-1)
    tol = 4 * (x.shape[-1] + 3) * U32 * (sq_q + sq.amax(-1, keepdim=True))
    return gap, tol


def edge_grad_magnitude(u: torch.Tensor, idx: torch.Tensor,
                        cots) -> torch.Tensor:
    """Per element of du, the sum of the magnitudes of the terms the
    EdgeConv-statistics backward adds into it, |ds1_i| + |2 u_j ds2_i| +
    |dmx_i| / #ties + |dmn_i| / #ties over the points i that have j as a
    neighbour: the scale of du's rounding error. `cots` is (dmx, dmn) or
    (dmx, dmn, ds1, ds2)."""
    B, N, C = u.shape
    g = knn_gather(u.float(), idx)  # [B, N, k, C]
    per_edge = torch.zeros_like(g)
    for ext, cot in ((g.amax(-2, keepdim=True), cots[0]),
                     (g.amin(-2, keepdim=True), cots[1])):
        tie = g == ext
        per_edge += tie * (cot.abs()[:, :, None]
                           / tie.sum(-2, keepdim=True).clamp_min(1))
    if len(cots) == 4:
        per_edge += cots[2].abs()[:, :, None] + 2 * (g * cots[3][:, :, None]
                                                      ).abs()
    rows = (idx + N * torch.arange(B, device=u.device)[:, None, None]).flatten()
    out = torch.zeros(B * N, C, device=u.device)
    return out.index_add_(0, rows, per_edge.reshape(-1, C)).reshape(B, N, C)


def grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """Per gradient tensor, ‖got − want‖ over the larger of ‖want‖ and the
    norm a tensor of its size has at the RMS of all of `want`'s elements.
    The second term keeps a tensor whose exact gradient is 0 (a bias ahead
    of a train-mode BatchNorm: what is computed is rounding alone) from
    being held relative to its own rounding."""
    wd = {n: w.detach().double().cpu() for n, w in want.items()}
    count = sum(w.numel() for w in wd.values())
    rms = float((sum(w.square().sum() for w in wd.values()) / count).sqrt())
    gaps = {}
    for name, w in wd.items():
        scale = max(float(w.norm()), rms * w.numel() ** 0.5, 1e-30)
        gaps[name] = float((got[name].detach().double().cpu() - w).norm()
                           ) / scale
    return gaps


class Tape:
    """The discrete choices of one run, in call order: the kNN graphs it
    builds (K1's, K3's selection or the plain version's; on a points mesh
    a rank's query rows, `rows` (q0, nq), else None) and its FPS orders.
    `record()` takes them from a run; `replay()` hands them to a second
    run on the plain versions in the same order, and counts how many of
    that run's own choices differed."""

    def __init__(self, graphs=(), orders=()):
        self.graphs, self.orders = list(graphs), list(orders)
        self.rows = [None] * len(self.graphs)
        self.own_graph_rows_differ = self.own_order_entries_differ = 0
        # (x, k, K1's graph, rows) of each recorded K1 call
        self.knn_launches = []

    @contextlib.contextmanager
    def record(self):
        def keep(fn, into):
            def wrapped(*args):
                out = fn(*args)
                into.append(out)
                return out
            return wrapped

        knn_cuda, knn_torch = _knn.knn_cuda, _knn.knn_indices_torch

        def knn(x, k, *rows):
            idx = knn_cuda(x, k, *rows)
            self.graphs.append(idx)
            self.rows.append(rows[0] if rows else None)
            self.knn_launches.append((x, k, idx, self.rows[-1]))
            return idx

        def plain(x, k, *rows):
            idx = knn_torch(x, k, *rows)
            self.graphs.append(idx)
            self.rows.append(rows[0] if rows else None)
            return idx

        moments_cuda = _normals.knn_moments_cuda

        def moments(x, k):
            s1, s2, idx = moments_cuda(x, k, return_indices=True)
            self.graphs.append(idx)
            self.rows.append(None)
            return s1, s2

        with mock.patch.object(_knn, "knn_cuda", knn), \
                mock.patch.object(_knn, "knn_indices_torch", plain), \
                mock.patch.object(_normals, "knn_moments_cuda", moments), \
                mock.patch.object(_fps, "fps_cuda",
                                  keep(_fps.fps_cuda, self.orders)), \
                mock.patch.object(_fps, "fps_torch",
                                  keep(_fps.fps_torch, self.orders)):
            yield self

    def knn_against_plain(self) -> list[dict]:
        """Each recorded K1 graph against the plain kNN of the same input
        and rows (`knn_set_gap`): its shape, rows, k, the share of rows
        with equal indices and the largest distance gap over its rounding
        bound (a correct graph stays at or under 1)."""
        out = []
        for x, k, idx, rows in self.knn_launches:
            plain = _knn.knn_indices_torch(x, k, rows)
            gap, tol = knn_set_gap(x, idx, plain, rows)
            out.append({"shape": list(x.shape), "rows": rows, "k": k,
                        "rows_same_indices": float(
                            (idx == plain).all(-1).float().mean()),
                        "max_gap_over_tol": float((gap / tol).max())})
        return out

    @contextlib.contextmanager
    def replay(self):
        graphs, orders = iter(self.graphs), iter(self.orders)
        knn_torch, fps_torch = _knn.knn_indices_torch, _fps.fps_torch

        def take(it, what, like):
            want = next(it, None)
            if want is None or want.shape != like.shape:
                raise RuntimeError(f"replay: the run asks for a {what} of "
                                   f"shape {tuple(like.shape)} that the "
                                   f"recorded run did not build")
            return want.to(device=like.device, dtype=like.dtype)

        def knn(x, k, *rows):
            own = knn_torch(x, k, *rows)
            want = take(graphs, "kNN graph", own)
            self.own_graph_rows_differ += int(
                (own.sort(-1).values != want.sort(-1).values).any(-1).sum())
            return want

        def fps(xyz, npoint, start_idx):
            own = fps_torch(xyz, npoint, start_idx)
            want = take(orders, "FPS order", own)
            self.own_order_entries_differ += int((own != want).sum())
            return want

        with mock.patch.object(_knn, "knn_indices_torch", knn), \
                mock.patch.object(_fps, "fps_torch", fps):
            yield self
        if next(graphs, None) is not None or next(orders, None) is not None:
            raise RuntimeError("replay: the run left recorded choices unused")


# ---------------------------------------------------------------------------
# Data-parallel runs: ranks in processes of their own, and one train step
# that a rank and a single process take alike.
# ---------------------------------------------------------------------------


# Operators that read a tensor's value on the host (an item, a data-
# dependent shape, a tensor made from a Python value): on the card each is
# a copy and a wait that a CUDA graph capture refuses.
_HOST_SYNC_OPS = ("_local_scalar_dense", "nonzero", "lift_fresh",
                  "masked_select", "_unique2", "unique_dim",
                  "unique_consecutive", "equal", "repeat_interleave",
                  "bincount", "_assert_async")


def _caller() -> str:
    """file:line of the innermost frame outside torch and this module."""
    for frame in reversed(traceback.extract_stack()):
        if "/torch/" not in frame.filename and not frame.filename.endswith(
                "testing.py"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


def host_syncs(fn, *args, **kwargs) -> list[str]:
    """Run fn(*args, **kwargs) on the CPU and list the operators it
    dispatched that would make the card wait on the host (`_HOST_SYNC_OPS`):
    a step or forward with none can be captured into a CUDA graph."""
    from torch.utils._python_dispatch import TorchDispatchMode

    found = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in _HOST_SYNC_OPS:
                found.append(f"{name} at {_caller()}")
            return func(*args, **(kwargs or {}))

    with Watch():
        fn(*args, **kwargs)
    return found


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, points, port, backend, device, timeout_s, fn,
               args, q):
    from mlsp_tpu_torch import parallel

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    try:
        torch.set_num_threads(1)
        parallel.init_distributed(backend, timeout_s=timeout_s)
        mesh = parallel.make_mesh(world // points, points, device=device)
        q.put((rank, True, fn(mesh, *args)))
    except BaseException:  # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(world: int, fn, *args, backend: str = "gloo",
              device: str = "cpu", timeout_s: int = 60,
              points: int = 1) -> list:
    """`fn(mesh, *args)` on `world` spawned processes joined in one process
    group (`backend`, each on `device`) as a mesh of world / points data x
    `points` points ranks; their results (picklable, no tensors) by
    global rank. A rank that raises makes this raise with its traceback;
    every process is joined or killed before returning."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, points, port, backend, device, timeout_s, fn, args, q))
        for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, []
    deadline = time.monotonic() + 4 * timeout_s
    try:
        while len(results) < world and not failed:
            try:
                rank, ok, val = q.get(timeout=1)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    failed.append("ranks exited without a result (exit "
                                  f"codes {[p.exitcode for p in procs]})")
                elif time.monotonic() > deadline:
                    failed.append(f"no result within {4 * timeout_s} s")
                continue
            if ok:
                results[rank] = val
            else:
                failed.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=10 if failed else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError("\n".join(failed))
    return [results[r] for r in range(world)]


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@contextlib.contextmanager
def _loss_inputs(into: dict):
    """Keep the tensors the first call of a step's loss function is given
    (the augmented global batch, the draws, the labels) in `into`, as
    numpy, by argument position and key."""
    mods = [importlib.import_module(f"mlsp_tpu_torch.train.{m}")
            for m in ("steps", "seg_steps", "spst")]
    names = ("pointda_losses", "pointsegda_losses", "spst_losses")

    def keep(fn):
        def wrapped(model, cfg, *args, **kwargs):
            if not into:
                for i, a in enumerate(args):
                    for k, v in (a.items() if isinstance(a, dict)
                                 else [("", a)]):
                        if isinstance(v, torch.Tensor):
                            into[f"{i}.{k}"] = _numpy(v)
            return fn(model, cfg, *args, **kwargs)
        return wrapped

    with contextlib.ExitStack() as stack:
        for mod, name in zip(mods, names):
            stack.enter_context(mock.patch.object(mod, name,
                                                  keep(getattr(mod, name))))
        yield into


def step_case(mesh, case: dict, tape: "Tape | None" = None,
              split_points: bool = True) -> dict:
    """One train step of `case["kind"]` ("pointda", "seg" or "spst") from
    `case`'s model ("model", "num_class", "kwargs", "state": a CPU
    state_dict), config ("cfg"), global batch ("batch": CPU tensors) and
    generator seed ("seed"), on `case["device"]`, as a rank of `mesh` or,
    with None, as one process. With `tape` the run replays its kNN graphs
    and FPS orders; without, a rank records its own and returns them. On
    a points mesh the step runs under `points_sharding`; with
    `split_points` False every rank of a points group does the whole
    O(N^2) work itself (the data-parallel step).

    Returns numpy: "metrics" (the loss terms), "grads" (the gradients the
    update used, by parameter), "state" (the state_dict after it),
    "launches" (this process's kernel launches in the step), "draws"
    (the augmented batch and the draws the losses took, `_loss_inputs`)
    and with recording "graphs", "graph_rows", "orders" and
    "knn_against_plain" (each K1 launch of the step against the plain kNN
    of its input, `Tape.knn_against_plain`; empty without a card)."""
    from mlsp_tpu_torch import parallel
    from mlsp_tpu_torch.models import make_model
    from mlsp_tpu_torch.ops import kernels
    from mlsp_tpu_torch.train import make_optimizer
    from mlsp_tpu_torch.train.seg_steps import pointsegda_train_step
    from mlsp_tpu_torch.train.spst import spst_train_step
    from mlsp_tpu_torch.train.state import make_epoch_lr_optimizer
    from mlsp_tpu_torch.train.steps import pointda_train_step

    dev = torch.device(case["device"])
    model = make_model(case["model"], case["num_class"], device=dev,
                       **case["kwargs"])
    model.load_state_dict(case["state"])
    cfg = case["cfg"]
    b = {k: v.to(dev) for k, v in case["batch"].items()}
    gen = torch.Generator(device=dev).manual_seed(case["seed"])
    record = Tape() if tape is None else None
    kernels.reset_launches()
    with (record.record() if record is not None else tape.replay()), \
            parallel.points_sharding(mesh if split_points else None), \
            _loss_inputs({}) as draws:
        if case["kind"] == "spst":
            opt = make_epoch_lr_optimizer(model, cfg.optimizer, cfg.lr,
                                          cfg.wd, cfg.momentum)
            m = spst_train_step(model, opt, b["t_x"], b["t_y"], b["s_x"],
                                b["s_y"], case["spl_weight"],
                                case["cls_weight"], gen, cfg, mesh)
        else:
            opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                        10, cfg.optimizer, cfg.momentum)
            step = (pointsegda_train_step if case["kind"] == "seg"
                    else pointda_train_step)
            m = step(model, opt, sched, b["src_x"], b["src_y"], b["trgt_x"],
                     gen, cfg, mesh)
            if case["kind"] == "seg":
                m = m[0]
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "grads": {n: _numpy(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None},
           "state": {k: _numpy(v) for k, v in model.state_dict().items()},
           "launches": kernels.launches(), "draws": draws}
    if record is not None:
        out["graphs"] = [g.cpu().numpy() for g in record.graphs]
        out["graph_rows"] = record.rows
        out["orders"] = [o.cpu().numpy() for o in record.orders]
        out["knn_against_plain"] = record.knn_against_plain()
    return out


def step_cases(mesh, cases: list, planted: list | None = None,
               split_points: bool = True) -> list:
    """`step_case` of each case in turn (one spawn for several). A case
    whose entry of `planted` is true runs under `local_batch_norm`."""
    planted = planted or [False] * len(cases)
    out = []
    for case, fault in zip(cases, planted):
        with (local_batch_norm(mesh) if fault else contextlib.nullcontext()):
            out.append(step_case(mesh, case, split_points=split_points))
    return out


def points_step_cases(mesh, cases: list) -> dict:
    """On a rank of a points mesh: "split", `step_cases` of `cases`, and
    "whole", the same steps with every rank of a points group doing the
    whole O(N^2) work itself."""
    return {"split": step_cases(mesh, cases),
            "whole": step_cases(mesh, cases, split_points=False)}


@contextlib.contextmanager
def local_batch_norm(mesh):
    """A planted fault: every BatchNorm of a rank of `mesh` takes its
    statistics over the rank's own rows, as a data-parallel run without
    global statistics would. The comparisons with one process must fail
    on it."""
    dgcnn = importlib.import_module("mlsp_tpu_torch.models.dgcnn")
    layers = importlib.import_module("mlsp_tpu_torch.models.layers")
    with mock.patch.object(layers, "global_batch_norm",
                           lambda bn, rows: bn(rows)), \
            mock.patch.object(dgcnn, "global_sum",
                              lambda t: t * mesh.size):
        yield


def losses_case(mesh, case: dict) -> dict:
    """`train.steps.pointda_losses` on given global draws (`case["draws"]`,
    e.g. the JAX step's own) and the backward, as a rank of `mesh` or one
    process, the gradients averaged over the ranks. Returns numpy
    "metrics" (the ranks' average) and "grads"."""
    from mlsp_tpu_torch import parallel
    from mlsp_tpu_torch.models import make_model
    from mlsp_tpu_torch.train.steps import pointda_losses

    dev = torch.device(case["device"])
    model = make_model(case["model"], case["num_class"], device=dev,
                       **case["kwargs"])
    model.load_state_dict(case["state"])
    with parallel.data_parallel(mesh), parallel.points_sharding(mesh):
        total, m = pointda_losses(model, case["cfg"], case["batch"],
                                  case["draws"], None)
        total.backward()
    parallel.all_reduce_grads(model, mesh)
    m = parallel.average_metrics({k: v.detach() for k, v in m.items()}, mesh)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: _numpy(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None}}


def merge_rank_tapes(results: list, batch: int, points: int = 1) -> "Tape":
    """The single-process Tape of a data-parallel run's recorded choices
    (`results` by global rank): on a points mesh the query rows of each
    graph (`graph_rows`) are first joined over the `points` ranks of a
    data index, in points order; then a graph the ranks built on the
    global batch (`batch` clouds: the normal labels) is taken from rank
    0, one built on each rank's rows (the forwards) is the data ranks'
    graphs concatenated in rank order; the FPS orders (PCM, on the global
    batch) are rank 0's."""
    whole = []
    for d in range(0, len(results), points):
        group = results[d:d + points]
        whole.append([
            parts[0] if rows is None else np.concatenate(parts, 1)
            for rows, *parts in zip(group[0]["graph_rows"],
                                    *(r["graphs"] for r in group))])
    graphs = []
    for parts in zip(*whole):
        g = (parts[0] if parts[0].shape[0] == batch
             else np.concatenate(parts))
        graphs.append(torch.from_numpy(g))
    return Tape(graphs, [torch.from_numpy(o) for o in results[0]["orders"]])


SEG_METRIC_CASES = ("random", "ties", "only_predicted", "only_true",
                    "one_part", "padded")


class _SegLookup(torch.nn.Module):
    """Seg logits looked up by cloud: every point of cloud m carries m."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table)
        self.w = torch.nn.Parameter(torch.zeros((), device=table.device))

    def forward(self, x):
        return {"seg": self.table[x[:, 0, 0].long()]}


def seg_metric_case(case: str, device="cpu"):
    """A split for `evaluate_seg` at batch 4 whose seg logits are a fixed
    table: (model on `device`, clouds [M, N, 3], labels [M, N], logits
    [M, N, C] float32, batch). `case` (`SEG_METRIC_CASES`): random logits,
    exact ties between the maxima (some on the label), a part only in the
    prediction, a part only in the truth (and one in neither), clouds of
    one part (predicted right, then wrong), 7 clouds (the last batch's
    first 3 real)."""
    rng = np.random.default_rng(11)
    M, N, C, B = (7 if case == "padded" else 8), 64, 8, 4
    y = rng.integers(0, C, (M, N))
    logits = rng.standard_normal((M, N, C)).astype(np.float32)
    if case == "ties":
        logits = rng.integers(0, 2, (M, N, C)).astype(np.float32)
        logits[:, ::3] = 1.0
    elif case == "only_predicted":  # part 5 in no truth
        y[y == 5] = 4
        logits[:, ::4, 5] = 9.0
    elif case == "only_true":  # part 6 in no prediction, 1 in neither
        logits[..., (1, 6)] = -9.0
        y[y == 1] = 0
    elif case == "one_part":
        y[:2] = 3
        logits[0, :, 3] = 9.0
        logits[1, :, 2] = 9.0
    x = np.repeat(np.arange(M, dtype=np.float32), N * 3).reshape(M, N, 3)
    model = _SegLookup(torch.from_numpy(logits).to(device))
    return model, x, y, logits, B
