"""The port's data-parallel training (`mlsp_tpu_torch.parallel`) on the
CPU: R gloo ranks, each in a process of its own, against one process and
against the JAX step on a `data=2` mesh of the virtual CPU devices.

A run on R ranks must equal a run on one process up to the rounding of
the cross-rank sums. The ranks record their kNN graphs and FPS orders and
the single process replays them (`testing.merge_rank_tapes`), so no near
tie separates the runs. With eval-mode BatchNorm the gradients then agree
within 1e-5 (relative L2, `testing.grad_gaps`). With train-mode BN over a
batch of 8 the step is chaotic: float32 rounding (of the cross-rank sums,
of BN statistics combined from the ranks' own against
`nn.BatchNorm1d`'s, of matmuls over half the rows) flips ReLU and
max-pool kinks, which moves a share of a gradient outright. There every
loss term, gradient tensor and running statistic must stay within 1e-4
plus 3 times its own change in the single process under input shifts of
+-1e-6, the rule of the port-vs-JAX step tests. A planted fault, BatchNorm
statistics over each rank's own rows, must leave these bounds.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlsp_tpu_torch import make_model, parallel
from mlsp_tpu_torch.data.synthetic import make_classification, make_segmentation
from mlsp_tpu_torch.models.layers import batch_norm
from mlsp_tpu_torch.train.pointda_trainer import (
    eval_batches,
    eval_index,
    graphs_route,
)
from mlsp_tpu_torch.testing import (
    free_port,
    grad_gaps,
    losses_case,
    merge_rank_tapes,
    run_ranks,
    step_case,
    step_cases,
)
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    SPSTConfig,
    load_yaml,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 8, 64


def _case(kind: str, bn_eval: bool = False) -> dict:
    """A step of `kind` at B=8, N=64, full widths, dropout 0.5 (the ranks
    keep their rows of the global masks), float32 heads."""
    g = torch.Generator().manual_seed(0)
    if kind == "seg":
        cfg = dataclasses.replace(
            load_yaml(PointSegDAConfig,
                      os.path.join(REPO, "configs/pointsegda_mlsp.yaml")),
            apply_PCM=True, batch_size=B, num_points=N).resolved()
        x, y = make_segmentation(2 * B, N, 8, seed=3)
        model = make_model("dgcnn_seg", 8, device="cpu", generator=g)
        return {"kind": kind, "model": "dgcnn_seg", "num_class": 8,
                "kwargs": {}, "state": model.state_dict(), "cfg": cfg,
                "seed": 5, "device": "cpu",
                "batch": {"src_x": torch.from_numpy(x[:B]),
                          "src_y": torch.from_numpy(y[:B]),
                          "trgt_x": torch.from_numpy(x[B:])}}
    x, y = make_classification(2 * B, N, 10, seed=3)
    model = make_model("dgcnn", 10, device="cpu", generator=g)
    case = {"kind": kind, "model": "dgcnn", "num_class": 10,
            "kwargs": {"head_dtype": "f32"}, "state": model.state_dict(),
            "seed": 5, "device": "cpu"}
    if kind == "spst":
        case.update(cfg=SPSTConfig(batch_size=B, num_points=N,
                                   apply_PCM=True),
                    spl_weight=0.9, cls_weight=0.8,
                    batch={"t_x": torch.from_numpy(x[B:]),
                           "t_y": torch.from_numpy(y[B:]),
                           "s_x": torch.from_numpy(x[:B]),
                           "s_y": torch.from_numpy(y[:B])})
        return case
    cfg = dataclasses.replace(
        PointDAConfig(batch_size=B, num_points=N, head_dtype="f32"
                      ).paper_recipe, apply_SPL=True, debug_bn_eval=bn_eval)
    case.update(cfg=cfg, batch={"src_x": torch.from_numpy(x[:B]),
                                "src_y": torch.from_numpy(y[:B]),
                                "trgt_x": torch.from_numpy(x[B:])})
    return case


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process for the file's tests, then the
    count it had: the files that run after this one in the same worker
    keep theirs (the JAX parity bounds of `test_torch_port_train_step.py`
    hold at the default count, not at one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {"pointda_bn_eval": ("pointda", True), "pointda": ("pointda", False),
         "seg": ("seg", False), "spst": ("spst", False)}


@pytest.fixture(scope="module")
def two_ranks():
    """Every case's step on 2 gloo ranks (one spawn), and the cases."""
    cases = {name: _case(*args) for name, args in CASES.items()}
    ranks = run_ranks(2, step_cases, list(cases.values()))
    return cases, {name: [r[i] for r in ranks]
                   for i, name in enumerate(cases)}


def _shifted(case: dict, delta: float) -> dict:
    return {**case, "batch": {k: v + delta if v.is_floating_point() else v
                              for k, v in case["batch"].items()}}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_gaps(got: dict, want: dict) -> dict:
    return grad_gaps({k: torch.from_numpy(v) for k, v in got.items()},
                     {k: torch.from_numpy(v) for k, v in want.items()})


def _outside(case: dict, r0: dict, r1: dict, bn_eval: bool) -> list:
    """Where rank 0's step leaves the module docstring's bounds around one
    process's step on the ranks' graphs and FPS orders: (what, name, gap,
    limit) of each loss term, gradient tensor and running statistic
    outside. With train-mode BN each one's floor is its own largest
    change (relative L2; a loss term's absolute) under input shifts of
    +1e-6 and -1e-6."""
    one = step_case(None, case, merge_rank_tapes((r0, r1), B))
    assert set(one["grads"]) == set(r0["grads"])  # the same heads frozen
    floor = dict.fromkeys(one["grads"], 0.0)
    fmetrics = dict.fromkeys(one["metrics"], 0.0)
    fstate = dict.fromkeys(one["state"], 0.0)
    bound = 1e-5
    if not bn_eval:
        bound = 1e-4
        for delta in (1e-6, -1e-6):
            sh = step_case(None, _shifted(case, delta),
                           merge_rank_tapes((r0, r1), B))
            for k, f in _grad_gaps(sh["grads"], one["grads"]).items():
                floor[k] = max(floor[k], f)
            for k, v in one["metrics"].items():
                fmetrics[k] = max(fmetrics[k], abs(sh["metrics"][k] - v))
            for k, v in one["state"].items():
                fstate[k] = max(fstate[k], _rel(sh["state"][k], v))
    out = []
    for k, want in one["metrics"].items():
        limit = bound * max(abs(want), 1e-3) + 3 * fmetrics[k]
        if abs(r0["metrics"][k] - want) > limit:
            out.append(("loss", k, abs(r0["metrics"][k] - want), limit))
    for k, gap in _grad_gaps(r0["grads"], one["grads"]).items():
        if gap > bound + 3 * floor[k]:
            out.append(("grad", k, gap, bound + 3 * floor[k]))
    for k, want in one["state"].items():
        gap = _rel(r0["state"][k], want)
        if "running" in k and gap > bound + 3 * fstate[k]:
            out.append(("running", k, gap, bound + 3 * fstate[k]))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_process(two_ranks, name):
    """2 ranks against one process on the ranks' graphs and FPS orders:
    the two ranks bit-equal to each other (the same all-reduced gradients
    and averaged losses), and the single process's losses, gradients and
    running statistics within the module docstring's bounds, each with
    its own shift floor under train-mode BN (`_outside`)."""
    cases, results = two_ranks
    case, (r0, r1) = cases[name], results[name]
    assert r0["metrics"] == r1["metrics"]
    for k in r0["grads"]:
        np.testing.assert_array_equal(r0["grads"][k], r1["grads"][k])
    assert _outside(case, r0, r1, name == "pointda_bn_eval") == []


def test_local_batch_norm_fails_the_bounds():
    """The control of the bounds above: 2 ranks whose BatchNorms take
    their statistics over their own rows (`testing.local_batch_norm`, a
    planted fault) leave them, in the gradients and in the running
    statistics."""
    case = _case("pointda")
    r0, r1 = run_ranks(2, step_cases, [case], [True])
    out = _outside(case, r0[0], r1[0], False)
    assert {"grad", "running"} <= {what for what, *_ in out}, out


def _bn_rows(mesh, x: np.ndarray, weight: np.ndarray, cot: np.ndarray):
    """One train-mode BatchNorm1d forward and backward on this rank's rows
    of x [M, C], inside `data_parallel` (the identity without a mesh)."""
    torch.manual_seed(0)
    bn = torch.nn.BatchNorm1d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
    xt = torch.from_numpy(parallel.shard_batch(mesh, x)).requires_grad_()
    with parallel.data_parallel(mesh):
        y = batch_norm(bn, xt)
    (y * torch.from_numpy(parallel.shard_batch(mesh, cot))).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None:
        for gr in grads:
            dist.all_reduce(gr)
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": grads[0].numpy(), "db": grads[1].numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def test_global_batch_norm_equals_one_process_batch_norm():
    """`global_batch_norm` over 2 ranks (rows [0, 16) and [16, 32)) against
    `nn.BatchNorm1d` on all 32 rows in one process, in float32 with
    per-channel means far from 0: outputs, input and parameter gradients
    (the ranks' parameter gradients summed) and running statistics within
    1e-5 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((32, 6)) * 2 + rng.uniform(-3, 3, 6)
         ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    cot = rng.standard_normal((32, 6)).astype(np.float32)
    ranks = run_ranks(2, _bn_rows, x, w, cot)
    one = _bn_rows(None, x, w, cot)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               one["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]),
                               one["dx"], rtol=1e-5, atol=1e-5)
    for k in ("dw", "db", "mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(r[k], one[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _points_refusal(mesh) -> str:
    """make_mesh(points=3) on a rank of a world of 2: the error."""
    with pytest.raises(ValueError) as e:
        parallel.make_mesh(points=3)
    return str(e.value)


def test_replicate_for_mesh_refuses_an_indivisible_batch():
    """The JAX package's message, word for word; and a points axis that
    does not divide the world (3 over 2 ranks) raises ValueError on every
    rank."""
    mesh = parallel.Mesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match=r"batch_size 5 not divisible by the "
                       r"mesh data axis \(2 devices\)"):
        parallel.replicate_for_mesh(mesh, torch.nn.Linear(2, 2), 5)
    assert parallel.replicate_for_mesh(None, "state", 5) == "state"
    for msg in run_ranks(2, _points_refusal):
        assert "0x3 != world size 2" in msg, msg


class _Log:
    def __init__(self):
        self.lines = []

    def cprint(self, line):
        self.lines.append(line)

    def print_progress(self, *args):
        pass


@pytest.mark.parametrize("backend,device,on", [
    ("gloo", "cuda", False), ("nccl", "cuda", True), ("nccl", "cpu", False)])
def test_graphs_route_by_backend(backend, device, on):
    """A mesh's steps (chunks and the epoch's tail) and eval forwards
    replay graphs on the card under NCCL, whose collectives a graph holds,
    and run eagerly under gloo and on the CPU, which the log says of
    each. A fake mesh: no process group, no card."""
    mesh = parallel.Mesh(rank=0, size=2, device=torch.device(device),
                         backend=backend)
    log = _Log()
    got, graphs = graphs_route(PointDAConfig(scan_steps=4),
                               torch.device(device), mesh, log)
    assert got is on and (graphs is not None) is on
    assert parallel.captures(mesh) is (backend == "nccl")
    (line,) = log.lines
    assert line.startswith(f"step graphs: {'on' if on else 'off'}")
    if on:
        assert ("chunks of 4 steps and the epoch's tail replay one captured "
                "graph with the mesh's NCCL collectives") in line
        assert "eval forwards replay captured graphs of the rank's rows" in line
    elif device == "cuda":
        assert ("steps run eagerly under gloo (its collectives cannot be "
                "captured); eval forwards run eagerly under gloo (its "
                "collectives cannot be captured)") in line
    else:
        assert ("steps run eagerly on the cpu; eval forwards run eagerly on "
                "the cpu") in line


@pytest.mark.parametrize("mesh", [None, "nccl"])
def test_graphs_route_at_scan_steps_1(mesh):
    """On the card `scan_steps` 1 replays one graph a step, without a mesh
    and under NCCL, and so does PCM at mixup_params 0.4 (its Beta ratio
    drawn on the device), at scan_steps 1 and 8."""
    if mesh is not None:
        mesh = parallel.Mesh(rank=0, size=2, device=torch.device("cuda"),
                             backend=mesh)
    card = torch.device("cuda")
    log = _Log()
    assert graphs_route(PointDAConfig(scan_steps=1), card, mesh, log)[0]
    assert "scan_steps 1: each step replays one captured graph" in log.lines[0]
    pcm = PointDAConfig(scan_steps=1, apply_PCM=True, mixup_params=0.4)
    on, graphs = graphs_route(pcm, card, mesh, log)
    assert on and graphs is not None
    assert log.lines[1].startswith(
        "step graphs: on (scan_steps 1: each step replays one captured "
        "graph")
    assert "; eval forwards replay captured graphs" in log.lines[1]
    on, _ = graphs_route(dataclasses.replace(pcm, scan_steps=8), card, mesh,
                         log)
    assert on and log.lines[2].startswith(
        "step graphs: on (chunks of 8 steps and the epoch's tail replay one "
        "captured graph")


@pytest.mark.parametrize("size,rank", [(1, 0), (2, 0), (2, 1), (3, 2),
                                       (4, 3)])
def test_eval_index_is_the_eager_branch_index(size, rank):
    """`eval_index`, which the graph and the eager route share, gives the
    index that the eager mesh forward built on the device before the mesh
    eval graphs: each batch padded with its last index to a multiple of
    the data ranks, then the rank's rows; the sels themselves without a
    mesh."""
    sels, _ = eval_batches(23, 5, np.arange(40, 63))
    mesh = parallel.Mesh(rank=rank, size=size, device=torch.device("cpu"))
    idx = torch.from_numpy(np.stack(sels))
    pad = -idx.shape[1] % mesh.size
    idx = torch.cat([idx, idx[:, -1:].expand(-1, pad)], 1)
    want = parallel.shard_batch(mesh, idx.T).T
    got = eval_index(sels, mesh)
    assert got.dtype == want.numpy().dtype
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(eval_index(sels, None), np.stack(sels))


EVAL_N, EVAL_B = 32, 5  # 5 rows a batch over 2 ranks: each pads to 6


def _eval_case(m: int = 17) -> dict:
    """A DGCNN whose weights are carried from a JAX model with random BN
    statistics, a DGCNNSeg, and their clouds: m of each, 4 batches of
    EVAL_B, the last padded."""
    import jax
    import jax.numpy as jnp

    from mlsp_tpu.train import evaluation as jeval
    from mlsp_tpu.train.state import create_train_state
    from mlsp_tpu.utils import config as jconfig
    from mlsp_tpu_torch.utils.jax_weights import dgcnn_state_dict_from_jax

    jcfg = jconfig.EvalConfig(synthetic=True, num_points=EVAL_N,
                              test_batch_size=EVAL_B).resolved()
    jmodel, heads = jeval._build_model(jcfg)
    state = create_train_state(jmodel, jax.random.key(1),
                               jnp.zeros((EVAL_B, EVAL_N, 3)), heads=heads)
    rng = np.random.default_rng(1)
    state = state.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        state.batch_stats))
    x, y = make_classification(m, EVAL_N, 10, seed=4)
    sx, sy = make_segmentation(m, EVAL_N, 8, seed=5)
    seg = make_model("dgcnn_seg", 8, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    return {"jax": state, "x": x, "y": y, "idx": np.arange(1, m),
            "sx": sx, "sy": sy, "seg": seg.state_dict(),
            "cls": dgcnn_state_dict_from_jax(
                {"params": state.params, "batch_stats": state.batch_stats})}


def _eval_rank(mesh, case: dict) -> dict:
    """On a rank of `mesh` (or one process): `evaluate` over `idx`,
    `evaluate_seg`, and SPST's selection by max-prob at `threshold`."""
    from mlsp_tpu_torch.train.pointda_trainer import evaluate
    from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
    from mlsp_tpu_torch.train.spst import select_pseudo_labels

    cls = make_model("dgcnn", 10, device="cpu")
    cls.load_state_dict(case["cls"])
    seg = make_model("dgcnn_seg", 8, device="cpu")
    seg.load_state_dict(case["seg"])
    kept, labels = select_pseudo_labels(
        cls, case["x"], case["y"], case["idx"], EVAL_B, case["threshold"],
        False, _Log(), 0, mesh)
    return {"evaluate": evaluate(cls, case["x"], case["y"], EVAL_B, 10,
                                 case["idx"], mesh),
            "evaluate_seg": evaluate_seg(seg, case["sx"], case["sy"], EVAL_B,
                                         mesh),
            "selected": (kept.numpy(), labels.numpy())}


def test_two_rank_evals_equal_one_process_and_jax():
    """2 gloo ranks, each forwarding its rows of every batch (B=5, padded
    to 6): `evaluate` (over a subset, the trailing batch padded),
    `evaluate_seg` and SPST's selection (max-prob above the one process's
    median) equal one process's on both ranks, and `evaluate` equals the
    JAX `evaluate` on the carried weights, each loss within 1e-5 and the
    counts, predictions and selections equal (eval-mode BN)."""
    from mlsp_tpu.train import pointda_trainer as jtrainer
    from mlsp_tpu_torch.train.pointda_trainer import eval_logits

    case = _eval_case()
    jax_state = case.pop("jax")
    model = make_model("dgcnn", 10, device="cpu")
    model.load_state_dict(case["cls"])
    sels, counts = eval_batches(len(case["y"]), EVAL_B, case["idx"])
    logits = eval_logits(model, case["x"], sels)
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    conf = np.concatenate([p[:n] for p, n in zip(
        prob / prob.sum(-1, keepdims=True), counts)]).max(-1)
    case["threshold"] = float(np.median(conf))
    one = _eval_rank(None, case)
    assert 0 < len(one["selected"][1]) < len(case["idx"])
    want = jtrainer.evaluate(jax_state, case["x"], case["y"], EVAL_B, 10,
                             case["idx"])

    def close(a, b):
        assert abs(a - b) <= 1e-5 * max(abs(b), 1.0), (a, b)

    for r in run_ranks(2, _eval_rank, case) + [one]:
        for ref in (one["evaluate"], want):
            close(r["evaluate"]["loss"], ref["loss"])
            assert r["evaluate"]["acc"] == ref["acc"]
            np.testing.assert_array_equal(r["evaluate"]["conf_mat"],
                                          ref["conf_mat"])
        for a, b in zip(r["evaluate_seg"], one["evaluate_seg"]):
            close(a, b)
        for a, b in zip(r["selected"], one["selected"]):
            np.testing.assert_array_equal(a, b)


def _mesh_step_syncs(mesh, case: dict) -> dict:
    """On a rank of `mesh`: the host syncs (`testing.host_syncs`) of 2
    mesh steps, of a chunk of 2 through `pointda_train_scan`, of
    `average_metrics` and of the same 2 steps in one process ("alone");
    and whether the chunk takes the updates of the 2 eager mesh steps from
    the same state, bit for bit (the gloo route)."""
    from mlsp_tpu_torch.parallel import average_metrics
    from mlsp_tpu_torch.testing import host_syncs
    from mlsp_tpu_torch.train import make_optimizer, pointda_train_step
    from mlsp_tpu_torch.train.steps import pointda_train_scan

    cfg, b = case["cfg"], case["batch"]

    def fresh():
        model = make_model("dgcnn", 10, device="cpu", **case["kwargs"])
        model.load_state_dict(case["state"])
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10)
        return model, opt, sched, torch.Generator().manual_seed(case["seed"])

    def two_steps(state, m, into):
        for _ in range(2):
            into.append(pointda_train_step(*state[:3], b["src_x"],
                                           b["src_y"], b["trgt_x"], state[3],
                                           cfg, m))

    out, eager = {}, []
    state = fresh()
    out["step"] = host_syncs(two_steps, state, mesh, eager)
    out["alone"] = host_syncs(two_steps, fresh(), None, [])
    model = state[0]
    chunk = [torch.stack([b[k]] * 2) for k in ("src_x", "src_y", "trgt_x")]
    model2, opt2, sched2, gen2 = fresh()
    scanned = []
    out["scan"] = host_syncs(
        lambda: scanned.append(pointda_train_scan(
            model2, opt2, sched2, *chunk, gen2, cfg, None, mesh)))
    m = {k: v[0] for k, v in scanned[0].items()}
    out["average"] = host_syncs(average_metrics, m, mesh)
    out["chunk_equals_steps"] = all(
        torch.equal(scanned[0][k][i], eager[i][k])
        for i in range(2) for k in eager[i]) and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                          model2.state_dict().values()))
    return out


def test_mesh_step_and_chunk_make_no_host_sync():
    """What an NCCL step graph would hold makes no host sync of its own on
    2 gloo ranks: the mesh step (global BatchNorm, the gradient
    all-reduce, the averaged loss terms), 2 of them and a chunk of 2
    through `pointda_train_scan` make those of 2 steps in one process,
    and no other; `average_metrics` none. The step alone syncs on the CPU only
    (its optimizer, not capturable there, and `one_hot`'s range check),
    and the card captures it (`tests/test_torch_port_cuda.py::
    test_nccl_chunk_replays_match_eager_mesh_steps`). A gloo
    chunk, taken eagerly, equals its eager steps bit for bit."""
    case = _case("pointda")
    for r in run_ranks(2, _mesh_step_syncs, case):
        alone = collections.Counter(r["alone"])
        assert collections.Counter(r["step"]) == alone
        assert collections.Counter(r["scan"]) == alone
        assert r["average"] == []
        assert r["chunk_equals_steps"]


def _dead_peer(mesh):
    if mesh.rank == 1:
        os._exit(0)  # dies without a word
    dist.all_reduce(torch.ones(1))


def test_dead_peer_fails_within_the_timeout():
    """Rank 1 dies after joining; rank 0's next collective raises within
    its 5 s timeout instead of hanging."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 0"):
        run_ranks(2, _dead_peer, timeout_s=5)
    assert time.perf_counter() - t0 < 60


def _trainer_cmd(out: str, extra=()) -> list:
    return [sys.executable, "-m", "mlsp_tpu_torch.cli", "trainer",
            "--synthetic", "True", "--device", "cpu", "--epochs", "1",
            "--num_points", "32", "--batch_size", "8", "--test_batch_size",
            "8", "--DefRec_on_src", "False", "--apply_PCM", "True",
            "--out_path", out, *extra]


def test_two_rank_trainer_cli_profile_dir(tmp_path):
    """`trainer --mesh_data 2 --profile_dir D` on 2 gloo ranks: each rank
    writes its own parseable Chrome trace, D/trace.rank{R}.json, and no
    rank writes D/trace.json."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "2"}
    trace_dir = tmp_path / "trace"
    procs = [subprocess.Popen(
        _trainer_cmd(str(tmp_path / f"r{r}"),
                     ("--mesh_data", "2", "--profile_dir", str(trace_dir),
                      "--batch_size", "32", "--test_batch_size", "32")),
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(p.name for p in trace_dir.iterdir()) == [
        "trace.rank0.json", "trace.rank1.json"]
    for r in range(2):
        events = json.loads((trace_dir / f"trace.rank{r}.json").read_text())
        assert any(e.get("name") == "mlsp/epoch 0"
                   for e in events["traceEvents"])


def test_two_rank_trainer_cli(tmp_path):
    """`trainer --mesh_data 2` on 2 processes with torchrun's environment:
    both end with the same validation and test lines, rank 1 prefixes its
    lines and writes no file; a world of one without torchrun runs too,
    and a --mesh_data that does not match the world raises."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "2"}
    procs = [subprocess.Popen(
        _trainer_cmd(str(tmp_path / f"r{r}"), ("--mesh_data", "2")),
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs

    def lines(out, prefix=""):
        return [ln.split(": ", 1)[1][len(prefix):] for ln in out.splitlines()
                if (prefix + "Val - epoch") in ln
                or (prefix + "target test") in ln]

    assert lines(outs[0]) and lines(outs[0]) == lines(outs[1], "[rank 1] ")
    assert (tmp_path / "r0" / "MLSP" / "model.ckpt").exists()
    metrics = [json.loads(ln) for ln in
               (tmp_path / "r0" / "MLSP" / "metrics.jsonl").open()]
    assert [m["epoch"] for m in metrics] == [0]
    assert not (tmp_path / "r1").exists()

    env1 = {k: v for k, v in env.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")}
    done = subprocess.run(_trainer_cmd(str(tmp_path / "one"),
                                       ("--mesh_data", "1")),
                          env=env1, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    bad = subprocess.run(_trainer_cmd(str(tmp_path / "bad"),
                                      ("--mesh_data", "2")),
                         env=env1, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode != 0 and "torchrun --nproc_per_node 2" in bad.stderr


class TestAgainstJaxMesh:
    def test_two_rank_step_matches_the_jax_step_on_a_data_mesh(self):
        """The paper-recipe iteration at B=4, N=256 with eval-mode BN (as
        `test_torch_port_train_step.py::TestStep`), the JAX step on a
        `data=2` mesh of the virtual CPU devices (batch sharded, state
        replicated), the port on 2 gloo ranks fed the JAX step's own draws
        (`testing.losses_case`): every loss term within rtol 1e-4, every
        gradient within 1e-4 relative L2, each side on its own kNN graphs.
        Eval-mode BN: with train-mode BN over 4 clouds the JAX step's own
        DefRec term moves by 4% between one device and the data=2 mesh
        (rounding through the chaotic step), beyond what a shift floor
        measures; the ranks' train-mode BN is held against one process
        above."""
        import jax
        import jax.numpy as jnp

        from mlsp_tpu.parallel import make_mesh, replicate, shard_batch
        from mlsp_tpu.train import state as jstate
        from mlsp_tpu.train import steps as jsteps
        from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
        from mlsp_tpu_torch.utils.jax_weights import (
            dgcnn_grads_from_jax,
            dgcnn_state_dict_from_jax,
        )
        from test_torch_port_train_step import (
            _jax_model,
            _unit_clouds,
            _variables,
        )

        Bj, Nj = 4, 256
        cfg_j = dataclasses.replace(
            JaxConfig(batch_size=Bj, num_points=Nj, dropout=0.0,
                      knn_backend="xla", edge_impl="moments",
                      head_dtype="f32").paper_recipe,
            debug_aux=True, debug_bn_eval=True)
        cfg = dataclasses.replace(
            PointDAConfig(batch_size=Bj, num_points=Nj, dropout=0.0,
                          head_dtype="f32").paper_recipe, debug_bn_eval=True)
        v = _variables(2)
        jm = _jax_model()
        state = jstate.TrainState.create(
            apply_fn=jm.apply, params=v["params"],
            batch_stats=v["batch_stats"], tx=jstate.make_optimizer(
                "ADAM", cfg.lr, cfg.wd, 0.9, cfg.epochs, 10,
                decay_mask=jstate.untrained_decay_mask({"RecScan"})))
        mesh = make_mesh(jax.devices()[:2], data=2)
        rng = np.random.default_rng(3)
        src, trgt = _unit_clouds(rng, Bj, Nj), _unit_clouds(rng, Bj, Nj)
        src_y = rng.integers(0, 10, Bj)
        s, y, t = shard_batch(mesh, (jnp.asarray(src), jnp.asarray(src_y),
                                     jnp.asarray(trgt)))
        _, m = jsteps.pointda_train_step(replicate(mesh, state), s, y, t,
                                         jax.random.key(4), cfg_j)
        aux = {k: torch.from_numpy(np.array(a)) for k, a in m.items()
               if k.startswith("aux_") and k != "aux_grads"}
        case = {"model": "dgcnn", "num_class": 10,
                "kwargs": {"k": 20, "dropout": 0.0},
                "state": dgcnn_state_dict_from_jax(v), "cfg": cfg,
                "device": "cpu",
                "batch": {"src_x": aux["aux_src"],
                          "src_y": torch.from_numpy(src_y),
                          "trgt_x": aux["aux_trgt"]},
                "draws": {"mixed": aux["aux_mixed"],
                          "ya": aux["aux_ya"].long(),
                          "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"],
                          "dx": aux["aux_dx"], "dmask": aux["aux_dmask"]}}
        r0, r1 = run_ranks(2, losses_case, case)
        assert r0["metrics"] == r1["metrics"]
        for k, g in r0["grads"].items():
            np.testing.assert_array_equal(g, r1["grads"][k])
        assert set(r0["metrics"]) == {k for k in m if not k.startswith("aux_")}
        for name, got in r0["metrics"].items():
            np.testing.assert_allclose(got, float(m[name]), rtol=1e-4,
                                       err_msg=name)
        want = dgcnn_grads_from_jax(m["aux_grads"])
        got = {k: torch.from_numpy(a) for k, a in r0["grads"].items()}
        for k in set(want) - set(got):  # no loss reaches it
            np.testing.assert_array_equal(want[k].numpy(), 0.0, err_msg=k)
        for k, gap in grad_gaps(got, {k: want[k] for k in got}).items():
            assert gap <= 1e-4, (k, gap)
