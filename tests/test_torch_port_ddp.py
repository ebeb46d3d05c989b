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


CASES = {"pointda_bn_eval": ("pointda", True), "pointda": ("pointda", False),
         "seg": ("seg", False), "spst": ("spst", False)}


@pytest.fixture(scope="module")
def two_ranks():
    """Every case's step on 2 gloo ranks (one spawn), and the cases."""
    torch.set_num_threads(1)
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
    torch.set_num_threads(1)
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


def test_replicate_for_mesh_refuses_an_indivisible_batch():
    """The JAX package's message, word for word."""
    mesh = parallel.Mesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match=r"batch_size 5 not divisible by the "
                       r"mesh data axis \(2 devices\)"):
        parallel.replicate_for_mesh(mesh, torch.nn.Linear(2, 2), 5)
    assert parallel.replicate_for_mesh(None, "state", 5) == "state"
    with pytest.raises(NotImplementedError, match="mesh_points"):
        parallel.make_mesh(points=2)


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
