"""The port's points mesh axis (`parallel.make_mesh(data, points)`,
`--mesh_points`) on the CPU: gloo ranks in processes of their own, each
cloud's O(N^2) work split by query rows over the points ranks of a data
index, against one process and against the JAX step on a (data=2,
points=2) mesh of the virtual CPU devices.

Two worlds are spawned for the whole file (`worlds`): data 1 x points 2
and data 2 x points 2. On each rank the row-split producers are held
against their whole versions on the same inputs, and the paper and seg
steps are taken with and without the split. The points axis is
invisible: the kNN graphs the ranks gather are index-equal to those of
the same step without it, and its losses and gradients agree with one
process at the data-parallel bounds of `test_torch_port_ddp.py`
(eval-mode BN: 1e-5; train-mode BN: 1e-4 plus 3 times each tensor's own
change under +-1e-6 input shifts).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlsp_tpu_torch.testing import (
    free_port,
    grad_gaps,
    losses_case,
    merge_rank_tapes,
    points_step_cases,
    run_ranks,
    step_case,
)
from mlsp_tpu_torch.utils.config import PointDAConfig
from test_torch_port_ddp import B, _case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 2
CASES = {"pointda_bn_eval": ("pointda", True), "pointda": ("pointda", False),
         "seg": ("seg", False)}
OPS_B, OPS_N = 3, 70  # 35 query rows a points rank
TIE = 1e-6
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlsp_tpu"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process for the file's tests, then the
    count it had (see `test_torch_port_ddp.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops_inputs(seed: int = 0) -> dict:
    """Clouds with exact-zero points (Chamfer's tied minima, as a scan
    batch has), a deform mask, collapse draws and features to
    interpolate, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (OPS_B, OPS_N, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (OPS_B, OPS_N, 3)).astype(np.float32)
    x[:, -8:] = 0.0
    y[:, :10] = 0.0
    return {"x": x, "y": y,
            "mask": (rng.uniform(size=(OPS_B, OPS_N)) > 0.4).astype(
                np.float32),
            "gumbel": rng.gumbel(size=(OPS_B, OPS_N)).astype(np.float32),
            "noise": rng.standard_normal((OPS_B, OPS_N, 3)).astype(
                np.float32),
            "feats": rng.standard_normal((OPS_B, 5, 4)).astype(np.float32)}


def _producers(inp: dict) -> dict:
    """Every row-split O(N^2) producer on `inp`, gradients included."""
    from mlsp_tpu_torch.models.transformer import feature_propagation
    from mlsp_tpu_torch.ops.chamfer import masked_chamfer, nearest_index_pair
    from mlsp_tpu_torch.ops.density import radius_count
    from mlsp_tpu_torch.ops.grouping import ball_query
    from mlsp_tpu_torch.ops.knn import knn_indices
    from mlsp_tpu_torch.transforms.deform import collapse_to_point_batch

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, y, mask = t["x"], t["y"], t["mask"]
    out = {"knn": knn_indices(x, 20), "knn_cross": knn_indices(
        x[:, :11], 16, y=y), "radius_count": radius_count(x, 0.5)}
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    cham = masked_chamfer(xr, yr, mask) + 2 * masked_chamfer(yr, xr, mask)
    cham.backward()
    out.update(chamfer=cham.detach(), chamfer_dx=xr.grad,
               chamfer_dy=yr.grad)
    out["nearest_xy"], out["nearest_yx"] = nearest_index_pair(x, y, mask)
    out["ball"] = ball_query(x, x[:, :9], 0.5, 6)
    fr = t["feats"].clone().requires_grad_()
    fp = feature_propagation(x, x[:, :5], fr)
    (fp * torch.arange(1.0, 5.0)).sum().backward()
    out.update(interp=fp.detach(), interp_dfeats=fr.grad)
    out["collapse"], out["collapse_mask"] = collapse_to_point_batch(
        x, t["gumbel"], t["noise"])
    return {k: v.numpy() for k, v in out.items()}


def _rank(mesh, cases: list, inp: dict, jax_case: dict | None) -> dict:
    """On a rank of a points mesh: its place in the mesh, the producers
    whole and under `points_sharding`, each case's step split and whole
    (`testing.points_step_cases`) and, with `jax_case`, `losses_case` on
    the JAX step's draws."""
    from mlsp_tpu_torch import parallel

    out = {"mesh": {"rank": mesh.rank, "size": mesh.size,
                    "points_rank": mesh.points_rank, "shape": mesh.shape,
                    "rows": parallel.points_rows(OPS_N, mesh)},
           "whole": _producers(inp)}
    with parallel.points_sharding(mesh):
        out["split"] = _producers(inp)
    steps = points_step_cases(mesh, cases)
    out["steps"], out["unsplit"] = steps["split"], steps["whole"]
    if jax_case is not None:
        out["jax"] = losses_case(mesh, jax_case)
    return out


def _jax_points_step() -> tuple[dict, dict]:
    """The paper-recipe iteration at B=4, N=256 with eval-mode BN (as
    `test_torch_port_ddp.py::TestAgainstJaxMesh`), the JAX step under
    `points_sharding` of a (data=2, points=2) mesh of the virtual CPU
    devices: the port's `losses_case` of it (the JAX step's own draws)
    and JAX's metrics and gradients."""
    import jax
    import jax.numpy as jnp

    from mlsp_tpu.parallel import (
        make_mesh,
        points_sharding,
        replicate,
        shard_batch,
    )
    from mlsp_tpu.train import state as jstate
    from mlsp_tpu.train import steps as jsteps
    from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
    from mlsp_tpu_torch.utils.jax_weights import (
        dgcnn_grads_from_jax,
        dgcnn_state_dict_from_jax,
    )
    from test_torch_port_train_step import _jax_model, _unit_clouds, _variables

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
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=jstate.make_optimizer(
            "ADAM", cfg.lr, cfg.wd, 0.9, cfg.epochs, 10,
            decay_mask=jstate.untrained_decay_mask({"RecScan"})))
    mesh = make_mesh(jax.devices()[:4], data=2, points=POINTS)
    rng = np.random.default_rng(3)
    src, trgt = _unit_clouds(rng, Bj, Nj), _unit_clouds(rng, Bj, Nj)
    src_y = rng.integers(0, 10, Bj)
    with points_sharding(mesh):
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
            "draws": {"mixed": aux["aux_mixed"], "ya": aux["aux_ya"].long(),
                      "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"],
                      "dx": aux["aux_dx"], "dmask": aux["aux_dmask"]}}
    want = {"metrics": {k: float(a) for k, a in m.items()
                        if not k.startswith("aux_")},
            "grads": dgcnn_grads_from_jax(m["aux_grads"])}
    return case, want


@pytest.fixture(scope="module")
def worlds():
    """The two spawned worlds, data 1 x points 2 and data 2 x points 2
    (the latter also holds JAX's points-mesh step): the cases, the
    producers' inputs, JAX's results and each world's rank results, by
    data axis size."""
    cases = {name: _case(*args) for name, args in CASES.items()}
    inp = _ops_inputs()
    jax_case, jax_want = _jax_points_step()
    ranks = {data: run_ranks(data * POINTS, _rank, list(cases.values()), inp,
                             jax_case if data == 2 else None, points=POINTS)
             for data in (1, 2)}
    return cases, inp, jax_want, ranks


def test_mesh_layout(worlds):
    """Rank r has data index r // P and points index r % P, as JAX lays
    its devices out; each takes ceil(N / P) query rows in points
    order."""
    _, _, _, ranks = worlds
    for data, rs in ranks.items():
        for r, res in enumerate(rs):
            m = res["mesh"]
            assert (m["rank"], m["points_rank"]) == divmod(r, POINTS)
            assert m["size"] == data and m["shape"] == {"data": data,
                                                        "points": POINTS}
            per = -(-OPS_N // POINTS)
            assert m["rows"] == (m["points_rank"] * per, per)


def _sqdist(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    q, x = q.astype(np.float64), x.astype(np.float64)
    return ((q[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def _same_neighbours(got: np.ndarray, want: np.ndarray, q: np.ndarray,
                     x: np.ndarray, name: str) -> None:
    """Indices [B, M, k] equal, except in rows whose k-th and (k+1)-th
    distances tie within TIE; there the sorted distance sets agree."""
    rows = np.argwhere((got != want).any(-1))
    d = _sqdist(q, x)
    k = got.shape[-1]
    for b, i in rows:
        srt = np.sort(d[b, i])
        assert k < srt.shape[0] and srt[k] - srt[k - 1] <= TIE, (name, b, i)
        np.testing.assert_allclose(np.sort(d[b, i, got[b, i]]),
                                   np.sort(d[b, i, want[b, i]]), atol=TIE,
                                   err_msg=name)


@pytest.mark.parametrize("data", [1, 2])
def test_row_split_producers_equal_whole(worlds, data):
    """On every rank, each O(N^2) producer under `points_sharding` (its
    query rows, gathered over the points group) against the same producer
    whole, on clouds with exact-zero points: the kNN graphs (self, and
    cross-set), the nearest indices both ways and the ball query equal up
    to near ties (`_same_neighbours`); radius counts and the collapse mask
    equal; Chamfer both ways, its input gradients (summed over the points
    group by `copy_to_points`) and the 3-NN interpolation with its
    gradient within float32 rounding."""
    _, inp, _, ranks = worlds
    x, y = inp["x"], inp["y"]
    for res in ranks[data]:
        whole, split = res["whole"], res["split"]
        _same_neighbours(split["knn"], whole["knn"], x, x, "knn")
        _same_neighbours(split["knn_cross"], whole["knn_cross"], x[:, :11], y,
                         "knn_cross")
        _same_neighbours(split["ball"], whole["ball"], x[:, :9], x, "ball")
        masked = np.where(inp["mask"][:, None, :] > 0, 0.0, 100.0)
        for name, q, db in (("nearest_xy", x, y), ("nearest_yx", y, x)):
            got, want = split[name][..., None], whole[name][..., None]
            rows = np.argwhere((got != want).any(-1))
            d = _sqdist(q, db) + masked
            for b, i in rows:
                assert abs(d[b, i, got[b, i, 0]] - d[b, i, want[b, i, 0]]
                           ) <= TIE, (name, b, i)
        for name in ("radius_count", "collapse", "collapse_mask"):
            np.testing.assert_array_equal(split[name], whole[name],
                                          err_msg=name)
        for name in ("chamfer", "chamfer_dx", "chamfer_dy", "interp",
                     "interp_dfeats"):
            w = whole[name]
            np.testing.assert_allclose(split[name], w, rtol=1e-5,
                                       atol=1e-6 * max(np.abs(w).max(), 1.0),
                                       err_msg=name)
        assert whole["chamfer_dy"][:, :10].any()  # the tied zeros take some


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gaps(got: dict, want: dict) -> dict:
    return {"loss": {k: abs(got["metrics"][k] - w)
                     for k, w in want["metrics"].items()},
            "grad": grad_gaps(
                {k: torch.from_numpy(v) for k, v in got["grads"].items()},
                {k: torch.from_numpy(v) for k, v in want["grads"].items()}),
            "running": {k: _rel(got["state"][k], v)
                        for k, v in want["state"].items() if "running" in k}}


def _outside(got: dict, want: dict, floor: dict, bound: float) -> list:
    """(kind, name, gap, limit) of each loss term, gradient tensor and
    running statistic of `got` beyond `bound` (a loss term's relative to
    its size) plus 3 times its `floor` around `want`."""
    out = []
    for kind, gaps in _gaps(got, want).items():
        for k, gap in gaps.items():
            scale = (max(abs(want["metrics"][k]), 1e-3) if kind == "loss"
                     else 1.0)
            limit = bound * scale + 3 * floor.get(kind, {}).get(k, 0.0)
            if gap > limit:
                out.append((kind, k, gap, limit))
    return out


def _ranks_equal(rs: list) -> None:
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        for k, g in rs[0]["grads"].items():
            np.testing.assert_array_equal(r["grads"][k], g, err_msg=k)


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_points_axis_is_invisible(worlds, name, data):
    """The step on data `data` x points 2 against the same world's
    data-parallel step without the split (every rank of a points group
    doing the whole O(N^2) work): every rank bit-equal to the others; the
    augmented batch and draws bit-equal, the kNN graphs the ranks
    gathered and the FPS orders index-equal to the unsplit step's; the
    loss terms, gradients and running statistics within 1e-5, the
    rounding bound of the data-parallel tests (the forwards see the same
    graphs; the gradients of Chamfer's inputs are summed over the points
    group, in another order)."""
    _, _, _, ranks = worlds
    i = list(CASES).index(name)
    rs = [r["steps"][i] for r in ranks[data]]
    whole = [r["unsplit"][i] for r in ranks[data]]
    _ranks_equal(rs)
    _ranks_equal(whole)
    got = merge_rank_tapes(rs, B, POINTS)
    want = merge_rank_tapes(whole, B, POINTS)
    assert len(got.graphs) == len(want.graphs)
    for g, w in zip(got.graphs + got.orders, want.graphs + want.orders):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert rs[0]["draws"].keys() == whole[0]["draws"].keys()
    for k, v in rs[0]["draws"].items():
        np.testing.assert_array_equal(v, whole[0]["draws"][k], err_msg=k)
    assert _outside(rs[0], whole[0], {}, 1e-5) == []


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_points_mesh_step_equals_one_process(worlds, name, data):
    """The paper step (eval- and train-mode BN) and the seg step on data
    `data` x points 2 against one process replaying the ranks' gathered
    kNN graphs and FPS orders (`testing.merge_rank_tapes`): the losses,
    gradients and running statistics within the data-parallel bounds
    (eval-mode BN 1e-5; train-mode BN 1e-4 plus 3 times each one's change
    in the single process under +-1e-6 input shifts). Under eval-mode BN
    the single process's own graphs equal the ranks' (with train-mode BN
    the data ranks' statistics round apart from one process's, which can
    move a near tie in feature space: the data axis's, not the points
    axis's; `test_points_axis_is_invisible` holds those graphs)."""
    cases, _, _, ranks = worlds
    i = list(CASES).index(name)
    case, rs = cases[name], [r["steps"][i] for r in ranks[data]]
    tape = merge_rank_tapes(rs, B, POINTS)
    one = step_case(None, case, tape)
    assert set(one["grads"]) == set(rs[0]["grads"])
    bn_eval = CASES[name][1]
    if bn_eval:
        assert tape.own_graph_rows_differ == 0
    floor = {kind: dict.fromkeys(g, 0.0)
             for kind, g in _gaps(one, one).items()}
    if not bn_eval:
        for delta in (1e-6, -1e-6):
            shifted = {**case, "batch": {
                k: v + delta if v.is_floating_point() else v
                for k, v in case["batch"].items()}}
            sh = step_case(None, shifted, merge_rank_tapes(rs, B, POINTS))
            for kind, g in _gaps(sh, one).items():
                for k, v in g.items():
                    floor[kind][k] = max(floor[kind][k], v)
    assert _outside(rs[0], one, floor, 1e-5 if bn_eval else 1e-4) == []


def test_points_mesh_step_matches_the_jax_points_mesh(worlds):
    """The port's paper-recipe losses and backward on data 2 x points 2
    (`testing.losses_case` on the JAX step's own draws) against JAX's step
    under `points_sharding` of a (data=2, points=2) mesh, eval-mode BN, at
    `TestAgainstJaxMesh`'s bounds: every loss term within rtol 1e-4,
    every gradient within 1e-4 relative L2, each side on its own kNN
    graphs; the four ranks bit-equal."""
    _, _, want, ranks = worlds
    rs = [r["jax"] for r in ranks[2]]
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, rs[0]["grads"][k])
    assert set(rs[0]["metrics"]) == set(want["metrics"])
    for name, got in rs[0]["metrics"].items():
        np.testing.assert_allclose(got, want["metrics"][name], rtol=1e-4,
                                   err_msg=name)
    got = {k: torch.from_numpy(a) for k, a in rs[0]["grads"].items()}
    for k in set(want["grads"]) - set(got):  # no loss reaches it
        np.testing.assert_array_equal(want["grads"][k].numpy(), 0.0,
                                      err_msg=k)
    for k, gap in grad_gaps(got, {k: want["grads"][k] for k in got}).items():
        assert gap <= 1e-4, (k, gap)


_CLI = """
import sys
from mlsp_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = {m.split('.')[0] for m in sys.modules}
assert not loaded & %r, loaded & %r
sys.exit(rc)
""" % (FORBIDDEN, FORBIDDEN)


def test_points_trainer_cli(tmp_path):
    """`trainer --mesh_points 2` on 2 processes with torchrun's environment
    (data 1 x points 2, gloo), in processes that import no JAX: both end
    with the same validation and test lines, rank 1 prefixes its lines
    and writes no file. Refused before joining: a WORLD_SIZE other than
    D x P (the message names both axes and the torchrun line) and a batch
    that does not split over the data axis."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}

    def cmd(out, *extra):
        return [sys.executable, "-c", _CLI, "trainer", "--synthetic", "True",
                "--device", "cpu", "--epochs", "1", "--num_points", "32",
                "--batch_size", "8", "--test_batch_size", "8",
                "--DefRec_on_src", "False", "--apply_PCM", "True",
                "--out_path", str(tmp_path / out), *extra]

    def start(argv, world, rank):
        return subprocess.Popen(
            argv, env={**env, "WORLD_SIZE": str(world), "RANK": str(rank),
                       "LOCAL_RANK": str(rank)},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    procs = [start(cmd(f"r{r}", "--mesh_points", "2"), 2, r)
             for r in range(2)]
    bad_world = start(cmd("bad", "--mesh_data", "2", "--mesh_points", "2"),
                      2, 0)
    bad_batch = start(cmd("odd", "--mesh_points", "2", "--batch_size", "6"),
                      8, 0)
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs

    def lines(out, prefix=""):
        return [ln.split(": ", 1)[1][len(prefix):] for ln in out.splitlines()
                if (prefix + "Val - epoch") in ln
                or (prefix + "target test") in ln]

    assert lines(outs[0]) and lines(outs[0]) == lines(outs[1], "[rank 1] ")
    metrics = [json.loads(ln) for ln in
               (tmp_path / "r0" / "MLSP" / "metrics.jsonl").open()]
    assert [m["epoch"] for m in metrics] == [0]
    assert all(np.isfinite(v) for v in metrics[0]["train"].values())
    assert not (tmp_path / "r1").exists()
    out = bad_world.communicate(timeout=300)[0]
    assert bad_world.returncode != 0
    assert ("--mesh_data 2 x --mesh_points 2 = 4 but torchrun started "
            "WORLD_SIZE=2" in out and "torchrun --nproc_per_node 4" in out)
    out = bad_batch.communicate(timeout=300)[0]
    assert bad_batch.returncode != 0
    assert "batch_size 6 not divisible by the mesh data axis (4 devices)" \
        in out
