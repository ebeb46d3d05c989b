"""The port's fused step dispatch (`scan_steps`) on the CPU.

`scan_steps` loads as the JAX package's does; a chunk of S steps on the
CPU (`pointda_train_scan`, `pointsegda_train_scan`, `spst_train_scan`) is S
single steps, bit for bit; the trainer takes the same steps whatever
`scan_steps` is; the scanned eval (`scan_in_chunks` of `eval_scan` and
`seg_eval_scan`) against JAX's `scan_in_chunks` on the same weights and
the port's kNN graphs; the graph module refuses CPU tensors; every
recipe replays its steps on the card (PCM's mixing ratio is drawn on the
device at any `mixup_params`); every family's eval forward reads nothing on the
host (so the card can capture it); a checkpoint written by the card's
optimizers (tensor LRs, capturable/fused) resumes on the CPU. The card's
side (replays against eager steps) is in `test_torch_port_cuda.py`.
"""

import collections
import copy
import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from mlsp_tpu.train import evaluation as jeval
from mlsp_tpu.train import seg_steps as jseg_steps
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.train.state import create_train_state
from mlsp_tpu.utils import config as jconfig
from mlsp_tpu_torch import cli, make_model
from mlsp_tpu_torch.testing import host_syncs
from mlsp_tpu_torch.train import graphs, pointda_trainer
from mlsp_tpu_torch.train import steps as steps_mod
from mlsp_tpu_torch.train.seg_steps import (
    pointsegda_train_scan,
    pointsegda_train_step,
    seg_eval_scan,
)
from mlsp_tpu_torch.train.spst import spst_train_scan, spst_train_step
from mlsp_tpu_torch.train.state import (
    make_epoch_lr_optimizer,
    make_optimizer,
)
from mlsp_tpu_torch.train.steps import (
    eval_scan,
    pointda_train_scan,
    pointda_train_step,
    scan_in_chunks,
)
from mlsp_tpu_torch.utils import checkpoint, config
from mlsp_tpu_torch.utils.jax_weights import (
    dgcnn_seg_state_dict_from_jax,
    dgcnn_state_dict_from_jax,
)

_knn = importlib.import_module("mlsp_tpu_torch.ops.knn")
_jdgcnn = importlib.import_module("mlsp_tpu.models.dgcnn")
_jdseg = importlib.import_module("mlsp_tpu.models.dgcnn_seg")
CLASSES = [(config.PointDAConfig, jconfig.PointDAConfig, "trainer"),
           (config.SPSTConfig, jconfig.SPSTConfig, "spst"),
           (config.PointSegDAConfig, jconfig.PointSegDAConfig, "seg")]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("port_cls,jax_cls,command", CLASSES)
def test_scan_steps_loads_as_jax(tmp_path, port_cls, jax_cls, command):
    """JAX's default (16, 8, 8; 1 = off), `from_dict`, a YAML and the
    CLI flag."""
    assert port_cls().scan_steps == jax_cls().scan_steps
    for d in ({"scan_steps": 4}, {"scan_steps": 1}):
        assert (config.from_dict(port_cls, d).scan_steps
                == jconfig.from_dict(jax_cls, d).scan_steps == d["scan_steps"])
    path = tmp_path / "c.yaml"
    path.write_text("scan_steps: 3\nepochs: 2\n")
    got = config.load_yaml(port_cls, str(path))
    want = jconfig.load_yaml(jax_cls, str(path))
    assert (got.scan_steps, got.epochs) == (want.scan_steps, want.epochs)
    args = cli.build_parser().parse_args([command, "--config", str(path),
                                          "--scan_steps", "5"])
    assert cli._to_config(port_cls, args).scan_steps == 5


# ------------------------------------------------------ chunks on the CPU

N, B, S = 32, 4, 3


def _clouds(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))


def _state(model, opt):
    """Everything a step moves: parameters, buffers (BN statistics), the
    optimizer's state and LRs."""
    out = {f"model.{k}": v.clone() for k, v in model.state_dict().items()}
    for i, (p, st) in enumerate(opt.state.items()):
        out.update({f"opt.{i}.{k}": torch.as_tensor(v).clone()
                    for k, v in st.items()})
    out.update({f"lr.{i}": torch.as_tensor(g["lr"])
                for i, g in enumerate(opt.param_groups)})
    return out


def _pointda(seed, mixup_params=1.0):
    cfg = config.PointDAConfig(num_points=N, batch_size=B, epochs=2,
                               mixup_params=mixup_params).paper_recipe
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 2)
    xs = [_clouds(seed + i, (S, B, N, 3)) for i in (1, 2)]
    ys = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 10, (S, B)))
    gen = torch.Generator().manual_seed(seed)

    def scan():
        return pointda_train_scan(model, opt, sched, xs[0], ys, xs[1], gen,
                                  cfg)

    def steps():
        return [pointda_train_step(model, opt, sched, xs[0][i], ys[i],
                                   xs[1][i], gen, cfg) for i in range(S)]

    return model, opt, gen, scan, steps


def _seg(seed, mixup_params=1.0):
    cfg = config.PointSegDAConfig(num_points=N, batch_size=B, epochs=2,
                                  apply_PCM=True, mixup_params=mixup_params,
                                  Norm_on_trgt=True).resolved()
    model = make_model("dgcnn_seg", 8, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 2,
                                "SGD", cfg.momentum)
    xs = [_clouds(seed + i, (S, B, N, 3)) for i in (1, 2)]
    ys = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 8, (S, B, N)))
    gen = torch.Generator().manual_seed(seed)

    def scan():
        return pointsegda_train_scan(model, opt, sched, xs[0], ys, xs[1],
                                     gen, cfg)

    def steps():
        return [pointsegda_train_step(model, opt, sched, xs[0][i], ys[i],
                                      xs[1][i], gen, cfg) for i in range(S)]

    return model, opt, gen, scan, steps


def _spst(seed, mixup_params=1.0):
    cfg = config.SPSTConfig(num_points=N, batch_size=B, apply_PCM=True,
                            mixup_params=mixup_params)
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    opt = make_epoch_lr_optimizer(model, "ADAMW", 1e-3, 5e-5, 0.9)
    xs = [_clouds(seed + i, (S, B, N, 3)) for i in (1, 2)]
    ys = [torch.from_numpy(np.random.default_rng(seed + i).integers(
        0, 10, (S, B))) for i in (1, 2)]
    gen = torch.Generator().manual_seed(seed)

    def scan():
        return spst_train_scan(model, opt, xs[0], ys[0], xs[1], ys[1], 0.9,
                               0.8, gen, cfg)

    def steps():
        return [spst_train_step(model, opt, xs[0][i], ys[0][i], xs[1][i],
                                ys[1][i], 0.9, 0.8, gen, cfg)
                for i in range(S)]

    return model, opt, gen, scan, steps


@pytest.mark.parametrize("build", [_pointda, _seg, _spst],
                         ids=["pointda", "pointsegda", "spst"])
def test_chunk_equals_single_steps_bitwise(build):
    """A chunk of S steps on the CPU leaves the parameters, the optimizer
    (Adam, SGD with momentum, AdamW), the BN statistics and the generator
    where S single steps leave them, and returns their outputs stacked."""
    model, opt, gen, scan, _ = build(7)
    stacked = scan()
    model2, opt2, gen2, _, steps = build(7)
    singles = steps()
    per_step = graphs.unstack_steps(stacked)
    assert len(per_step) == S
    torch.testing.assert_close(per_step, singles, rtol=0, atol=0)
    a, b = _state(model, opt), _state(model2, opt2)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(gen.get_state(), gen2.get_state())


# ------------------------------------------------------ the trainer

def _train(tmp_path, scan_steps):
    cfg = config.PointDAConfig(synthetic=True, device="cpu", epochs=1,
                               model="pointnet", num_points=N, batch_size=32,
                               test_batch_size=32, save_every=1,
                               out_path=str(tmp_path / f"s{scan_steps}"),
                               scan_steps=scan_steps)
    pointda_trainer.train_pointda(cfg)
    exp = tmp_path / f"s{scan_steps}" / "MLSP"
    records = [json.loads(ln) for ln in (exp / "metrics.jsonl").open()]
    return records, torch.load(exp / "last.ckpt", weights_only=True)


def _same_runs(tmp_path, scan_steps):
    """The trainer at `scan_steps` and at 1: the same losses and
    checkpoint bit for bit, and records that say the CPU ran no step
    graph."""
    got, got_ckpt = _train(tmp_path, scan_steps)
    want, ckpt = _train(tmp_path, 1)
    assert [r["train"] for r in got] == [r["train"] for r in want]
    torch.testing.assert_close(got_ckpt["model"], ckpt["model"], rtol=0,
                               atol=0)
    torch.testing.assert_close(got_ckpt["optimizer"], ckpt["optimizer"],
                               rtol=0, atol=0)
    assert all(r["step_graphs"] is False for r in got + want)


def test_trainer_steps_do_not_depend_on_scan_steps(tmp_path):
    """8 steps an epoch (PointNet: the chunking does not depend on the
    model): scan_steps 3 (2 chunks, a tail of 2) gives the losses and
    checkpoint of scan_steps 1 (a chunk a step) bit for bit."""
    _same_runs(tmp_path, 3)


def test_trainer_tail_and_single_steps_equal_a_long_scan_steps(tmp_path):
    """The same at scan_steps 16, the default: the 8-step epoch is one
    tail of 8."""
    _same_runs(tmp_path, 16)


@pytest.mark.parametrize("scan_steps,chunks,singles", [
    (3, [[0, 1, 2], [3, 4, 5]], [6, 7]),  # chunks, then the tail
    (4, [[0, 1, 2, 3], [4, 5, 6, 7]], []),
    (16, [], list(range(8))),  # more than an epoch: the tail alone
    (1, [[i] for i in range(8)], [])])  # a chunk a step
def test_epoch_order_of_chunks_and_single_steps(scan_steps, chunks, singles):
    """`train_epoch` takes full chunks of `scan_steps` pairs, then the
    remaining pairs (`singles`) as one shorter chunk: `scan` sees stacks
    of S, ..., S, r steps, as the JAX trainer's scan and then its jitted
    single steps take them, and nothing goes round it; the chunks'
    stacked outputs come back one per step, in order."""
    pairs = torch.arange(8)[:, None, None].expand(8, 2, 1)
    seen = []

    def scan(first, second):
        seen.append(first[:, 0].tolist())
        return {"i": first[:, 0]}

    out = pointda_trainer.train_epoch(pairs, lambda a, b: (a, b), scan,
                                      scan_steps)
    assert seen == chunks + ([singles] if singles else [])
    assert [len(c) for c in seen] == (
        [scan_steps] * (8 // scan_steps) + ([8 % scan_steps]
                                            if 8 % scan_steps else []))
    assert [int(o["i"]) for o in out] == list(range(8))


# ------------------------------------------------------ the scanned eval

EVAL_N, EVAL_B, BATCHES, CHUNK = 32, 3, 5, 2  # chunks of 2, 2 and 1


def _jax_model(task, seed):
    jcfg = jconfig.EvalConfig(task=task, synthetic=True, num_points=EVAL_N,
                              test_batch_size=EVAL_B).resolved()
    jmodel, heads = jeval._build_model(jcfg)
    state = create_train_state(jmodel, jax.random.key(seed),
                               jnp.zeros((EVAL_B, EVAL_N, 3)), heads=heads)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        state.batch_stats)
    return state.replace(batch_stats=stats)


@pytest.mark.parametrize("task", ["pointda", "pointsegda"])
def test_scanned_eval_against_jax(task):
    """`scan_in_chunks` of `eval_scan` (`seg_eval_scan`) with a chunk of 2
    and a remainder against JAX's `scan_in_chunks` of its own on the same
    weights, JAX replaying the port's kNN graphs in call order: within
    1e-4."""
    seg = task == "pointsegda"
    state = _jax_model(task, 3)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model = make_model("dgcnn_seg" if seg else "dgcnn", 8 if seg else 10,
                       device="cpu")
    model.load_state_dict((dgcnn_seg_state_dict_from_jax if seg
                           else dgcnn_state_dict_from_jax)(variables))
    batches = [_clouds(20 + i, (EVAL_B, EVAL_N, 3)).numpy()
               for i in range(BATCHES)]
    recorded = []
    plain = _knn.knn_indices_torch

    def knn(x, k):
        out = plain(x, k)
        recorded.append(out.numpy().astype(np.int32))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_knn, "knn_indices_torch", knn)
        got = scan_in_chunks(seg_eval_scan if seg else eval_scan, model,
                             batches, chunk=CHUNK)

    it = iter(recorded)

    def replay(x, k, **_):
        shape = jax.ShapeDtypeStruct((*x.shape[:-1], k), jnp.int32)
        return io_callback(lambda: next(it), shape, ordered=True)

    jmod = _jdseg if seg else _jdgcnn
    scan = jseg_steps.seg_eval_scan if seg else jsteps.eval_scan
    jitted = (jseg_steps._seg_eval_forward_scan if seg
              else jsteps._eval_forward_scan)
    jitted.clear_cache()  # trace anew, with the graphs replayed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "knn_indices", replay)
        want = jsteps.scan_in_chunks(scan, state, batches, chunk=CHUNK)
    jitted.clear_cache()
    assert next(it, None) is None  # every recorded graph replayed
    assert got.shape == want.shape == (
        BATCHES, EVAL_B, *((EVAL_N, 8) if seg else (10,)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ refusals


def test_graphs_refuse_cpu_tensors():
    """The graph module takes CUDA tensors only: the CPU takes its steps
    eagerly."""
    model = make_model("dgcnn", 10, device="cpu")
    opt, _ = make_optimizer(model, 1e-3, 0.0, 1, 1)
    x = torch.zeros(S, B, N, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        graphs.StepGraph(lambda x: {}, (x,), (), model, opt,
                         torch.Generator())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        graphs.EvalGraph(lambda x: x, x[0], 4)


@pytest.mark.parametrize("cls,build", [
    (config.PointDAConfig, _pointda), (config.SPSTConfig, _spst),
    (config.PointSegDAConfig, _seg)], ids=["pointda", "spst", "pointsegda"])
def test_every_recipe_replays_steps(cls, build):
    """On the card every recipe replays its steps at scan_steps 1 and 16,
    PCM at mixup_params 0.4 and 0 included (its Beta ratio is drawn on the
    device), and the CPU takes them eagerly. PCM at 0.4 adds no host sync
    to the chunk that the paper ratio (mixup_params 1) does not make."""
    card = torch.device("cuda")
    for S_ in (1, 16):
        for kw in ({}, {"apply_PCM": True},
                   {"apply_PCM": True, "mixup_params": 0.4},
                   {"apply_PCM": True, "mixup_params": 0.0}):
            log = types.SimpleNamespace(lines=[])
            log.cprint = log.lines.append
            on, run_graphs = pointda_trainer.graphs_route(
                cls(scan_steps=S_, **kw), card, None, log)
            assert on and run_graphs is not None, kw
            (line,) = log.lines
            assert line.startswith("step graphs: on (") and (
                "replay one captured graph" if S_ > 1
                else "each step replays one captured graph") in line, line
    assert steps_mod.replays_steps(types.SimpleNamespace(is_cuda=True), None)
    assert not steps_mod.replays_steps(torch.zeros(1), None)
    syncs = {a: collections.Counter(host_syncs(build(7, a)[3]))
             for a in (1.0, 0.4)}
    assert syncs[0.4] == syncs[1.0]


FAMILIES = [
    ("dgcnn", 10, {}), ("pointnet", 10, {}), ("pointnet2", 10, {}),
    ("point_transformer", 10, dict(trans_dim=32, depth=2, heads=2,
                                   num_group=8, group_size=8,
                                   encoder_dims=32, fetch_idx=(0, 1))),
    ("hengshuang", 10, dict(nblocks=2, d_model=16)),
    ("vit", 10, dict(trans_dim=32, encoder_dims=32, depth=2, heads=2,
                     fetch_idx=(0, 1), encoder_type="dgcnn")),
    ("dgcnn_seg", 8, {}), ("hengshuang_seg", 8, dict(nblocks=2, d_model=16))]


@pytest.mark.parametrize("name,classes,kw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_eval_forward_reads_nothing_on_the_host(name, classes, kw):
    """No item, data-dependent shape or tensor made from a Python value in
    any family's eval forward: the scanned eval can capture each."""
    n = 512 if name == "pointnet2" else 64
    model = make_model(name, classes, device="cpu", **kw).eval()
    x = _clouds(5, (2, n, 3))
    with torch.inference_mode():
        assert host_syncs(model, x) == []


# ------------------------------------------------------ checkpoints

@pytest.mark.parametrize("name", ["ADAM", "SGD", "ADAMW"])
def test_card_checkpoint_resumes_on_the_cpu(tmp_path, name):
    """A checkpoint as the card's optimizers write it (each group's LR a
    tensor, `capturable` or `fused` set, Adam's step counts as a capturable
    optimizer keeps them) resumes on the CPU as the same checkpoint with
    float LRs: the CPU optimizer keeps its float LR and flags, and the
    next step is bit-equal."""
    cfg = config.PointDAConfig(num_points=N, batch_size=B).paper_recipe
    model = make_model("dgcnn", 10, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, 2, 2, name)
    x, y = _clouds(3, (B, N, 3)), torch.arange(B) % 10
    pointda_train_step(model, opt, sched, x, y, x.flip(0),
                       torch.Generator().manual_seed(0), cfg)
    plain = str(tmp_path / "plain.ckpt")
    checkpoint.save_train_state(plain, model, opt, sched, 0)
    raw = torch.load(plain, weights_only=True)
    card = copy.deepcopy(raw)
    for g in card["optimizer"]["param_groups"]:
        g["lr"] = torch.tensor(g["lr"])
        g["capturable" if name != "SGD" else "fused"] = True
    torch.save(card, tmp_path / "card.ckpt")

    def resume(path):
        m = make_model("dgcnn", 10, device="cpu")
        o, s = make_optimizer(m, cfg.lr, cfg.wd, 2, 2, name)
        checkpoint.load_train_state(path, m, o, s)
        assert all(isinstance(g["lr"], float) and not g.get("capturable")
                   and not g.get("fused") for g in o.param_groups)
        pointda_train_step(m, o, s, x, y, x.flip(0),
                           torch.Generator().manual_seed(1), cfg)
        return m.state_dict()

    a, b = resume(plain), resume(str(tmp_path / "card.ckpt"))
    assert all(torch.equal(a[k], b[k]) for k in a)
