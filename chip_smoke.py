"""Time the PyTorch/CUDA port's kernels (`mlsp_tpu_torch`) on one NVIDIA card.

Usage: python3 chip_smoke.py

It needs one CUDA card and nvcc, and exits non-zero without them. Each
kernel is timed alone, per launch (median of 30 launches between CUDA
events, queued behind a sleep on the card), beside its bound (max of
operations / 67 TFLOP/s and bytes / 3.35 TB/s, the H100 SXM at 700 W)
and its plain PyTorch version's time. One JSON line a phase; a failed
guard exits non-zero before the last line:

  device       the card, with the name and power limit nvidia-smi reports
  build        compile every kernel in mlsp_tpu_torch/csrc (ptxas registers
               and spills per kernel)
  knn          K1 at the graph shapes of the benchmark's cells
               (KNN_CELL_SHAPES), with the share of candidates its register
               filter let through and the buffer flushes a query took
               (`knn_cuda_stats`); then a points rank's query range at
               P = 2 and 4 (RANGE_SHAPES, the bound B·nq·N·(2C + 4))
  edge         K2-fwd, eval form (max, min) and train form (with the sum
               and sum of squares), at the four EdgeConv inputs of a B=32,
               N=1024 DGCNN forward and on the repeated-point graph (a
               cloud of one point: every row's neighbours are the k lowest
               indices, each of in-degree N)
  edge_bwd     K2-bwd at the same inputs, against autograd through the
               plain version
  knn_moments  K3 at [32, 1024, 3] with k = 20 and at the seg targets'
               [16, 2048, 3] with k = near = 10
  fps          K4 at PCM's launches ([64, 1024] and the seg step's
               [32, 2048], npoint = N) and at the data pipeline's buckets
               ([64, 4096], [64, 8192], [16, 16384], npoint = 1024), with
               its chain floor (one cloud: the time of a dependent step,
               times npoint)
  paths        each main path once at full width through the package's own
               entry points, its launches counted from 0 (PATHS): a DGCNN
               serving bundle's request of 32 clouds at N=1024 (a replay
               of its captured eval forward); one train step of the paper
               recipe (B=32, N=1024), of the seg cell's recipe
               (configs/pointsegda_mlsp.yaml + PCM, B=16, N=2048) and of
               Hengshuang at its published width (transformer_dim 512,
               PCM + DefRec on the target), each a replay of its captured
               step graph as the trainers run it; a seg eval batch of 32
               at N=2048 through `evaluate_seg` (a replayed eval forward)

Each timed input first passes a guard against the plain version, so that
a broken kernel is never timed: K1's neighbour sets by distance
(`testing.knn_set_gap`) and the counting instance's indices equal to
K1's, a query range index-equal to the whole launch's rows; K2-fwd's max
and min bit-equal and its sums within 1e-5 of their terms' magnitudes;
K2-bwd's du within 1e-5 of its terms' magnitudes
(`testing.edge_grad_magnitude`) and bit-equal over two launches; K3's
neighbour sets by distance and its sums within 1e-5 of their terms'
magnitudes; K4's indices equal. Each path's launches must equal PATHS',
all inside graph replays, and its outputs must be finite. Correctness is
held by the card tests
(`python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py`);
end-to-end time and outputs by the benchmark (`benchmark/run.py`).

Then the `kernels` line (each kernel's rows and its launches by path),
nvidia-smi's line and `{"ok": true, ...}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from mlsp_tpu_torch import ServingModel, make_model, save_serving_bundle
from mlsp_tpu_torch.data.synthetic import (
    make_classification,
    make_segmentation,
)
from mlsp_tpu_torch.models import model_kwargs
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.edge import edge_moments_torch
from mlsp_tpu_torch.ops.fps import fps_torch
from mlsp_tpu_torch.ops.kernels import (
    _build,
    edge_moments_bwd_cuda,
    edge_moments_cuda,
    fps_cuda,
    knn_cuda,
    knn_moments_cuda,
)
from mlsp_tpu_torch.ops.kernels.knn import knn_cuda_stats
from mlsp_tpu_torch.ops.knn import (
    edge_features,
    knn_gather,
    knn_indices,
    knn_indices_torch,
)
from mlsp_tpu_torch.ops.normals import knn_moments_torch
from mlsp_tpu_torch.testing import edge_grad_magnitude, knn_set_gap
from mlsp_tpu_torch.train import make_optimizer
from mlsp_tpu_torch.train.graphs import Graphs
from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
from mlsp_tpu_torch.train.seg_steps import pointsegda_train_scan
from mlsp_tpu_torch.train.steps import pointda_train_scan
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    load_yaml,
)

SEED = 0
B, N, K, NUM_CLASS = 32, 1024, 20, 10  # utils/config.py PointDAConfig
# H100 SXM peaks at the full 700 W (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
QUEUE_CYCLES = 100_000_000  # the sleep timed launches queue behind (~60 ms)
# K1's per-launch time at the graph shapes the benchmark's cells build (B,
# N, C, k): the DGCNN forward at B32 N1024 (train, serve's largest
# request), the seg train forward at B16 N2048 and its eval at B32 N2048,
# Hengshuang's levels at k 16, a Point-ViT "dgcnn" group (N 32) and a
# serving request of one cloud
KNN_CELL_SHAPES = (
    (32, 1024, 3, K), (32, 1024, 64, K), (32, 1024, 128, K),
    (16, 2048, 3, K), (16, 2048, 64, K), (32, 2048, 3, K), (32, 2048, 64, K),
    (32, 256, 3, 16), (32, 64, 3, 16), (32, 16, 3, 16), (32, 4, 3, 4),
    (2048, 32, 3, K), (2048, 32, 64, K), (1, 1024, 3, K), (1, 1024, 64, K),
    (1, 1024, 128, K))
# K1's query range (a points mesh rank's rows, `parallel.points_rows`) at
# the DGCNN layers' [32, 1024, C] and the seg layers' [16, 2048, C], for
# the points axes P
RANGE_SHAPES = ((32, 1024, 3), (32, 1024, 64), (32, 1024, 128),
                (16, 2048, 3), (16, 2048, 64))
RANGE_P = (2, 4)
# K3: the paper step's target clouds (k = 20) and the seg step's (k = near
# = 10)
KNN_MOMENTS_SHAPES = ((32, 1024, K), (16, 2048, 10))
# K4: PCM's one launch for both batches (npoint = N), paper and seg; the
# data pipeline's chunks of up to 64 clouds, tiled to a power-of-two
# bucket, reduced to N points
FPS_SHAPES = ((2 * B, N, N), (32, 2048, 2048), (64, 4096, N), (64, 8192, N),
              (16, 16384, N))
# each path's launches (`paths`): a DGCNN forward builds 5 kNN graphs (K1)
# and runs 4 EdgeConv layers (K2-fwd); a paper step two such forwards with
# their backward (K2-bwd), the normals (K3) and PCM's FPS of both batches
# (K4); a seg step two DGCNNSeg forwards of 4 graphs, K3 and K4; the
# Hengshuang step 15 K1 and 9 K4; a DGCNNSeg eval forward 4 K1
PATHS = {
    "serve": {"knn": 5, "edge_moments": 4},
    "train_paper": {"knn": 10, "edge_moments": 8, "edge_moments_bwd": 8,
                    "knn_moments": 1, "fps": 1},
    "train_seg": {"knn": 8, "knn_moments": 1, "fps": 1},
    "train_hengshuang": {"knn": 15, "fps": 9},
    "eval_seg": {"knn": 4},
}
KERNELS = {
    "knn": ("mlsp_tpu_torch/csrc/knn.cu",
            "mlsp_tpu/ops/pallas/knn_pallas.py:69"),
    "edge_moments": ("mlsp_tpu_torch/csrc/edge_moments.cu",
                     "mlsp_tpu/ops/pallas/edge_pallas.py:233"),
    "edge_moments_bwd": ("mlsp_tpu_torch/csrc/edge_moments.cu",
                         "mlsp_tpu/ops/pallas/edge_pallas.py:302"),
    "knn_moments": ("mlsp_tpu_torch/csrc/knn_moments.cu",
                    "mlsp_tpu/ops/pallas/normals_pallas.py:93"),
    "fps": ("mlsp_tpu_torch/csrc/fps.cu",
            "mlsp_tpu/ops/pallas/fps_pallas.py:59"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def nccl_version() -> str:
    return ".".join(map(str, torch.cuda.nccl.version()))


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over `reps` single calls, each between two CUDA events. The
    calls queue up behind a sleep on the card, so that the device does not
    wait on the host between them and the events measure device time
    (where the host needs longer than the sleep to queue them all, as for
    the plain FPS, the later calls include host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in pairs:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def knn_cost(x: torch.Tensor, k: int = K,
             nq: int | None = None) -> tuple[float, float]:
    """Per pair of (query, point): 2C for the dot product, 4 to form, clamp
    and compare the distance, B·nq·N·(2C + 4) for a query range of nq
    (the whole cloud by default); x read once, the indices written
    once."""
    b, n, c = x.shape
    nq = n if nq is None else nq
    return b * nq * n * (2 * c + 4), b * n * c * 4 + b * nq * k * 8


def edge_cost(u: torch.Tensor, idx: torch.Tensor,
              moments: bool = False) -> tuple[float, float]:
    """Eval form (max and min): 2 compares per gathered value; train form
    (with the sum and sum of squares): 5. u and idx read once, the 2 or 4
    outputs written once."""
    b, n, c = u.shape
    outs = 4 if moments else 2
    return (b * n * K * c * (5 if moments else 2),
            b * n * c * 4 + idx.numel() * 8 + outs * b * n * c * 4)


def edge_bwd_cost(u: torch.Tensor, k: int) -> tuple[float, float]:
    """Per edge and channel 2 compares and about 6 operations to form and
    add the contribution; u, mx, mn and the four cotangents read once, idx
    once, du written once."""
    b, n, c = u.shape
    return 8.0 * b * n * k * c, 8 * b * n * c * 4 + b * n * k * 8


def fps_cost(b: int, n: int, npoint: int = 0) -> tuple[float, float]:
    """8 operations per point and step (3 subtractions, 3 products, 2
    additions; the min and the compare not counted), npoint (N unless
    given) steps; the cloud read once, the indices written once."""
    npoint = npoint or n
    return 8.0 * b * n * npoint, b * n * 3 * 4 + b * npoint * 8


def knn_moments_cost(b: int, n: int, k: int = K) -> tuple[float, float]:
    """K1's selection at C=3 plus 12 FMAs per neighbour; x read once, the
    twelve sums written once."""
    return (b * n * n * (2 * 3 + 4) + 2.0 * 12 * b * n * k,
            b * n * 3 * 4 + b * n * 12 * 4)


def row(what: str, shape, fn, plain_fn, cost, plain_reps: int = 30,
        **extra) -> dict:
    """One timed input: the kernel's and the plain version's median ms
    beside the bound."""
    b_ms, b_by = bound(*cost)
    return {"input": what, "shape": list(shape), "ms": median_ms(fn),
            "plain_ms": median_ms(plain_fn, reps=plain_reps,
                                  warmup=min(plain_reps, 5)),
            "bound_ms": b_ms, "bound_by": b_by, **extra}


def cloud(g: torch.Generator, b: int, n: int, c: int, device
          ) -> torch.Tensor:
    """The synthetic clouds at C = 3, gaussian features otherwise."""
    if c == 3:
        return torch.from_numpy(make_classification(
            b, n, NUM_CLASS, seed=SEED + n)[0]).to(device)
    return torch.randn(b, n, c, generator=g).to(device)


def knn_rows(g: torch.Generator, device) -> tuple[list, list]:
    """K1 at KNN_CELL_SHAPES and its query ranges at RANGE_SHAPES."""
    rows = []
    for b, n, c, k in KNN_CELL_SHAPES:
        x = cloud(g, b, n, c, device)
        got = knn_cuda(x, k)
        idx, stats = knn_cuda_stats(x, k)
        gap, tol = knn_set_gap(x, got, knn_indices_torch(x, k))
        check(bool(torch.equal(idx, got)),
              f"knn_cuda_stats indices differ from knn_cuda's at {x.shape}")
        check(bool((gap <= tol).all()),
              f"K1 disagrees with the plain kNN at {x.shape}, k {k}")
        rows.append(row(f"k={k}", x.shape, lambda: knn_cuda(x, k),
                        lambda: knn_indices_torch(x, k), knn_cost(x, k),
                        k=k, pass_share=stats["pass_share"],
                        flushes_per_query=stats["flushes_per_query"]))
    ranges = []
    for b, n, c in RANGE_SHAPES:
        x = cloud(g, b, n, c, device)
        whole = knn_cuda(x, K)
        for p in RANGE_P:
            q0, nq = 0, -(-n // p)  # rank 0's rows
            check(bool(torch.equal(knn_cuda(x, K, (q0, nq)),
                                   whole[:, q0:q0 + nq])),
                  f"K1's query range differs from the whole launch's rows "
                  f"at {x.shape}, P {p}")
            ranges.append(row(f"points {p}: rows [{q0}, {q0 + nq})",
                              x.shape, lambda: knn_cuda(x, K, (q0, nq)),
                              lambda: knn_indices_torch(x, K, (q0, nq)),
                              knn_cost(x, K, nq), points=p))
    return rows, ranges


def edge_inputs(device) -> list:
    """The (name, graph features xg, u) of a B=32 serving forward's four
    EdgeConv layers, as DGCNN.forward and EdgeConvM.forward compute them,
    and the repeated-point graph at conv1's u."""
    g = torch.Generator().manual_seed(SEED)
    model = make_model("dgcnn", NUM_CLASS, device=device, generator=g, k=K)
    model.eval()
    x = torch.from_numpy(make_classification(B, N, NUM_CLASS, seed=SEED + 2)[0]
                         ).to(device)
    with torch.no_grad():
        T = model.input_transform_net(edge_features(x, knn_indices(x, K)))
        feats = [torch.einsum("bnc,bdc->bnd", x, T)]
        for conv in (model.conv1, model.conv2, model.conv3):
            feats.append(conv(feats[-1]))
        out = []
        for i, (conv, f) in enumerate(zip(
                (model.conv1, model.conv2, model.conv3, model.conv4), feats)):
            w = conv.conv[0].weight.flatten(1)
            out.append((f"conv{i + 1}", f, F.linear(f, w[:, :f.shape[-1]])))
    out.append(("conv1, one repeated point",
                torch.full((B, N, 3), 0.5, device=device), out[0][2]))
    return out


def edge_rows(g: torch.Generator, device) -> tuple[dict, list]:
    """K2-fwd's two forms and K2-bwd at `edge_inputs`."""
    fwd = {"eval": [], "train": []}
    bwd = []
    for name, xg, u in edge_inputs(device):
        idx = knn_cuda(xg, K)
        for form, moments in (("eval", False), ("train", True)):
            got = edge_moments_cuda(u, idx, moments)
            want = edge_moments_torch(u, idx, moments)
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"K2-fwd max/min not bit-equal on {name}")
            if moments:
                scale = (edge_moments_torch(u.abs(), idx, True)[2], want[3])
                for gs, ws, s in zip(got[2:], want[2:], scale):
                    check(bool(((gs - ws).abs() <= 1e-5 * s).all()),
                          f"K2-fwd sums outside tolerance on {name}")
            fwd[form].append(row(name, u.shape,
                                 lambda: edge_moments_cuda(u, idx, moments),
                                 lambda: edge_moments_torch(u, idx, moments),
                                 edge_cost(u, idx, moments)))
        mx, mn = edge_moments_cuda(u, idx, False)
        cots = [torch.randn(u.shape, generator=g).to(device) for _ in range(4)]
        du = edge_moments_bwd_cuda(u, idx, mx, mn, *cots)
        again = edge_moments_bwd_cuda(u, idx, mx, mn, *cots)
        uu = u.detach().clone().requires_grad_()
        plain_outs = edge_moments_torch(uu, idx, True)
        want = torch.autograd.grad(plain_outs, uu, cots, retain_graph=True)[0]
        check(torch.equal(du.view(torch.int32), again.view(torch.int32)),
              f"K2-bwd gave another du on a second launch on {name}")
        check(bool(((du - want).abs()
                    <= 1e-5 * edge_grad_magnitude(u, idx, cots)).all()),
              f"K2-bwd outside tolerance on {name}")
        bwd.append(row(name, u.shape,
                       lambda: edge_moments_bwd_cuda(u, idx, mx, mn, *cots),
                       lambda: torch.autograd.grad(plain_outs, uu, cots,
                                                   retain_graph=True),
                       edge_bwd_cost(u, K)))
    return fwd, bwd


def knn_moments_rows(device) -> list:
    """K3 at KNN_MOMENTS_SHAPES."""
    rows = []
    for b, n, k in KNN_MOMENTS_SHAPES:
        x = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                 seed=SEED + 5)[0]).to(device)
        s1, s2, idx = knn_moments_cuda(x, k, return_indices=True)
        gap, tol = knn_set_gap(x, idx, knn_indices_torch(x, k))
        check(bool((gap <= tol).all()),
              f"K3 neighbour sets disagree at {x.shape}, k {k}")
        gx = knn_gather(x, idx)
        outer = gx[..., :, None] * gx[..., None, :]
        for s, w, m in ((s1, gx.sum(-2), gx.abs().sum(-2)),
                        (s2, outer.sum(-3).flatten(-2),
                         outer.abs().sum(-3).flatten(-2))):
            check(bool(((s - w).abs() <= 1e-5 * m + 1e-30).all()),
                  f"K3 sums outside tolerance at {x.shape}, k {k}")
        rows.append(row(f"k={k}", x.shape, lambda: knn_moments_cuda(x, k),
                        lambda: knn_moments_torch(x, k),
                        knn_moments_cost(b, n, k), k=k))
    return rows


def fps_rows(g: torch.Generator, device) -> list:
    """K4 at FPS_SHAPES with its chain floor: one cloud alone, npoint
    against npoint = 2, gives the time of a dependent step; npoint of them
    is the design's floor."""
    rows = []
    for b, n, npoint in FPS_SHAPES:
        x = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                 seed=SEED + n)[0]).to(device)
        start = torch.randint(0, n, (b,), generator=g).to(device)
        check(bool(torch.equal(fps_cuda(x, npoint, start),
                               fps_torch(x, npoint, start))),
              f"K4 disagrees with the plain loop at {x.shape}, npoint "
              f"{npoint}")
        one, s1 = x[:1].contiguous(), start[:1].contiguous()
        step = ((median_ms(lambda: fps_cuda(one, npoint, s1))
                 - median_ms(lambda: fps_cuda(one, 2, s1))) / (npoint - 2))
        rows.append(row(f"npoint={npoint}", x.shape,
                        lambda: fps_cuda(x, npoint, start),
                        lambda: fps_torch(x, npoint, start),
                        fps_cost(b, n, npoint), plain_reps=3, npoint=npoint,
                        chain_floor_ms=step * npoint))
    return rows


def repo_file(rel: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def counted(fn):
    """fn()'s result with the launches it made and those of them inside
    graph replays."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launches(), kernels.launches_in_graphs()


def path_model(cfg, name: str, device) -> torch.nn.Module:
    """The trainers' model of a config, from seeded weights."""
    return make_model(name, cfg.num_class, device=device,
                      generator=torch.Generator().manual_seed(SEED),
                      **model_kwargs(cfg, name))


def train_path(cfg, name: str, device):
    """One step of the recipe as the trainers take it: a chunk of one
    replay of the captured step graph. Returns (model, counted losses)."""
    seg = isinstance(cfg, PointSegDAConfig)
    model = path_model(cfg, name, device).train()
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10,
                                cfg.optimizer, cfg.momentum)
    b, n = cfg.batch_size, cfg.num_points
    x, y = (make_segmentation if seg else make_classification)(
        2 * b, n, cfg.num_class, seed=SEED)
    x = torch.from_numpy(x).to(device).view(1, 2, b, n, 3)
    y = torch.from_numpy(y).to(device).view(1, 2, b, *y.shape[1:])
    gen = torch.Generator(device=device).manual_seed(SEED)
    scan = pointsegda_train_scan if seg else pointda_train_scan

    def step():
        out = scan(model, opt, sched, x[:, 0], y[:, 0], x[:, 1], gen, cfg,
                   Graphs())
        return out[0] if seg else out
    return model, counted(step)


def paths(device) -> dict:
    """Each path of PATHS once; its launches, those inside replays and
    whether its outputs were finite."""
    res = {}
    paper = PointDAConfig().paper_recipe
    model = path_model(paper, "dgcnn", device).eval()
    clouds = make_classification(B, N, NUM_CLASS, seed=SEED + 1)[0]
    with tempfile.TemporaryDirectory() as tmp:
        save_serving_bundle(model, tmp, N, NUM_CLASS)
        served = ServingModel(tmp, device=device)
        res["serve"] = counted(lambda: served.predict(clouds))
    seg_cfg = dataclasses.replace(load_yaml(
        PointSegDAConfig, repo_file("configs/pointsegda_mlsp.yaml")),
        apply_PCM=True).resolved()
    heng = dataclasses.replace(load_yaml(
        PointDAConfig, repo_file("configs/pointda_hengshuang.yaml")),
        transformer_dim=512)
    res["train_paper"] = train_path(paper, "dgcnn", device)[1]
    seg_model, res["train_seg"] = train_path(seg_cfg, "dgcnn_seg", device)
    res["train_hengshuang"] = train_path(heng, "hengshuang", device)[1]
    x, y = make_segmentation(32, seg_cfg.num_points, seg_cfg.num_class,
                             seed=SEED + 2)
    res["eval_seg"] = counted(lambda: evaluate_seg(seg_model, x, y, 32,
                                                   graphs=Graphs()))
    out = {}
    for path, (got, launches, in_graphs) in res.items():
        leaves = (got.values() if isinstance(got, dict)
                  else got if isinstance(got, tuple) else [got])
        finite = all(bool(torch.isfinite(torch.as_tensor(v)).all())
                     for v in leaves)
        want = {**dict.fromkeys(KERNELS, 0), **PATHS[path]}
        check(launches == want,
              f"{path} launched {launches}, not {want}")
        check(in_graphs == launches,
              f"{path}: launches outside graph replays: {in_graphs}")
        check(finite, f"{path}: outputs not finite")
        out[path] = {"launches": launches, "in_graphs": in_graphs,
                     "finite": finite}
    return out


def run(device: torch.device, card: str) -> None:
    """Every phase after `device`; prints the `kernels` line."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         dir=str(_build.build_dir()),
         ptxas={name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "entry function" in ln or "registers" in ln
                       or "spill" in ln]
                for name, log in logs.items()})
    g = torch.Generator().manual_seed(SEED)
    knn, ranges = knn_rows(g, device)
    emit("knn", kernel="knn", per_launch=knn, query_range=ranges, card=card)
    fwd, bwd = edge_rows(g, device)
    emit("edge", kernel="edge_moments", per_launch=fwd["eval"],
         train_form=fwd["train"], card=card)
    emit("edge_bwd", kernel="edge_moments_bwd", per_launch=bwd, card=card)
    moments = knn_moments_rows(device)
    emit("knn_moments", kernel="knn_moments", per_launch=moments, card=card)
    fps = fps_rows(g, device)
    emit("fps", kernel="fps", per_launch=fps, card=card)
    by_path = paths(device)
    emit("paths", **by_path)
    rows = {"knn": {"per_launch": knn, "query_range": ranges},
            "edge_moments": {"per_launch": fwd["eval"],
                             "train_form": fwd["train"]},
            "edge_moments_bwd": {"per_launch": bwd},
            "knn_moments": {"per_launch": moments},
            "fps": {"per_launch": fps}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, **rows[name], "library_ms": None,
         "launches_by_path": {p: r["launches"][name]
                              for p, r in by_path.items()},
         "check": "passed"}  # a failed guard exits before this line
        for name, (source, replaces) in KERNELS.items()]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # Distance and feature matmuls in true float32 (kNN order downstream).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         nccl=nccl_version(), nvidia_smi=card)
    run(device, card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
