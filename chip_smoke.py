"""Drive the PyTorch/CUDA port (`mlsp_tpu_torch`) on one NVIDIA card.

Usage: python3 chip_smoke.py

It needs one CUDA card and nvcc, and exits non-zero without them. Phases,
one JSON line each; any failure exits non-zero before the last line:

  device       the card, with the name and power limit nvidia-smi reports
  build        compile every kernel in mlsp_tpu_torch/csrc (ptxas registers
               and spills per kernel)
  knn          the kNN kernel (K1) against its plain version, on the inputs
               the serving forward gives it, plus a ragged N, then on
               integer coordinates (every distance exact), where the
               indices must be equal, tie order included
  edge         the neighbourhood-statistics kernel (K2-fwd) against its
               plain version, on the serving forward's inputs, a ragged
               N = 1000 at C = 64 and the repeated-point graph (a cloud of
               one point: every row's neighbours are the k lowest indices,
               each of which has in-degree N)
  fps          the FPS kernel (K4) against its plain version at 2B=64,
               N = npoint = 1024 (PCM's one launch), B=32 at N = 1000 and
               2048, npoint < N, and on duplicated points, then at the data
               pipeline's buckets [64, 4096], [64, 8192] and [16, 16384]
               with npoint = 1024, random starts: the indices must be
               equal; a cloud of 16385 points (one over the limit) raises
  knn_moments  the kNN normal-moments kernel (K3) at B=32, N=1024, k=20:
               its neighbour sets, its sums against sums over its own
               neighbours, and the normals of both routes; on integer
               coordinates its indices must equal the plain version's
  edge_bwd     the EdgeConv backward kernel (K2-bwd) against autograd of
               the plain version at the four train shapes, on values tied
               at the max and min, a ragged N = 1000 at C = 64 and the
               repeated-point graph
  serve        a main path: a full-width DGCNN (k=20, N=1024, 10 classes,
               random seeded weights and BatchNorm) is saved as a serving
               bundle, loaded with ServingModel on the card, and answers 5
               requests (4 x 32 clouds, 1 x 7); launches counted over
               exactly those requests; answers held against the plain path
  train        the other main path: 3 paper-recipe PointDA train steps
               (PointDAConfig().paper_recipe: B=32, N=1024, k=20, dropout
               0.5, bf16 heads) from seeded random weights and BatchNorm;
               launches counted over exactly those steps (per step K1 10,
               K2-fwd 8, K2-bwd 8, K3 1, K4 1); the first step rerun through
               the plain versions on the card from the same weights and
               generator seed, on the kernel run's kNN graphs and FPS
               orders, losses and gradients compared at fixed bounds
  data         96 synthetic clouds of ragged sizes in [1025, 16384]
               through the data pipeline's `standardize_clouds` on the card
               (K4 per power-of-two bucket) and again with the plain FPS on
               the card: the [96, 1024, 3] outputs must be bitwise equal;
               K4's launches and buckets counted
  trainer      the CLI in-process: `trainer --paper_recipe True --synthetic
               True --epochs 2 --save_every 1` (full width, B=32, N=1024);
               launches counted over the run (K1 100E+15, K2-fwd 80E+12,
               K2-bwd 64E, K3 8E, K4 8E for E epochs), finite losses, the
               files and log lines it leaves; then `--epochs 3 --resume
               last.ckpt` with `--profile_dir` must resume at epoch 2 and
               take one epoch (its trace gives the device's busy share)
  eval, infer  the CLI's `eval` and `infer` on the target test split from
               the trainer's model.ckpt, through the kernels and with
               `--knn_backend torch`: classes agree on >= 99% of clouds,
               max |dprob| <= 2e-2, eval's accuracy equals infer's, each
               3 forwards (K1 15, K2-fwd 12 launches)
  branches     every PointDA recipe flag at full width (B=32, N=1024, k=20):
               2 steps each of the all-branch recipe (DefRec on source and
               target, PCM, source DefRec + normal + density, normals,
               scan, density, DefRec + normal + density, SPL_v2: per step
               K1 45, K2-fwd 36, K2-bwd 36, K3 3, K4 1), the paper recipe
               with the Chamfer-transported labels, and the paper recipe
               under SGD and AdamW (K1 10, K2-fwd 8, K2-bwd 8, K3 1, K4 1);
               finite losses, step p50 and peak memory; the all-branch
               first step rerun through the plain versions on the kernel
               run's graphs and FPS order with eval-mode BN
  spst         the `spst` CLI in-process from the trainer's model.ckpt: 3
               rounds of 1 epoch with PCM at a threshold that selects every
               target cloud (K1 30+155R, K2-fwd 24+124R, K2-bwd 64R, K4 8R
               for R rounds); the LR of each epoch (torch's cosine, rising
               again in round 3), the spl/cls weights, the SSL heads
               unchanged, model.ckpt, best_model.ckpt and
               finetune_convergence.json; the selection at the paper's
               threshold printed
  seg_kernels  K1, K3 and K4 against their plain versions at the PointSegDA
               shapes: K1 on a B=16, N=2048 seg forward's four inputs (C=3,
               3, 64, 64) and at the eval batch's [32, 2048, 64]; K3 at
               [16, 2048, 3] with k = near = 10 (sums and normals); K4 at
               PCM's [32, 2048, 3] with npoint 2048, index-equal
  seg_train    a main path: 3 seg train steps, configs/pointsegda_mlsp.yaml
               plus apply_PCM (DGCNNSeg k=20, N=2048, 8 classes, B=16) from
               seeded random weights and BatchNorm; per step K1 8, K3 1, K4
               1, no K2; the first step rerun through the plain versions on
               the kernel run's kNN graphs and FPS orders, at the train
               step's bounds (train-mode BN)
  seg_trainer  the CLI in-process: `seg --config
               configs/pointsegda/adobe2faust.yaml --synthetic True
               --apply_PCM True --epochs 2` (K1 32E+4, K3 3E, K4 3E for E
               epochs), finite losses, model.ckpt and the log lines
  seg_eval_infer  `eval` and `infer --task pointsegda` from that
               model.ckpt, through the kernels and with `--knn_backend
               torch`: per-point classes agree on >= 99% of points, max
               |dprob| <= 2e-2, eval's accuracy equals infer's, 1 forward
               each (K1 4)
  families     PointNet, PointNet++, PointTransformer and the Hengshuang
               classifier and segmenter at full width: K1 at every graph a
               Hengshuang forward builds ([32, N, 3], N = 1024, 256, 64,
               16, 4; seg [16, N, 3], N = 2048, 512, 128, 32, 8; k =
               min(16, N)) by equal sorted distance sets and, on integer
               coordinates, equal indices; K4 at every (B, N, npoint) the
               families launch, index for index; 2 steps each through
               `pointda_train_step` at B=32, N=1024 (PointNet: PCM + DefRec
               on the target, K4 1 a step; PointNet++: PCM, K4 3;
               PointTransformer and Hengshuang: their YAMLs, K4 3 and K1 15
               + K4 9), p50 and peak memory, and the PointTransformer and
               Hengshuang first steps against the plain route (eval-mode
               BN); 2 Hengshuang seg steps at B=16, N=2048 (K1 20 + K4 8
               a step), p50 and peak memory; a full-width PointTransformer
               bundle answering 3
               requests of 32 clouds (K4 3); the CLI in-process: `trainer
               --config configs/pointda_pointtransformer.yaml` (2 epochs)
               and `configs/pointda_hengshuang.yaml` (1 epoch), `eval` and
               `infer --model ...` from each model.ckpt on both routes, and
               `spst --model ...` (1 round of 1 epoch with PCM); `seg
               --config configs/pointsegda_hengshuang.yaml` (1 epoch) and
               `eval`/`infer --task pointsegda --model hengshuang_seg` on
               both routes; exact launch counts on every path (a forward:
               PointNet++ K4 2, PointTransformer K4 1, Hengshuang K1 5 and
               K4 4, with its decoder K1 10 and K4 4); then K1 and K4 timed
               per launch at these shapes, each path's epoch time and its
               eval/infer clouds/s
  vit_interop  Point-ViT and checkpoint interop: K1 on the inputs of a
               full-width vit forward with the "dgcnn" group embedder
               (the 64 groups of 32 points folded into the batch:
               [2048, 32, C], C = 3, 3, 64, 64, 128, k = 20) by sorted
               distance sets and, on integer coordinates, exact indices;
               K4 at its [32, 1024] -> 64; K1 and K3 at 65,543 clouds of
               32 points (above gridDim.y's 65535: one launch each, exact
               indices); 2 steps of configs/pointda_vit.yaml (PCM, DefRec
               on the target, B=32, N=1024) with the "relative" and the
               "dgcnn" embedders (K4 3 and K1 10 + K4 3 a step), p50 and
               peak memory, each first step against the plain route
               (eval-mode BN); a full-width vit bundle answering 3
               requests of 32 clouds (K4 3); the CLI in-process: `trainer
               --config configs/pointda_vit.yaml` (2 epochs), `eval` and
               `infer --model vit` on both routes, `spst --model vit` (1
               round of 1 epoch with PCM); `export` of the `trainer`
               phase's DGCNN model.ckpt and the `seg_trainer` phase's
               DGCNNSeg one, and `eval`/`infer --from_torch True` of each
               model.pt against the same of its .ckpt (DGCNN bit-equal,
               DGCNNSeg within the seg bounds); exact launch counts on
               every path; then K1 and K4 per launch at these shapes, the
               vit epoch, eval/infer clouds/s, and the seconds of `export`
               and of a `--from_torch` load
  serving_g2   a DGCNNSeg and a HengshuangSeg weights bundle (N =
               2048, 8 classes, seeded random weights and BatchNorm) answer
               3 requests of 32 clouds on the card with per-point logits
               (K1 4, and K1 10 + K4 4, a request), held against the plain
               route (classes >= 99%, max |dprob| <= 2e-2); `aot` (the CLI)
               of the trainer's DGCNN (N = 1024) and the seg trainer's
               DGCNNSeg checkpoints: a torch.export program traced on the
               CPU on the plain route (no kernel, by design: the JAX
               package forces its XLA kNN into its bundle), moved to the
               card by ServingModel, its self-check and its answers against
               the weights bundle's (the kernels); p50 latency and clouds/s
               of every bundle
  ddp_ingest   the paper-recipe step at B=32, N=1024, with eval-
               and with train-mode BN, on 2 gloo ranks sharing the card (16
               rows each; per rank and step K1 10, K2-fwd 8, K2-bwd 8 on its
               rows, K3 1 and K4 1 on the global batch), the ranks
               bit-equal, against one process's step on the plain route
               replaying the ranks' graphs and FPS orders, float32 heads
               (eval-mode BN: the rounding bounds; train-mode BN: the
               train bounds, running statistics too, each plus its own
               change in the single process under a 1e-6 shift; the same
               step with BN statistics over each rank's own rows planted
               must fail them), each rank's K1 graphs at [16, 1024, C]
               against the plain kNN and K1 index-equal on integer
               coordinates of those shapes; `torchrun --standalone
               --nproc_per_node 1` of
               `trainer --mesh_data 1 --paper_recipe True` (2 epochs, NCCL,
               the single-process trainer's launches); `standardize_files`
               over 96 seeded .npy clouds of 1,000-16,384 points through the
               native C++ ingest (K4 per bucket chunk), bitwise against the
               same ingest with the plain FPS, its unit cube within 1e-6 of
               a float64 one, and against the numpy route (the difference,
               and the clouds whose FPS order flips at a near tie,
               reported), seconds of both; `calibrate --force` (K2
               against the gather route at chipcal.SHAPES, K1 138, K2-fwd
               69, K2-bwd 69 launches), then on its inputs K1 against the
               plain kNN and K2's statistics and du against the gather
               route's
  times        median kernel and plain-version times (CUDA events, the
               launches queued behind a sleep on the card) beside each
               kernel's bound, K2-bwd on the repeated-point graph too, K4
               at the pipeline's shapes with its chain floor, serving
               latency and throughput at B=32, the train step's p50 on
               both routes, and the trainer's epoch time, steps/s in its
               loop, device busy share and eval/infer clouds/s; at the seg
               shapes K1, K3 and K4 per launch, the LinearEdgeBlock max
               through K2 (an option, on no path), the seg step's p50 on
               both routes, the seg trainer's epoch time and seg eval/infer
               clouds/s; K1 and K2-bwd on a simulated scan batch (about a
               quarter exact zeros: K1's tie path, K2-bwd's in-degree in the
               hundreds), checked against their plain versions and timed
               per launch beside the paper batch's

Then the `kernels` line, nvidia-smi's line and `{"ok": true, ...}`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from mlsp_tpu_torch import (
    ServingModel,
    cli,
    make_model,
    native,
    save_serving_bundle,
)
from mlsp_tpu_torch.models import model_kwargs
from mlsp_tpu_torch.data import pipeline as pipeline_mod
from mlsp_tpu_torch.data.pipeline import standardize_clouds, standardize_files
from mlsp_tpu_torch.data.pointda import load_pointda
from mlsp_tpu_torch.data.pointsegda import load_pointsegda
from mlsp_tpu_torch.data.synthetic import (
    make_classification,
    make_segmentation,
)
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.edge import edge_moments, edge_moments_torch
from mlsp_tpu_torch.ops.fps import fps_torch
from mlsp_tpu_torch.ops.kernels import (
    _build,
    edge_moments_bwd_cuda,
    edge_moments_cuda,
    fps_cuda,
    knn_cuda,
    knn_moments_cuda,
)
from mlsp_tpu_torch.ops.knn import (
    edge_features,
    knn_gather,
    knn_indices,
    knn_indices_torch,
)
from mlsp_tpu_torch.ops.normals import estimate_normals, knn_moments_torch
from mlsp_tpu_torch.testing import (
    Tape,
    edge_grad_magnitude,
    grad_gaps,
    knn_set_gap,
    merge_rank_tapes,
    run_ranks,
    step_case,
    step_cases,
)
from mlsp_tpu_torch.train import (
    make_optimizer,
    pointda_train_step,
    pointsegda_train_step,
)
from mlsp_tpu_torch.train.pointda_trainer import (
    eval_batches,
    eval_logits,
    evaluate,
)
from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
from mlsp_tpu_torch.train.spst import select_pseudo_labels
from mlsp_tpu_torch.train.state import torch_cosine_lr
from mlsp_tpu_torch.transforms.scan import draw_scan, scan_batch
from mlsp_tpu_torch.utils import checkpoint, chipcal
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    load_yaml,
)
from mlsp_tpu_torch.utils.logging import IOStream

_knn_mod = importlib.import_module("mlsp_tpu_torch.ops.knn")
_fps_mod = importlib.import_module("mlsp_tpu_torch.ops.fps")
SEED = 0
B, N, K, NUM_CLASS = 32, 1024, 20, 10  # utils/config.py PointDAConfig
REQUESTS = (32, 32, 32, 32, 7)
RAGGED_N = 1000  # not a multiple of the kernel's 64-query or 32-point tiles
# H100 SXM peaks at the full 700 W (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Serving agreement with the plain path: the near-tie allowance of the JAX
# package's AOT self-check (mlsp_tpu/train/evaluation.py).
MAX_LOGIT_DIFF = 2e-2
MIN_CLASS_AGREEMENT = 0.99
# npoint = N; (2B, N) is PCM's one launch for both of its batches
FPS_SHAPES = ((2 * B, N), (B, RAGGED_N), (B, 2048))
# The data pipeline's FPS calls: chunks of up to 64 clouds, tiled to a
# power-of-two bucket, reduced to N points; K4's limit is 16384 points.
FPS_PIPELINE_SHAPES = ((64, 4096), (64, 8192), (16, 16384))
FPS_LIMIT = 16384
DATA_CLOUDS = 96
# The trainer phase: epochs, and the launches of a run of E epochs on the
# synthetic data (8 steps an epoch; 2 + 2 validation batches an epoch, 3
# final-test batches): per step K1 10, K2-fwd 8, K2-bwd 8, K3 1, K4 1; per
# eval forward K1 5, K2-fwd 4.
TRAINER_EPOCHS = 2
EVAL_FORWARDS = 3  # 80 target test clouds at B=32, the last batch padded


def trainer_launches(epochs: int) -> dict:
    return {"knn": 100 * epochs + 15, "edge_moments": 80 * epochs + 12,
            "edge_moments_bwd": 64 * epochs, "knn_moments": 8 * epochs,
            "fps": 8 * epochs}
# (B, N, C, k) of the integer-coordinate exact-order checks; C = 3 with
# coordinates in [-2, 2] puts many points at equal distances
EXACT_KNN = ((B, N, 3, K), (4, RAGGED_N, 64, 32), (4, N, 128, 1),
             (2, 2048, 256, 16))
# rows_same_indices of K1 against the plain version on the serving inputs,
# from the call before the K1 redesign (NVIDIA H100 80GB HBM3, 700.00 W):
# the redesign keeps the distances bit for bit, so these should repeat
ROWS_SAME_INDICES_BEFORE = {
    "cloud": 0.99981689453125, "conv1": 0.999786376953125,
    "conv2": 0.9990234375, "conv3": 0.99859619140625,
    "conv4": 0.99688720703125, "ragged": 0.9998750686645508}
TRAIN_STEPS = 3
QUEUE_CYCLES = 100_000_000  # the sleep timed launches queue behind (~60 ms)
STEPS_PER_EPOCH = 100  # the schedule's epoch length; 3 steps stay in epoch 0
PER_STEP = {"knn": 10, "edge_moments": 8, "edge_moments_bwd": 8,
            "knn_moments": 1, "fps": 1}
# First train step, kernel route against plain route (both on the card),
# with train-mode BN and again with eval-mode BN. The plain run replays
# the kernel run's kNN graphs and FPS orders (`testing.Tape`), so only
# rounding separates the routes: a near tie that rounding flips would
# change a point's features outright, and train-mode BN would carry that
# to every point. Each loss term within LOSS_RTOL relative, each gradient
# tensor within GRAD_RTOL (`testing.grad_gaps`). With eval-mode BN the
# routes differ only in K3's covariance form and K2-bwd's addition order
# (max 1.4e-5 on an H100, 700 W). With train-mode BN the kernel's sums
# round the BN statistics differently, and that flips a few ReLU,
# max-pool and Chamfer kinks, each moving one element's share of a
# gradient: max 5.0e-3, median 6.6e-4 there, so train mode is held at
# GRAD_RTOL_TRAIN per tensor and GRAD_MEDIAN_TRAIN over the tensors (a
# fault in a kernel's sums would move every tensor). The kernel route must
# repeat itself on identical inputs within REPEAT_RTOL (its atomics add in
# another order each run: max 2e-6). Its change under inputs moved by
# ±PERTURB, which flips FPS and kNN choices, is printed and not checked.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_RTOL_TRAIN, GRAD_MEDIAN_TRAIN = 2e-2, 2e-3
# 2 gloo ranks against one process with eval-mode BN (`ddp_ingest`): the
# ranks' weight gradients sum 16 rows each, the process's 32, in other
# orders, and these sums cancel heavily in the early layers (rounding
# reached 3.0e-4 at conv1, median 1.7e-6, on an NVIDIA H100 80GB HBM3 at
# 700.00 W; the step's own change under a 1e-6 input shift reaches 2.4e-2
# there)
DDP_GRAD_RTOL, DDP_GRAD_MEDIAN = 1e-3, 1e-5
# Their running statistics after the step (relative L2, plus each one's
# shift floor in train mode): the momentum update carries the BN
# statistics' rounding, ~1e-7 of a buffer.
DDP_RUNNING_RTOL = 1e-4
REPEAT_RTOL = 1e-4
PERTURB = 1e-6
GRAPHS_PER_STEP, ORDERS_PER_STEP = 11, 1  # 2 forwards x 5 kNN + K3; PCM


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


def knn_cost(x: torch.Tensor, k: int = K) -> tuple[float, float]:
    """Per pair of points: 2C for the dot product, 4 to form, clamp and
    compare the distance; x read once, the indices written once."""
    b, n, c = x.shape
    return b * n * n * (2 * c + 4), b * n * c * 4 + b * n * k * 8


def edge_cost(u: torch.Tensor, idx: torch.Tensor,
              moments: bool = False) -> tuple[float, float]:
    """Eval form (max and min): 2 compares per gathered value; train form
    (with the sum and sum of squares): 5. u and idx read once, the 2 or 4
    outputs written once."""
    b, n, c = u.shape
    outs = 4 if moments else 2
    return (b * n * K * c * (5 if moments else 2),
            b * n * c * 4 + idx.numel() * 8 + outs * b * n * c * 4)


def randomise_batch_norm(model: torch.nn.Module, g: torch.Generator) -> None:
    """gamma of both signs (EdgeConvM takes the min where gamma < 0), beta
    and running statistics away from their init values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                sign = torch.randint(0, 2, (c,), generator=g) * 2.0 - 1.0
                m.weight.copy_(sign * (0.5 + torch.rand(c, generator=g)))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def kernel_inputs(model, x: torch.Tensor):
    """The inputs the serving forward gives each kernel, as DGCNN.forward
    and EdgeConvM.forward compute them: five kNN graphs (raw cloud, then
    each EdgeConv layer's input) and four (xg, u) pairs."""
    with torch.no_grad():
        idx = knn_indices(x, K)
        T = model.input_transform_net(edge_features(x, idx))
        feats = [torch.einsum("bnc,bdc->bnd", x, T)]
        for conv in (model.conv1, model.conv2, model.conv3):
            feats.append(conv(feats[-1]))
        knn_in = [("cloud", x)] + [(f"conv{i + 1}", f)
                                   for i, f in enumerate(feats)]
        edge_in = []
        for i, (conv, f) in enumerate(zip(
                (model.conv1, model.conv2, model.conv3, model.conv4), feats)):
            w = conv.conv[0].weight.flatten(1)
            edge_in.append((f"conv{i + 1}", f, F.linear(f, w[:, :f.shape[-1]])))
    return knn_in, edge_in


def check_knn(name: str, x: torch.Tensor, phase: str = "knn") -> dict:
    """Pass: in every row the two neighbour sets' sorted float64 distances
    agree within the float32 rounding bound of the distance formula
    (`testing.knn_set_gap`); both pick among near ties only."""
    got = knn_cuda(x, K)
    want = knn_indices_torch(x, K)
    torch.cuda.synchronize()
    gap, tol = knn_set_gap(x, got, want)
    res = {"input": name, "shape": list(x.shape),
           "rows": gap.numel(),
           "rows_same_indices": float((got == want).all(-1).float().mean()),
           "rows_same_indices_before": ROWS_SAME_INDICES_BEFORE.get(name),
           "rows_same_set": float((gap == 0).float().mean()),
           "max_dist_gap": float(gap.max()),
           "max_gap_over_tol": float((gap / tol).max())}
    emit(phase, kernel="knn", **res)
    check(bool((gap <= tol).all()), f"knn kernel disagrees on {name}: {res}")
    return res


def repeated_point(b: int, n: int, device) -> torch.Tensor:
    """A cloud of one repeated point: every distance is 0, so every row's
    neighbours are the k lowest indices, each a neighbour of all n rows."""
    return torch.full((b, n, 3), 0.5, device=device)


def integer_cloud(g: torch.Generator, shape, device) -> torch.Tensor:
    """Coordinates in {-2, ..., 2}: every distance of the kNN formula is an
    exact float32 integer whatever the order of its sums, so two correct
    programs must give the same indices, tie order included."""
    return torch.randint(-2, 3, shape, generator=g).float().to(device)


def check_knn_exact(g: torch.Generator, device) -> None:
    """Pass: on integer coordinates (EXACT_KNN) and on a cloud of one
    repeated point (every distance 0), K1's indices equal the plain
    version's, and so do K3's where C = 3."""
    cases = [(f"integer B={b} N={n} C={c} k={k}",
              integer_cloud(g, (b, n, c), device), k)
             for b, n, c, k in EXACT_KNN]
    cases.append(("one repeated point", repeated_point(2, N, device), K))
    for name, x, k in cases:
        want = knn_indices_torch(x, k)
        got = knn_cuda(x, k)
        torch.cuda.synchronize()
        res = {"input": name, "shape": list(x.shape), "k": k,
               "exact": True, "rows_unequal": int((got != want).any(-1).sum())}
        emit("knn", **res)
        check(res["rows_unequal"] == 0,
              f"knn kernel indices differ on exact distances: {res}")
        if x.shape[-1] == 3:
            idx = knn_moments_cuda(x, k, return_indices=True)[2]
            torch.cuda.synchronize()
            res = {"input": name, "shape": list(x.shape), "k": k,
                   "exact": True,
                   "rows_unequal": int((idx != want).any(-1).sum())}
            emit("knn_moments", **res)
            check(res["rows_unequal"] == 0,
                  f"K3 indices differ on exact distances: {res}")


def check_edge(name: str, xg: torch.Tensor, u: torch.Tensor) -> dict:
    """Pass: max and min bit-equal; sums within 1e-5 of the sum of the
    terms' magnitudes (sum of |u_j| for s1, s2 itself for s2)."""
    idx = knn_cuda(xg, K)
    res = {"input": name, "shape": list(u.shape)}
    err = 0.0
    for want_moments in (False, True):
        got = edge_moments_cuda(u, idx, want_moments)
        want = edge_moments_torch(u, idx, want_moments)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"edge kernel max/min not bit-equal on {name}")
        if want_moments:
            scale = (edge_moments_torch(u.abs(), idx, True)[2], want[3])
            for label, g, w, s in zip(("s1", "s2"), got[2:], want[2:], scale):
                diff = (g - w).abs()
                res[f"{label}_max_abs_err"] = float(diff.max())
                res[f"{label}_max_err_over_tol"] = float(
                    (diff / (1e-5 * s + 1e-30)).max())
                err = max(err, float(diff.max()))
                check(bool((diff <= 1e-5 * s).all()),
                      f"edge kernel {label} outside tolerance on {name}")
    emit("edge", **res)
    return {**res, "max_abs_err": err}


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


def edge_bwd_cost(u: torch.Tensor, k: int) -> tuple[float, float]:
    """Per edge and channel 2 compares and about 6 operations to form and
    add the contribution; u, mx, mn and the four cotangents read once, idx
    once, du written once."""
    b, n, c = u.shape
    return 8.0 * b * n * k * c, 8 * b * n * c * 4 + b * n * k * 8


def check_fps(x: torch.Tensor, start: torch.Tensor, npoint: int = 0,
              what: str = "random", phase: str = "fps") -> dict:
    """Pass: the kernel's indices equal the plain version's (npoint = N
    unless given)."""
    npoint = npoint or x.shape[1]
    got = fps_cuda(x, npoint, start)
    want = fps_torch(x, npoint, start)
    torch.cuda.synchronize()
    res = {"input": what, "shape": list(x.shape), "npoint": npoint,
           "unequal_indices": int((got != want).sum()),
           "first_column_is_start": bool(torch.equal(got[:, 0], start))}
    emit(phase, kernel="fps", **res)
    check(res["unequal_indices"] == 0 and res["first_column_is_start"],
          f"fps kernel disagrees with its plain version: {res}")
    return res


def check_knn_moments(x: torch.Tensor, k: int = K,
                      phase: str = "knn_moments") -> dict:
    """Pass: (1) the kernel's neighbour sets pass K1's distance-set check
    against the plain graph; (2) s1 and s2 are within 1e-5 of the summed
    magnitudes of their terms against sums over the kernel's own
    neighbours; (3) the normals of the two routes agree at |cos| > 0.999
    on at least 99% of the points."""
    s1, s2, idx = knn_moments_cuda(x, k, return_indices=True)
    gap, tol = knn_set_gap(x, idx, knn_indices_torch(x, k))
    g = knn_gather(x, idx)
    outer = g[..., :, None] * g[..., None, :]
    w1, w2 = g.sum(-2), outer.sum(-3).flatten(-2)
    e1, e2 = (s1 - w1).abs(), (s2 - w2).abs()
    m1, m2 = g.abs().sum(-2), outer.abs().sum(-3).flatten(-2)
    cos = (estimate_normals(x, k) * estimate_normals(x, k, backend="torch")
           ).sum(-1).abs()
    res = {"shape": list(x.shape), "k": k,
           "rows_same_set": float((gap == 0).float().mean()),
           "max_gap_over_tol": float((gap / tol).max()),
           "s1_max_abs_err": float(e1.max()), "s2_max_abs_err": float(e2.max()),
           "s_max_err_over_tol": max(float((e1 / (1e-5 * m1 + 1e-30)).max()),
                                     float((e2 / (1e-5 * m2 + 1e-30)).max())),
           "normals_share_cos_above_0.999": float((cos > 0.999).float().mean())}
    emit(phase, kernel="knn_moments", **res)
    check(bool((gap <= tol).all()), f"K3 neighbour sets disagree: {res}")
    check(res["s_max_err_over_tol"] <= 1.0, f"K3 sums outside tolerance: {res}")
    check(res["normals_share_cos_above_0.999"] >= 0.99,
          f"K3 normals disagree with the plain route: {res}")
    return {**res, "max_abs_err": max(res["s1_max_abs_err"],
                                      res["s2_max_abs_err"])}


def check_edge_bwd(name: str, xg: torch.Tensor, u: torch.Tensor,
                   g: torch.Generator) -> dict:
    """Pass: du from K2-bwd (through the autograd function) within 1e-5 of
    the summed magnitudes of its terms of autograd's du through the plain
    version, on the same graph and random cotangents. The atomics add in
    a varying order, so du agrees only to rounding."""
    idx = knn_cuda(xg, K)
    cots = [torch.randn(u.shape, generator=g).to(u.device) for _ in range(4)]

    def grad(fn):
        uu = u.detach().clone().requires_grad_()
        loss = sum((c * o).sum() for c, o in zip(cots, fn(uu)))
        return torch.autograd.grad(loss, uu)[0]

    got = grad(lambda uu: edge_moments(xg, uu, K, True))
    want = grad(lambda uu: edge_moments_torch(uu, idx, True))
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * edge_grad_magnitude(u, idx, cots)
    res = {"input": name, "shape": list(u.shape),
           "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / (tol + 1e-30)).max())}
    emit("edge_bwd", **res)
    check(bool((err <= tol).all()), f"K2-bwd outside tolerance on {name}: {res}")
    return res


def train_cfg() -> PointDAConfig:
    return PointDAConfig().paper_recipe


def train_batches(cfg: PointDAConfig, device) -> list:
    """Synthetic (src_x, src_y, trgt_x) batches, one per step."""
    clouds, labels = make_classification(2 * cfg.batch_size * TRAIN_STEPS,
                                         cfg.num_points, cfg.num_class,
                                         seed=SEED + 3)
    x = torch.from_numpy(clouds).to(device).split(cfg.batch_size)
    y = torch.from_numpy(labels).to(device).split(cfg.batch_size)
    return [(x[2 * i], y[2 * i], x[2 * i + 1]) for i in range(TRAIN_STEPS)]


def train_model(cfg: PointDAConfig, device, knn_backend: str = "auto"):
    g = torch.Generator().manual_seed(SEED + 4)
    model = make_model("dgcnn", cfg.num_class, device=device, generator=g,
                       k=K, dropout=cfg.dropout,
                       density_num_cls=cfg.density_num_class,
                       pergroup=cfg.pergroup, head_dtype=cfg.head_dtype,
                       knn_backend=knn_backend)
    randomise_batch_norm(model, g)
    return model.train()


def first_step(model, cfg, batch, device, delta: float = 0.0):
    """One step from `model`'s weights with a fresh optimizer and the
    step generator's seed; returns (losses as floats, gradients)."""
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                STEPS_PER_EPOCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    src_x, src_y, trgt_x = batch
    m = pointda_train_step(model, opt, sched, src_x + delta, src_y,
                           trgt_x + delta, gen, cfg)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in m.items()}, grads


def train(device) -> dict:
    """The train main path, then its first step through the plain route."""
    cfg = train_cfg()
    batches = train_batches(cfg, device)
    model = train_model(cfg, device)
    init = copy.deepcopy(model.state_dict())
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                STEPS_PER_EPOCH)
    gen = torch.Generator(device=device).manual_seed(SEED)

    kernels.reset_launches()
    steps = [pointda_train_step(model, opt, sched, *b, gen, cfg)
             for b in batches]
    torch.cuda.synchronize()
    launches = kernels.launches()
    losses = [{k: float(v) for k, v in m.items()} for m in steps]
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cmp_train = compare_first_step(cfg, batches[0], init, device)
    cmp_eval = compare_first_step(dataclasses.replace(cfg, debug_bn_eval=True),
                                  batches[0], init, device)
    res = {"config": "PointDAConfig().paper_recipe", "batch": cfg.batch_size,
           "points": cfg.num_points, "k": K, "steps": TRAIN_STEPS,
           "launches": launches,
           "launches_expected": {k: TRAIN_STEPS * v for k, v in PER_STEP.items()},
           "losses": losses, "finite": finite, "peak_memory_gb": peak_gb,
           "first_step_plain_vs_kernel": cmp_train,
           "first_step_plain_vs_kernel_eval_bn": cmp_eval}
    emit("train", **res)
    check(finite, f"non-finite train losses: {losses}")
    check(launches == res["launches_expected"],
          f"the train path did not launch every kernel as expected: {launches}")
    for name, c in (("train-mode BN", cmp_train), ("eval-mode BN", cmp_eval)):
        check(not any(c["plain_route_launches"].values()),
              f"the plain route launched kernels: {c['plain_route_launches']}")
        r = c["replayed"]
        check((r["graphs"], r["fps_orders"])
              == (GRAPHS_PER_STEP, ORDERS_PER_STEP)
              and r["plain_own_fps_entries_differ"] == 0,
              f"first step ({name}): unexpected kNN graphs or FPS orders {r}")
        check(c["same_grad_set"] and not c["outside"],
              f"first step ({name}): plain route or kernel rerun disagrees "
              f"with the kernel route on {c['outside']}")
    return {**res, "cfg": cfg, "batches": batches, "model": model, "opt": opt,
            "sched": sched, "gen": gen, "init": init}


def compare_first_step(cfg, batch, init, device) -> dict:
    """The first step from the initial weights and generator seed through
    the kernels, then through the plain versions on the kernel run's kNN
    graphs and FPS orders (see LOSS_RTOL)."""
    def rerun(backend, delta=0.0):
        m = train_model(cfg, device, backend)
        m.load_state_dict(init)
        return first_step(m, dataclasses.replace(cfg, knn_backend=backend),
                          batch, device, delta)

    return compare_routes(rerun, not cfg.debug_bn_eval)


def compare_routes(rerun, train_bn: bool) -> dict:
    """`rerun(backend, delta)` -> (losses, gradients) of one step from fixed
    weights and seed: through the kernels, then through the plain versions
    on the kernel run's kNN graphs and FPS orders (see LOSS_RTOL)."""
    tape = Tape()
    with tape.record():
        k_loss, k_grad = rerun("auto")
    repeats = [rerun("auto") for _ in range(2)]
    shifted = [rerun("auto", d) for d in (PERTURB, -PERTURB)]
    kernels.reset_launches()
    with tape.replay():
        p_loss, p_grad = rerun("torch")
    torch.cuda.synchronize()
    plain_launches = kernels.launches()

    def loss_gaps(runs):
        return {n: max(abs(r[n] - w) for r in runs) / max(abs(w), 1e-12)
                for n, w in k_loss.items()}

    def grad_gap(runs):
        per_run = [grad_gaps(g, k_grad) for g in runs]
        return {n: max(r[n] for r in per_run) for n in k_grad}

    def summary(gaps):
        worst = max(gaps, key=gaps.get)
        return {"median": statistics.median(gaps.values()),
                "max": gaps[worst], "worst": worst}

    loss = {"plain": loss_gaps([p_loss]),
            "repeat": loss_gaps([r for r, _ in repeats]),
            "shifted": loss_gaps([r for r, _ in shifted])}
    grad = {"plain": grad_gap([p_grad]),
            "repeat": grad_gap([g for _, g in repeats]),
            "shifted": grad_gap([g for _, g in shifted])}
    bad = [f"{n} ({what})" for what in ("plain", "repeat")
           for n, v in loss[what].items() if v > LOSS_RTOL]
    bad += [f"{n} (plain)" for n, v in grad["plain"].items()
            if v > (GRAD_RTOL_TRAIN if train_bn else GRAD_RTOL)]
    if train_bn and statistics.median(grad["plain"].values()) > \
            GRAD_MEDIAN_TRAIN:
        bad.append("median over the gradient tensors (plain)")
    bad += [f"{n} (repeat)" for n, v in grad["repeat"].items()
            if v > REPEAT_RTOL]
    return {"bn": "train" if train_bn else "eval",
            "losses": {n: {"kernel": w, "plain": p_loss[n],
                           **{f"rel_gap_{what}": loss[what][n]
                              for what in loss}}
                       for n, w in k_loss.items()},
            "grad_gap_plain": summary(grad["plain"]),
            "grad_gap_repeat": summary(grad["repeat"]),
            "grad_gap_shifted_not_checked": summary(grad["shifted"]),
            "tensors": len(k_grad),
            "replayed": {"graphs": len(tape.graphs),
                         "fps_orders": len(tape.orders),
                         "plain_own_graph_rows_differ":
                             tape.own_graph_rows_differ,
                         "plain_own_fps_entries_differ":
                             tape.own_order_entries_differ},
            "plain_route_launches": plain_launches,
            "same_grad_set": set(p_grad) == set(k_grad), "outside": bad}


def step_times(tr: dict, device, card: str) -> dict:
    """Train step p50 (host clock around a step that ends in a
    synchronize), kernel route after the main path's steps and plain route
    from the initial weights."""
    cfg, batches = tr["cfg"], tr["batches"]

    def p50(model, opt, sched, gen, c, n, warm):
        out = []
        for i in range(warm + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pointda_train_step(model, opt, sched, *batches[i % len(batches)],
                               gen, c)
            torch.cuda.synchronize()
            if i >= warm:
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), len(out)

    ms, n = p50(tr["model"], tr["opt"], tr["sched"], tr["gen"], cfg, 12, 2)
    plain = train_model(cfg, device, "torch")
    plain.load_state_dict(tr["init"])
    popt, psched = make_optimizer(plain, cfg.lr, cfg.wd, cfg.epochs,
                                  STEPS_PER_EPOCH)
    pcfg = dataclasses.replace(cfg, knn_backend="torch")
    pms, pn = p50(plain, popt, psched,
                  torch.Generator(device=device).manual_seed(SEED), pcfg, 4, 1)
    res = {"batch": cfg.batch_size, "steps_timed": n, "p50_ms": ms,
           "clouds_per_s": cfg.batch_size / (ms / 1e3),
           "plain_steps_timed": pn, "plain_p50_ms": pms,
           "plain_clouds_per_s": cfg.batch_size / (pms / 1e3),
           "launches_per_step": PER_STEP, "card": card}
    emit("times", what="train_step", **res)
    return res


def serve(model, bundle_dir: str, device) -> dict:
    """The main path: ServingModel answers REQUESTS on the card."""
    clouds, _ = make_classification(sum(REQUESTS), N, NUM_CLASS, seed=SEED)
    requests = np.split(clouds, np.cumsum(REQUESTS)[:-1])
    save_serving_bundle(model, bundle_dir, num_points=N, num_class=NUM_CLASS)
    served = ServingModel(bundle_dir, device=device)

    kernels.reset_launches()
    answers = [served.predict(r) for r in requests]
    launches = kernels.launches()

    plain = make_model("dgcnn", NUM_CLASS, device=device, knn_backend="torch",
                       **model.config)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = [plain(torch.from_numpy(r).to(device))["cls"].cpu().numpy()
                for r in requests]
    got, want = np.concatenate(answers), np.concatenate(want)
    res = {"requests": [len(r) for r in requests], "clouds": len(got),
           "launches": launches,
           "launches_expected": {**dict.fromkeys(PER_STEP, 0),
                                 "knn": 5 * len(requests),
                                 "edge_moments": 4 * len(requests)},
           "finite": bool(np.isfinite(got).all()),
           "class_agreement": float((got.argmax(-1) == want.argmax(-1)).mean()),
           "max_logit_diff": float(np.abs(got - want).max())}
    emit("serve", **res)
    check(got.shape == (sum(REQUESTS), NUM_CLASS) and res["finite"],
          "serving answers are not finite logits of the expected shape")
    check(launches == res["launches_expected"],
          f"the main path did not launch every kernel: {launches}")
    check(res["class_agreement"] >= MIN_CLASS_AGREEMENT
          and res["max_logit_diff"] <= MAX_LOGIT_DIFF,
          f"serving disagrees with the plain path: {res}")
    return {"served": served, "plain": plain, **res}


def serving_times(served, plain, device, card: str) -> None:
    x = make_classification(B, N, NUM_CLASS, seed=SEED + 1)[0]

    def latencies(predict, n):
        for _ in range(3):
            predict()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            predict()  # returns host numpy logits: the device has finished
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    lat = latencies(lambda: served.predict(x), 50)

    def plain_predict():
        with torch.no_grad():
            plain(torch.from_numpy(x).to(device))["cls"].cpu()

    plain_lat = latencies(plain_predict, 20)
    res = {"batch": B, "samples": len(lat),
           "p50_ms": statistics.median(lat), "max_ms": max(lat),
           "clouds_per_s": B * len(lat) / (sum(lat) / 1e3),
           "plain_p50_ms": statistics.median(plain_lat), "card": card}
    emit("times", what="serving", **res)


def kernel_times(device, card, knn_in, edge_in, g) -> dict:
    """Per-launch medians beside bound and plain time, by kernel."""
    rows = {name: [] for name in (*PER_STEP, "edge_moments_train",
                                  "edge_moments_bwd_repeated_point",
                                  "fps_pipeline")}

    def row(kname, what, shape, fn, plain_fn, cost, plain_reps=30):
        b_ms, b_by = bound(*cost)
        r = {"input": what, "shape": list(shape), "ms": median_ms(fn),
             "plain_ms": median_ms(plain_fn, reps=plain_reps,
                                   warmup=min(plain_reps, 5)),
             "bound_ms": b_ms, "bound_by": b_by}
        rows[kname].append(r)
        return r

    for name, t in knn_in:
        row("knn", name, t.shape, lambda: knn_cuda(t, K),
            lambda: knn_indices_torch(t, K), knn_cost(t))
    for name, xg, u in edge_in:
        idx = knn_cuda(xg, K)
        row("edge_moments", name, u.shape,
            lambda: edge_moments_cuda(u, idx, False),
            lambda: edge_moments_torch(u, idx, False), edge_cost(u, idx))

    # K2-fwd as training calls it (max, min, sum, sum of squares)
    for name, xg, u in edge_in:
        idx = knn_cuda(xg, K)
        row("edge_moments_train", name, u.shape,
            lambda: edge_moments_cuda(u, idx, True),
            lambda: edge_moments_torch(u, idx, True), edge_cost(u, idx, True))

    # K2-bwd at the train shapes: the kernel alone against autograd's
    # backward through the plain version (the same graph and cotangents).
    for name, xg, u in edge_in:
        idx = knn_cuda(xg, K)
        outs = edge_moments_cuda(u, idx, True)
        cots = [torch.randn(u.shape, generator=g).to(device) for _ in range(4)]
        uu = u.detach().clone().requires_grad_()
        plain_outs = edge_moments_torch(uu, idx, True)
        row("edge_moments_bwd", name, u.shape,
            lambda: edge_moments_bwd_cuda(u, idx, outs[0], outs[1], *cots),
            lambda: torch.autograd.grad(plain_outs, uu, cots,
                                        retain_graph=True),
            edge_bwd_cost(u, K))

    # K2-bwd's worst case: a cloud of one repeated point, every row's
    # neighbours the k lowest indices (in-degree N), at conv1's shape
    u = edge_in[0][2]
    idx = knn_cuda(repeated_point(u.shape[0], u.shape[1], device), K)
    outs = edge_moments_cuda(u, idx, True)
    cots = [torch.randn(u.shape, generator=g).to(device) for _ in range(4)]
    uu = u.detach().clone().requires_grad_()
    plain_outs = edge_moments_torch(uu, idx, True)
    row("edge_moments_bwd_repeated_point", "conv1, one repeated point",
        u.shape, lambda: edge_moments_bwd_cuda(u, idx, outs[0], outs[1], *cots),
        lambda: torch.autograd.grad(plain_outs, uu, cots, retain_graph=True),
        edge_bwd_cost(u, K))

    x = torch.from_numpy(make_classification(B, N, NUM_CLASS, seed=SEED + 5)[0]
                         ).to(device)
    row("knn_moments", "target clouds", x.shape,
        lambda: knn_moments_cuda(x, K), lambda: knn_moments_torch(x, K),
        knn_moments_cost(B, N))

    fps_chain = {}
    for b, n in FPS_SHAPES:
        xf = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                  seed=SEED + n)[0]).to(device)
        start = torch.randint(0, n, (b,), generator=g).to(device)
        row("fps", f"B={b} N={n}", xf.shape, lambda: fps_cuda(xf, n, start),
            lambda: fps_torch(xf, n, start), fps_cost(b, n), plain_reps=3)
        # The chain: one cloud alone, npoint = n against npoint = 2, gives
        # this design's time per dependent step; n of them is its floor.
        one, s1 = xf[:1].contiguous(), start[:1].contiguous()
        step = ((median_ms(lambda: fps_cuda(one, n, s1))
                 - median_ms(lambda: fps_cuda(one, 2, s1))) / (n - 2))
        fps_chain[f"N={n}"] = {"us_per_step_one_block": step * 1e3,
                               "chain_floor_ms": step * n}
    # the data pipeline's buckets, npoint = N
    for b, n in FPS_PIPELINE_SHAPES:
        xf = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                  seed=SEED + n)[0]).to(device)
        start = torch.randint(0, n, (b,), generator=g).to(device)
        row("fps_pipeline", f"B={b} N={n} npoint={N}", xf.shape,
            lambda: fps_cuda(xf, N, start), lambda: fps_torch(xf, N, start),
            fps_cost(b, n, N), plain_reps=3)
        one, s1 = xf[:1].contiguous(), start[:1].contiguous()
        step = ((median_ms(lambda: fps_cuda(one, N, s1))
                 - median_ms(lambda: fps_cuda(one, 2, s1))) / (N - 2))
        fps_chain[f"N={n} npoint={N}"] = {"us_per_step_one_block": step * 1e3,
                                          "chain_floor_ms": step * N}
    for kname, per_shape in rows.items():
        emit("times", what=kname, per_launch=per_shape, card=card,
             **({"chain": fps_chain} if kname.startswith("fps") else {}))
    return {"rows": rows, "fps_chain": fps_chain}


def check_fps_pipeline(g: torch.Generator, device) -> list:
    """K4 at the data pipeline's shapes (npoint = N), then one point over
    its limit, which must raise."""
    res = []
    for b, n in FPS_PIPELINE_SHAPES:
        xf = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                  seed=SEED + n)[0]).to(device)
        start = torch.randint(0, n, (b,), generator=g).to(device)
        res.append(check_fps(xf, start, N, what="pipeline bucket"))
    try:
        fps_cuda(torch.zeros(1, FPS_LIMIT + 1, 3, device=device), N,
                 torch.zeros(1, dtype=torch.int64, device=device))
        raised = ""
    except ValueError as e:
        raised = str(e)
    emit("fps", input=f"N = {FPS_LIMIT + 1}, one over the limit",
         raised=raised)
    check(str(FPS_LIMIT) in raised,
          f"K4 took a cloud over its limit of {FPS_LIMIT} points")
    return res


def data(device) -> dict:
    """The pipeline's FPS route on the card: K4 against the plain loop."""
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(N + 1, FPS_LIMIT + 1, DATA_CLOUDS)
    clouds = [make_classification(1, int(n), NUM_CLASS, seed=SEED + i)[0][0]
              * rng.uniform(0.5, 2.0) for i, n in enumerate(sizes)]
    buckets: dict[int, int] = {}
    for n in sizes:
        b = 1 << (int(n) - 1).bit_length()
        buckets[b] = buckets.get(b, 0) + 1
    kw = dict(rotate_axis="x", rotate_angle=-np.pi / 2, device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = standardize_clouds(clouds, N, **kw)
    seconds = time.perf_counter() - t0
    launches = kernels.launches()
    t0 = time.perf_counter()
    want = standardize_clouds(clouds, N, backend="torch", **kw)
    plain_seconds = time.perf_counter() - t0
    expected = {**dict.fromkeys(PER_STEP, 0),
                "fps": sum(-(-c // 64) for c in buckets.values())}
    res = {"clouds": DATA_CLOUDS, "sizes": [int(sizes.min()), int(sizes.max())],
           "buckets": {str(k): v for k, v in sorted(buckets.items())},
           "launches": launches, "launches_expected": expected,
           "shape": list(got.shape), "bitwise_equal": bool(
               np.array_equal(got, want)),
           "seconds": seconds, "plain_seconds": plain_seconds}
    emit("data", **res)
    check(res["bitwise_equal"] and got.shape == (DATA_CLOUDS, N, 3),
          "the pipeline's K4 route differs from its plain route")
    check(launches == expected, f"the pipeline launched {launches}")
    return res


def run_cli(argv: list, log: str) -> dict:
    """`cli.main(argv)` in this process, its prints into `log`; returns
    the launches it made. Fails unless it returns 0."""
    kernels.reset_launches()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli {argv[0]} returned {rc} (see {log})")
    return kernels.launches()


def busy_share(trace: str, span: str) -> dict:
    """The device's busy share inside the host range `span` of a
    torch.profiler Chrome trace: the union of the GPU kernel, copy and set
    intervals over the range's length."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == span
              and e.get("cat") == "user_annotation"]
    if not ranges:
        return {"busy_share": None, "why": f"no range {span!r} in the trace"}
    t0 = ranges[0]["ts"]
    t1 = t0 + ranges[0]["dur"]
    busy, end, kernels_seen = 0.0, t0, 0
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset")):
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
            kernels_seen += 1
    return {"busy_share": busy / (t1 - t0) if kernels_seen else None,
            "range_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "device_events": kernels_seen}


def trainer(tmp: str) -> dict:
    """The trainer CLI at full width, then a resume of it."""
    out = os.path.join(tmp, "runs")
    exp = os.path.join(out, "smoke")
    argv = ["trainer", "--paper_recipe", "True", "--synthetic", "True",
            "--epochs", str(TRAINER_EPOCHS), "--save_every", "1",
            "--out_path", out, "--exp_name", "smoke"]
    t0 = time.perf_counter()
    launches = run_cli(argv, os.path.join(tmp, "trainer.log"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        log = f.read()
    losses = [r["train"] for r in records]
    files = {f: os.path.exists(os.path.join(exp, f))
             for f in ("model.ckpt", "last.ckpt", "run.log", "metrics.jsonl")}
    prints = {p: p in log for p in ("Best validation model confusion matrix:",
                                    "Test confusion matrix:",
                                    "target test accuracy:")}
    res = {"argv": argv, "epochs": TRAINER_EPOCHS, "seconds": seconds,
           "launches": launches,
           "launches_expected": trainer_launches(TRAINER_EPOCHS),
           "losses": losses, "finite": all(np.isfinite(v) for r in losses
                                           for v in r.values()),
           "files": files, "records": len(records), "log_prints": prints,
           "epoch_seconds": [r["seconds"] for r in records],
           "val": [{k: r[k]["acc"] for k in ("src_val", "trgt_val")}
                   for r in records]}
    emit("trainer", **res)
    check(res["finite"], f"non-finite trainer losses: {losses}")
    check(launches == res["launches_expected"],
          f"the trainer did not launch every kernel as expected: {launches}")
    check(all(files.values()) and res["records"] == TRAINER_EPOCHS
          and all(prints.values()),
          f"the trainer left {files}, {res['records']} records, {prints}")

    # resume from the last epoch's checkpoint, profiled
    last = os.path.join(exp, "last.ckpt")
    trace_dir = os.path.join(tmp, "trace")
    resume = ["trainer", "--paper_recipe", "True", "--synthetic", "True",
              "--epochs", str(TRAINER_EPOCHS + 1), "--resume", last,
              "--save_every", "1", "--out_path", out, "--exp_name",
              "smoke", "--profile_dir", trace_dir]
    run_cli(resume, os.path.join(tmp, "resume.log"))
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        after = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        said = f"resumed from {last} at epoch {TRAINER_EPOCHS - 1}" in f.read()
    epoch = TRAINER_EPOCHS
    busy = busy_share(os.path.join(trace_dir, "trace.json"),
                      f"mlsp/epoch {epoch}")
    rres = {"argv": resume, "resumed_message": said,
            "epochs_run": [r["epoch"] for r in after[TRAINER_EPOCHS:]],
            "last_epoch": checkpoint.load_train_state(
                last, make_model("dgcnn", NUM_CLASS, device="cpu"))[0],
            "profiled_epoch": {"epoch": epoch, **busy,
                               "seconds": after[-1]["seconds"]}}
    emit("trainer", what="resume", **rres)
    check(said and rres["epochs_run"] == [epoch]
          and rres["last_epoch"] == epoch,
          f"the resumed run did not take exactly epoch {epoch}: {rres}")
    return {**res, "resume": rres, "model_file": os.path.join(exp,
                                                               "model.ckpt")}


def eval_infer(tmp: str, model_file: str) -> dict:
    """`eval` and `infer` on the target test split, kernels and plain."""
    out = os.path.join(tmp, "runs")
    res, preds = {}, {}
    for route in ("kernels", "plain"):
        extra = [] if route == "kernels" else ["--knn_backend", "torch"]
        for cmd in ("eval", "infer"):
            name = f"{cmd}_{route}"
            argv = [cmd, "--model_file", model_file, "--synthetic", "True",
                    "--out_path", out, "--exp_name", name, *extra]
            launches = run_cli(argv, os.path.join(tmp, f"{name}.log"))
            with open(os.path.join(out, name, "run.log")) as f:
                summary = json.loads(f.read().splitlines()[-1].split(": ", 1)[1])
            res[name] = {"launches": launches, **summary}
            if cmd == "infer":
                preds[route] = np.load(summary["output"])
    k, p = preds["kernels"], preds["plain"]
    expected = {**dict.fromkeys(PER_STEP, 0), "knn": 5 * EVAL_FORWARDS,
                "edge_moments": 4 * EVAL_FORWARDS}
    cmp = {"clouds": int(k["pred"].shape[0]),
           "class_agreement": float((k["pred"] == p["pred"]).mean()),
           "max_prob_diff": float(np.abs(k["prob"] - p["prob"]).max()),
           "finite": bool(np.isfinite(k["prob"]).all()),
           "launches_expected": expected}
    emit("eval_infer", **res, compare=cmp)
    for cmd in ("eval", "infer"):
        check(res[f"{cmd}_kernels"]["launches"] == expected,
              f"{cmd} did not launch K1 and K2-fwd as expected")
        check(not any(res[f"{cmd}_plain"]["launches"].values()),
              f"plain {cmd} launched kernels")
    check(cmp["finite"] and k["prob"].shape == (80, NUM_CLASS)
          and np.array_equal(k["index"], p["index"]),
          "infer's output is not 80 finite rows of probabilities")
    check(cmp["class_agreement"] >= MIN_CLASS_AGREEMENT
          and cmp["max_prob_diff"] <= MAX_LOGIT_DIFF,
          f"infer through the kernels disagrees with the plain route: {cmp}")
    for route in ("kernels", "plain"):
        check(res[f"eval_{route}"]["acc"] == res[f"infer_{route}"]["acc"],
              f"eval's accuracy differs from infer's ({route})")
    return {**res, "compare": cmp}


def trainer_times(tr: dict, model_file: str, step_p50_ms: float, device,
                  card: str) -> dict:
    """The trainer's epoch wall time (epochs after the first), train
    steps/s in its loop, the device's busy share over the profiled epoch,
    and eval/infer clouds/s at B=32 on the target train split."""
    secs = tr["epoch_seconds"][1:]
    model = make_model("dgcnn", NUM_CLASS, device=device)
    checkpoint.load_model_weights(model, model_file)
    ds = load_pointda("scannet", ".", "train", N, True, 1, device=device)
    steps = len(ds.train_ind) // B  # every synthetic domain: 256 // 32
    x = torch.from_numpy(ds.data).to(device)
    sels, _ = eval_batches(len(ds), B)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()  # both return host numpy: the device has finished
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    busy_ms = tr["resume"]["profiled_epoch"].get("busy_ms")
    t_eval = timed(lambda: evaluate(model, x, ds.label, B, NUM_CLASS))
    t_infer = timed(lambda: eval_logits(model, x, sels))
    res = {"epochs_timed": len(secs),
           "epoch_wall_s_median": statistics.median(s["epoch"] for s in secs),
           "train_wall_s_median": statistics.median(s["train"] for s in secs),
           "steps_per_epoch": steps,
           "train_steps_per_s_in_loop": steps / statistics.median(
               s["train"] for s in secs),
           "isolated_step_p50_ms": step_p50_ms,
           "isolated_steps_per_s": 1e3 / step_p50_ms,
           "device_busy_share_profiled_epoch":
               tr["resume"]["profiled_epoch"]["busy_share"],
           # the profiler slows the host, not the kernels: the profiled
           # epoch's device time over an unprofiled epoch's wall time
           "device_busy_share_unprofiled_est": (
               busy_ms / 1e3 / statistics.median(s["epoch"] for s in secs)
               if busy_ms else None),
           "profiled_epoch": tr["resume"]["profiled_epoch"],
           "eval_clouds": len(ds), "batch": B,
           "eval_clouds_per_s": len(ds) / t_eval,
           "infer_clouds_per_s": len(ds) / t_infer, "card": card}
    emit("times", what="trainer", **res)
    return res


# PointSegDA (the seg main paths): DGCNNSeg, k=20, N=2048, 8 classes, train
# batch 16, test batch 32 (utils/config.py PointSegDAConfig), the MLSP recipe
# of configs/pointsegda_mlsp.yaml plus PCM. Per seg step K1 8 (two forwards
# of 4 graphs), K3 1 (the normals, k = near = 10), K4 1 (PCM's [2B, N]); the
# seg model has no K2. The seg trainer on the synthetic data: 3 steps an
# epoch (48 train clouds a domain), 2 validation forwards (16 clouds a
# split at B=32) and 1 final-test forward.
SEG_B, SEG_N, SEG_TEST_B, SEG_NUM_CLASS, SEG_NEAR = 16, 2048, 32, 8, 10
SEG_RECIPE = "configs/pointsegda_mlsp.yaml"
SEG_CONFIG = "configs/pointsegda/adobe2faust.yaml"
SEG_TRAIN_STEPS = 3
SEG_PER_STEP = {**dict.fromkeys(PER_STEP, 0), "knn": 8, "knn_moments": 1,
                "fps": 1}
SEG_FORWARD = {**dict.fromkeys(PER_STEP, 0), "knn": 4}
SEG_GRAPHS_PER_STEP, SEG_ORDERS_PER_STEP = 9, 1  # 2 x 4 kNN + K3; PCM
SEG_TRAINER_EPOCHS = 2
SEG_EVAL_CLOUDS = 160  # 5 batches of 32 for the eval/infer throughput


def seg_trainer_launches(epochs: int) -> dict:
    return {**dict.fromkeys(PER_STEP, 0), "knn": 32 * epochs + 4,
            "knn_moments": 3 * epochs, "fps": 3 * epochs}


def repo_file(rel: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def seg_cfg() -> PointSegDAConfig:
    cfg = load_yaml(PointSegDAConfig, repo_file(SEG_RECIPE))
    return dataclasses.replace(cfg, apply_PCM=True).resolved()


def seg_model(cfg: PointSegDAConfig, device, knn_backend: str = "auto"):
    """Full-width DGCNNSeg from seeded random weights and BatchNorm."""
    g = torch.Generator().manual_seed(SEED + 7)
    model = make_model("dgcnn_seg", cfg.num_class, device=device, generator=g,
                       k=K, dropout=cfg.dropout,
                       density_num_cls=cfg.density_num_class,
                       pergroup=cfg.pergroup, knn_backend=knn_backend)
    randomise_batch_norm(model, g)
    return model.train()


def seg_kernel_inputs(model, x: torch.Tensor) -> list:
    """The four clouds a seg forward builds kNN graphs of, as
    DGCNNSeg.forward computes them: the raw cloud (C=3), the transformed
    cloud (edge1's graph, C=3), and edge1's and edge2's outputs (C=64)."""
    with torch.no_grad():
        T = model.input_transform_net(edge_features(x, knn_indices(x, K)))
        xt = torch.einsum("bnc,bdc->bnd", x, T)
        sl = model.shared_layers
        x1 = sl.edge1(xt, knn_indices(xt, K))
        x2 = sl.edge2(x1, knn_indices(x1, K))
    return [("cloud", x), ("edge1", xt), ("edge2", x1), ("edge3", x2)]


def seg_kernels(device, g: torch.Generator) -> dict:
    """K1, K3 and K4 against their plain versions at the seg shapes: K1 on
    a B=16 seg forward's own inputs and at the eval batch's [32, 2048, 64];
    K3 at [16, 2048, 3] with k = near = 10; K4 at PCM's [2B, N, 3] = [32,
    2048, 3] with npoint = N, index-equal."""
    cfg = seg_cfg()
    model = seg_model(cfg, device).eval()
    clouds = make_segmentation(SEG_TEST_B, SEG_N, SEG_NUM_CLASS,
                               seed=SEED + 9)[0]
    x32 = torch.from_numpy(clouds).to(device)
    x = x32[:SEG_B]
    knn_in = seg_kernel_inputs(model, x)
    knn_checks = [check_knn(f"seg {name}", t, "seg_kernels")
                  for name, t in knn_in]
    eval_in = seg_kernel_inputs(model, x32)[-1]
    knn_checks.append(check_knn(f"seg eval {eval_in[0]}", eval_in[1],
                                "seg_kernels"))
    moments = check_knn_moments(x, SEG_NEAR, "seg_kernels")
    start = torch.randint(0, SEG_N, (2 * SEG_B,), generator=g).to(device)
    fps_check = check_fps(x32, start, what="seg PCM [2B, N]",
                          phase="seg_kernels")
    return {"knn_in": knn_in + [(f"eval {eval_in[0]}", eval_in[1])],
            "knn": knn_checks, "knn_moments": moments, "fps": fps_check,
            "x": x, "x32": x32, "fps_start": start}


def seg_batches(cfg: PointSegDAConfig, device) -> list:
    """Synthetic (src_x, src_y, trgt_x) seg batches, one per step."""
    clouds, labels = make_segmentation(2 * cfg.batch_size * SEG_TRAIN_STEPS,
                                       cfg.num_points, cfg.num_class,
                                       seed=SEED + 8)
    x = torch.from_numpy(clouds).to(device).split(cfg.batch_size)
    y = torch.from_numpy(labels).to(device).split(cfg.batch_size)
    return [(x[2 * i], y[2 * i], x[2 * i + 1]) for i in range(SEG_TRAIN_STEPS)]


def seg_train(device) -> dict:
    """The seg train main path, then its first step through the plain
    route on the kernel run's kNN graphs and FPS orders."""
    cfg = seg_cfg()
    batches = seg_batches(cfg, device)
    model = seg_model(cfg, device)
    init = copy.deepcopy(model.state_dict())
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                STEPS_PER_EPOCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    steps = [pointsegda_train_step(model, opt, sched, *b, gen, cfg)
             for b in batches]
    torch.cuda.synchronize()
    launches = kernels.launches()
    losses = [{k: float(v) for k, v in m.items()} for m, _ in steps]
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    preds, labels = steps[0][1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def rerun(backend, delta=0.0):
        m = seg_model(cfg, device, backend)
        m.load_state_dict(init)
        o, sc = make_optimizer(m, cfg.lr, cfg.wd, cfg.epochs, STEPS_PER_EPOCH)
        src_x, src_y, trgt_x = batches[0]
        out, _ = pointsegda_train_step(
            m, o, sc, src_x + delta, src_y, trgt_x + delta,
            torch.Generator(device=device).manual_seed(SEED),
            dataclasses.replace(cfg, knn_backend=backend))
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        return {k: float(v) for k, v in out.items()}, grads

    cmp = compare_routes(rerun, True)
    res = {"config": f"{SEG_RECIPE} + apply_PCM", "batch": cfg.batch_size,
           "points": cfg.num_points, "k": K, "near": cfg.near,
           "steps": SEG_TRAIN_STEPS, "launches": launches,
           "launches_expected": {k: SEG_TRAIN_STEPS * v
                                 for k, v in SEG_PER_STEP.items()},
           "losses": losses, "finite": finite, "peak_memory_gb": peak_gb,
           "preds_shape": list(preds.shape),
           "first_step_plain_vs_kernel": cmp}
    emit("seg_train", **res)
    check(finite, f"non-finite seg train losses: {losses}")
    check(list(preds.shape) == list(labels.shape) == [cfg.batch_size,
                                                      cfg.num_points],
          "the seg step's predictions are not [B, N]")
    check(launches == res["launches_expected"],
          f"the seg train path did not launch every kernel as expected: "
          f"{launches}")
    check(not any(cmp["plain_route_launches"].values()),
          f"the plain route launched kernels: {cmp['plain_route_launches']}")
    r = cmp["replayed"]
    check((r["graphs"], r["fps_orders"])
          == (SEG_GRAPHS_PER_STEP, SEG_ORDERS_PER_STEP)
          and r["plain_own_fps_entries_differ"] == 0,
          f"first seg step: unexpected kNN graphs or FPS orders {r}")
    check(cmp["same_grad_set"] and not cmp["outside"],
          f"first seg step: plain route or kernel rerun disagrees with the "
          f"kernel route on {cmp['outside']}")
    return {**res, "cfg": cfg, "batches": batches, "model": model, "opt": opt,
            "sched": sched, "gen": gen, "init": init}


def seg_trainer(tmp: str) -> dict:
    """The `seg` CLI at full width on the adobe -> faust MLSP config."""
    out = os.path.join(tmp, "runs")
    exp = os.path.join(out, "seg_smoke_adobe_faust")
    argv = ["seg", "--config", repo_file(SEG_CONFIG), "--synthetic", "True",
            "--apply_PCM", "True", "--epochs", str(SEG_TRAINER_EPOCHS),
            "--out_path", out, "--exp_name", "seg_smoke"]
    t0 = time.perf_counter()
    launches = run_cli(argv, os.path.join(tmp, "seg_trainer.log"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        log = f.read()
    losses = [r["train"] for r in records]
    files = {f: os.path.exists(os.path.join(exp, f))
             for f in ("model.ckpt", "run.log", "metrics.jsonl")}
    prints = {p: p in log for p in ("Total params", "Best model was found "
                                    "at epoch", "target test seg loss:")}
    res = {"argv": argv, "epochs": SEG_TRAINER_EPOCHS, "seconds": seconds,
           "launches": launches,
           "launches_expected": seg_trainer_launches(SEG_TRAINER_EPOCHS),
           "losses": losses, "finite": all(np.isfinite(v) for r in losses
                                           for v in r.values()),
           "files": files, "records": len(records), "log_prints": prints,
           "epoch_seconds": [r["seconds"] for r in records],
           "val": [{k: r[k]["mIoU"] for k in ("src_val", "trgt_val")}
                   for r in records]}
    emit("seg_trainer", **res)
    check(res["finite"], f"non-finite seg trainer losses: {losses}")
    check(launches == res["launches_expected"],
          f"the seg trainer did not launch every kernel as expected: "
          f"{launches}")
    check(all(files.values()) and res["records"] == SEG_TRAINER_EPOCHS
          and all(prints.values()),
          f"the seg trainer left {files}, {res['records']} records, {prints}")
    return {**res, "model_file": os.path.join(exp, "model.ckpt")}


def seg_eval_infer(tmp: str, model_file: str) -> dict:
    """`eval` and `infer --task pointsegda` on the target test split from
    the seg trainer's model.ckpt, through the kernels and the plain route:
    per-point classes agree on >= 99% of points, max |dprob| <= 2e-2,
    eval's accuracy equals infer's; one forward each (K1 4)."""
    out = os.path.join(tmp, "runs")
    res, preds = {}, {}
    for route in ("kernels", "plain"):
        extra = [] if route == "kernels" else ["--knn_backend", "torch"]
        for cmd in ("eval", "infer"):
            name = f"seg_{cmd}_{route}"
            argv = [cmd, "--task", "pointsegda", "--model_file", model_file,
                    "--synthetic", "True", "--out_path", out, "--exp_name",
                    name, *extra]
            launches = run_cli(argv, os.path.join(tmp, f"{name}.log"))
            with open(os.path.join(out, name, "run.log")) as f:
                summary = json.loads(f.read().splitlines()[-1].split(": ", 1)[1])
            res[name] = {"launches": launches, **summary}
            if cmd == "infer":
                preds[route] = np.load(summary["output"])
    k, p = preds["kernels"], preds["plain"]
    cmp = {"clouds": int(k["pred"].shape[0]),
           "point_class_agreement": float((k["pred"] == p["pred"]).mean()),
           "max_prob_diff": float(np.abs(k["prob"] - p["prob"]).max()),
           "finite": bool(np.isfinite(k["prob"]).all()),
           "launches_expected": SEG_FORWARD}
    emit("seg_eval_infer", **res, compare=cmp)
    for cmd in ("eval", "infer"):
        check(res[f"seg_{cmd}_kernels"]["launches"] == SEG_FORWARD,
              f"seg {cmd} did not launch K1 as expected")
        check(not any(res[f"seg_{cmd}_plain"]["launches"].values()),
              f"plain seg {cmd} launched kernels")
    check(cmp["finite"] and k["prob"].shape == (16, SEG_N, SEG_NUM_CLASS)
          and np.array_equal(k["index"], p["index"]),
          "seg infer's output is not 16 finite clouds of per-point "
          "probabilities")
    check(cmp["point_class_agreement"] >= MIN_CLASS_AGREEMENT
          and cmp["max_prob_diff"] <= MAX_LOGIT_DIFF,
          f"seg infer through the kernels disagrees with the plain route: "
          f"{cmp}")
    for route in ("kernels", "plain"):
        check(res[f"seg_eval_{route}"]["acc"]
              == res[f"seg_infer_{route}"]["acc"],
              f"seg eval's accuracy differs from infer's ({route})")
    return {**res, "compare": cmp}


def seg_kernel_times(device, card: str, seg: dict, g: torch.Generator
                     ) -> dict:
    """Per-launch medians at the seg shapes beside bound and plain time, and
    the LinearEdgeBlock max over gathered u (forward and backward) against
    K2-fwd's max and K2-bwd, the option of routing it through K2."""
    rows = {"knn": [], "knn_moments": [], "fps": []}

    def row(kname, what, shape, fn, plain_fn, cost, plain_reps=30):
        b_ms, b_by = bound(*cost)
        r = {"input": what, "shape": list(shape), "ms": median_ms(fn),
             "plain_ms": median_ms(plain_fn, reps=plain_reps,
                                   warmup=min(plain_reps, 5)),
             "bound_ms": b_ms, "bound_by": b_by}
        rows[kname].append(r)
        return r

    for name, t in seg["knn_in"]:
        row("knn", name, t.shape, lambda: knn_cuda(t, K),
            lambda: knn_indices_torch(t, K), knn_cost(t, K))
    x = seg["x"]
    row("knn_moments", "seg target clouds", x.shape,
        lambda: knn_moments_cuda(x, SEG_NEAR),
        lambda: knn_moments_torch(x, SEG_NEAR),
        knn_moments_cost(SEG_B, SEG_N, SEG_NEAR))
    x32, start = seg["x32"], seg["fps_start"]
    row("fps", "seg PCM [2B, N]", x32.shape, lambda: fps_cuda(x32, SEG_N, start),
        lambda: fps_torch(x32, SEG_N, start), fps_cost(2 * SEG_B, SEG_N),
        plain_reps=3)
    for kname, per_shape in rows.items():
        emit("times", what=f"seg_{kname}", per_launch=per_shape,
             launches_per_seg_step=SEG_PER_STEP[kname], card=card)

    # The option: LinearEdgeBlock's max over gathered u through K2-fwd (eval
    # form: max and min) and K2-bwd (max cotangent only), at edge2's and
    # edge3's shape on their own graphs. Not on any path of the port.
    option = []
    for name, t in seg["knn_in"][2:4]:
        idx = knn_cuda(t, K)
        u = torch.randn(t.shape, generator=g).to(device)
        cot = torch.randn(t.shape, generator=g).to(device)

        def plain():
            uu = u.detach().requires_grad_()
            y = knn_gather(uu, idx).amax(-2)
            return y, torch.autograd.grad(y, uu, cot)[0]

        def via_k2():
            mx, mn = edge_moments_cuda(u, idx, False)
            return mx, edge_moments_bwd_cuda(u, idx, mx, mn, cot, None)

        (py, pdu), (ky, kdu) = plain(), via_k2()
        torch.cuda.synchronize()
        option.append({"input": name, "shape": list(t.shape),
                       "max_equal": bool(torch.equal(py, ky)),
                       "du_max_abs_err": float((pdu - kdu).abs().max()),
                       "gather_amax_fwd_bwd_ms": median_ms(plain),
                       "k2_fwd_bwd_ms": median_ms(via_k2)})
    emit("times", what="seg_linear_edge_option", per_input=option, card=card)
    return {"rows": rows, "linear_edge_option": option}


def seg_step_times(tr: dict, device, card: str) -> dict:
    """Seg train step p50 (host clock around a step that ends in a
    synchronize), kernel route after the main path's steps and plain route
    from the initial weights."""
    cfg, batches = tr["cfg"], tr["batches"]

    def p50(model, opt, sched, gen, c, n, warm):
        out = []
        for i in range(warm + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pointsegda_train_step(model, opt, sched,
                                  *batches[i % len(batches)], gen, c)
            torch.cuda.synchronize()
            if i >= warm:
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), len(out)

    ms, n = p50(tr["model"], tr["opt"], tr["sched"], tr["gen"], cfg, 12, 2)
    plain = seg_model(cfg, device, "torch")
    plain.load_state_dict(tr["init"])
    popt, psched = make_optimizer(plain, cfg.lr, cfg.wd, cfg.epochs,
                                  STEPS_PER_EPOCH)
    pms, pn = p50(plain, popt, psched,
                  torch.Generator(device=device).manual_seed(SEED),
                  dataclasses.replace(cfg, knn_backend="torch"), 4, 1)
    res = {"batch": cfg.batch_size, "points": cfg.num_points,
           "steps_timed": n, "p50_ms": ms,
           "clouds_per_s": cfg.batch_size / (ms / 1e3),
           "plain_steps_timed": pn, "plain_p50_ms": pms,
           "plain_clouds_per_s": cfg.batch_size / (pms / 1e3),
           "launches_per_step": SEG_PER_STEP, "card": card}
    emit("times", what="seg_train_step", **res)
    return res


def seg_trainer_times(tr: dict, step_p50_ms: float, device,
                      card: str) -> dict:
    """The seg trainer's epoch wall time (epochs after the first), train
    steps/s in its loop, and seg eval and infer clouds/s at B=32 over
    SEG_EVAL_CLOUDS synthetic clouds staged on the card."""
    secs = tr["epoch_seconds"][1:]
    model = make_model("dgcnn_seg", SEG_NUM_CLASS, device=device)
    checkpoint.load_model_weights(model, tr["model_file"])
    clouds, labels = make_segmentation(SEG_EVAL_CLOUDS, SEG_N, SEG_NUM_CLASS,
                                       seed=SEED + 10)
    x = torch.from_numpy(clouds).to(device)
    sels, _ = eval_batches(SEG_EVAL_CLOUDS, SEG_TEST_B)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()  # both return host numpy: the device has finished
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    t_eval = timed(lambda: evaluate_seg(model, x, labels, SEG_TEST_B))
    t_infer = timed(lambda: eval_logits(model, x, sels, "seg"))
    steps = 3  # 48 synthetic train clouds a domain at B=16
    res = {"epochs_timed": len(secs),
           "epoch_wall_s_median": statistics.median(s["epoch"] for s in secs),
           "train_wall_s_median": statistics.median(s["train"] for s in secs),
           "steps_per_epoch": steps,
           "train_steps_per_s_in_loop": steps / statistics.median(
               s["train"] for s in secs),
           "isolated_step_p50_ms": step_p50_ms,
           "eval_clouds": SEG_EVAL_CLOUDS, "batch": SEG_TEST_B,
           "eval_clouds_per_s": SEG_EVAL_CLOUDS / t_eval,
           "infer_clouds_per_s": SEG_EVAL_CLOUDS / t_infer, "card": card}
    emit("times", what="seg_trainer", **res)
    return res


# The recipe branches (the `branches` phase): every PointDA recipe flag at
# the flagship width, B=32, N=1024, k=20, from the paper recipe's weights
# and batches. A train forward launches K1 5, K2-fwd 4 and K2-bwd 4; each
# normal estimate K3 once; PCM K4 once. The all-branch recipe takes 9
# forwards (source DefRec, PCM, source DefRec + normal + density, target
# DefRec, normals, scan, density, DefRec + normal + density, SPL) and 3
# normal estimates. Its SPL_v2 gate is raised from the paper's 1.6366 to
# 2.31, above the largest entropy of softmax(softmax(10 logits)), log 10:
# every target cloud is kept, so the SPL term has a gradient (at 1.6366
# none would be). The viachamfer recipe is the paper recipe with the
# labels carried by the Chamfer nearest indices in place of the input ones.
def train_launches(forwards: int, normals: int, pcm: int) -> dict:
    return {"knn": 5 * forwards, "edge_moments": 4 * forwards,
            "edge_moments_bwd": 4 * forwards, "knn_moments": normals,
            "fps": pcm}


ALL_BRANCHES = dict(
    DefRec_on_src=True, apply_PCM=True, Density_normal_viainput_onsrc=True,
    DefRec_on_trgt=True, Norm_on_trgt=True, Scan_on_trgt=True,
    Density_on_trgt=True, Density_normal_viainput=True, Normal_ondef=True,
    Density_ondef=True, apply_SPL_v2=True, gamma_v2=2.31)
RECIPES = {
    "all_branches": (ALL_BRANCHES, train_launches(9, 3, 1)),
    "viachamfer": (dict(Density_normal_viainput=False,
                        Density_normal_viachamfer=True),
                   train_launches(2, 1, 1)),
    "sgd": (dict(optimizer="SGD"), PER_STEP),
    "adamw": (dict(optimizer="ADAMW"), PER_STEP),
}
BRANCH_STEPS = 2  # counted steps per recipe; then BRANCH_TIMED more, timed
BRANCH_TIMED = 6


def branch_step_time(model, opt, sched, batches, gen, cfg, n: int) -> float:
    """p50 of n steps (host clock around a step that ends in a
    synchronize), after one warm step."""
    out = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pointda_train_step(model, opt, sched, *batches[i % len(batches)], gen,
                           cfg)
        torch.cuda.synchronize()
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def branches(device, card: str) -> dict:
    """BRANCH_STEPS steps of each recipe of RECIPES with exact launch
    counts, finite losses, p50 and peak memory; the all-branch recipe's
    first step again through the plain route on the kernel run's kNN
    graphs and FPS order, with eval-mode BN (losses within LOSS_RTOL,
    gradients within GRAD_RTOL)."""
    batches = train_batches(train_cfg(), device)
    total = dict.fromkeys(PER_STEP, 0)
    res = {}
    for name, (flags, per_step) in RECIPES.items():
        cfg = dataclasses.replace(train_cfg(), **flags)
        model = train_model(cfg, device)
        init = copy.deepcopy(model.state_dict())
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH, cfg.optimizer,
                                    cfg.momentum)
        gen = torch.Generator(device=device).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        steps = [pointda_train_step(model, opt, sched,
                                    *batches[i % len(batches)], gen, cfg)
                 for i in range(BRANCH_STEPS)]
        torch.cuda.synchronize()
        launches = kernels.launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [{k: float(v) for k, v in m.items()} for m in steps]
        p50 = branch_step_time(model, opt, sched, batches, gen, cfg,
                               BRANCH_TIMED)
        r = {"recipe": name, "flags": flags, "optimizer": cfg.optimizer,
             "batch": cfg.batch_size, "points": cfg.num_points,
             "steps": BRANCH_STEPS, "launches": launches,
             "launches_expected": {k: BRANCH_STEPS * v
                                   for k, v in per_step.items()},
             "losses": losses,
             "finite": all(np.isfinite(v) for m in losses
                           for v in m.values()),
             "p50_ms": p50, "steps_timed": BRANCH_TIMED,
             "peak_memory_gb": peak_gb, "card": card}
        if name == "all_branches":
            r["first_step_plain_vs_kernel_eval_bn"] = compare_first_step(
                dataclasses.replace(cfg, debug_bn_eval=True), batches[0],
                init, device)
        emit("branches", **r)
        check(r["finite"], f"non-finite {name} losses: {losses}")
        check(launches == r["launches_expected"],
              f"the {name} steps did not launch every kernel as expected: "
              f"{launches}")
        if name == "all_branches":
            c = r["first_step_plain_vs_kernel_eval_bn"]
            rep = c["replayed"]
            check(not any(c["plain_route_launches"].values()),
                  f"the plain route launched kernels: "
                  f"{c['plain_route_launches']}")
            check((rep["graphs"], rep["fps_orders"]) ==
                  (per_step["knn"] + per_step["knn_moments"], per_step["fps"])
                  and rep["plain_own_fps_entries_differ"] == 0,
                  f"all-branch first step: unexpected kNN graphs or FPS "
                  f"orders {rep}")
            check(c["same_grad_set"] and not c["outside"],
                  f"all-branch first step: the plain route or a kernel rerun "
                  f"disagrees with the kernel route on {c['outside']}")
            check(all(m["trgt_SPL_selected"] == 1.0 for m in losses),
                  "the SPL_v2 gate did not keep every target cloud")
        for k, v in launches.items():
            total[k] += v
        res[name] = r
    return {"recipes": res, "launches": total}


def scan_graph(device, card: str, g: torch.Generator) -> dict:
    """K1 and K2-bwd on a real `Scan_on_trgt` batch (the train batch's
    target clouds occluded by `scan_batch`, about a quarter exact zeros):
    K1 at the five kNN inputs of a forward on it by equal sorted distance
    sets, K2-bwd at its four EdgeConv shapes by du within its tolerance;
    then both timed per launch beside the paper batch's, with the graphs'
    largest in-degree."""
    trgt = train_batches(train_cfg(), device)[0][2]
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    sx, smask = scan_batch(trgt, *draw_scan(gen, trgt.shape[0]))
    model = train_model(train_cfg(), device).eval()
    runs = {"scan": kernel_inputs(model, sx), "paper": kernel_inputs(model,
                                                                     trgt)}
    knn_checks = [check_knn(f"scan {name}", t, phase="scan_graph")
                  for name, t in runs["scan"][0]]
    bwd_checks = [check_edge_bwd(f"scan {name}", xg, u, g)
                  for name, xg, u in runs["scan"][1]]
    times = {}
    for what, (knn_in, edge_in) in runs.items():
        rows = {"knn": [], "edge_moments_bwd": []}
        for name, t in knn_in:
            idx = knn_cuda(t, K)
            indeg = torch.stack([torch.bincount(i.flatten(), minlength=N)
                                 for i in idx])
            rows["knn"].append({
                "input": name, "shape": list(t.shape),
                "ms": median_ms(lambda: knn_cuda(t, K)),
                "plain_ms": median_ms(lambda: knn_indices_torch(t, K)),
                "max_in_degree": int(indeg.max()),
                **dict(zip(("bound_ms", "bound_by"), bound(*knn_cost(t))))})
        for name, xg, u in edge_in:
            idx = knn_cuda(xg, K)
            outs = edge_moments_cuda(u, idx, True)
            cots = [torch.randn(u.shape, generator=g).to(device)
                    for _ in range(4)]
            uu = u.detach().clone().requires_grad_()
            plain_outs = edge_moments_torch(uu, idx, True)
            indeg = torch.stack([torch.bincount(i.flatten(), minlength=N)
                                 for i in idx])
            rows["edge_moments_bwd"].append({
                "input": name, "shape": list(u.shape),
                "ms": median_ms(lambda: edge_moments_bwd_cuda(
                    u, idx, outs[0], outs[1], *cots)),
                "plain_ms": median_ms(lambda: torch.autograd.grad(
                    plain_outs, uu, cots, retain_graph=True)),
                "max_in_degree": int(indeg.max()),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*edge_bwd_cost(u, K))))})
        times[what] = rows
    res = {"zero_points": float((sx == 0).all(-1).float().mean()),
           "removed_share": float(smask.mean()),
           "knn_max_dist_gap": max(c["max_dist_gap"] for c in knn_checks),
           "bwd_max_abs_err": max(c["max_abs_err"] for c in bwd_checks),
           "per_launch": times,
           "per_forward_ms": {what: {k: sum(r["ms"] for r in rows)
                                     for k, rows in t.items()}
                              for what, t in times.items()},
           "card": card}
    emit("times", what="scan_graph", **res)
    return {**res, "knn_checks": knn_checks, "bwd_checks": bwd_checks}


# The `spst` phase: the CLI from the trainer phase's model.ckpt, full width
# (B = test batch = 32, N=1024), SPST_ROUNDS rounds of 1 epoch with PCM, at
# a threshold above log 10 (every target train cloud is selected; at the
# paper's 1.5492 a 2-epoch pretrain selects next to none, so no step would
# run). Three rounds, so that the LR's rise in round 3 shows: torch's cosine
# with T_max = epochs = 1 gives lr, 0, lr. Each round: the selection (256
# target train clouds, 8 eval forwards), 8 steps (2 train forwards and one
# PCM each), the validation and test evaluations (2 + 2 + 3 eval forwards);
# and the initial and final test evaluations (3 + 3).
SPST_ROUNDS, SPST_THRESHOLD, SPST_PAPER_THRESHOLD = 3, 2.31, 1.5492
SPST_STEPS, SELECT_FORWARDS, VAL_FORWARDS = 8, 8, 4
SPST_LR = 1e-4  # utils/config.py SPSTConfig
SSL_HEADS = ("DefRec.", "Norm_pred.", "Rec_scan.", "Density_cls.")


def spst_launches(rounds: int) -> dict:
    evals = 2 * EVAL_FORWARDS + rounds * (SELECT_FORWARDS + VAL_FORWARDS
                                          + EVAL_FORWARDS)
    trains = rounds * SPST_STEPS * 2
    return {"knn": 5 * (evals + trains), "edge_moments": 4 * (evals + trains),
            "edge_moments_bwd": 4 * trains, "knn_moments": 0,
            "fps": rounds * SPST_STEPS}


def spst(tmp: str, model_file: str, device) -> dict:
    """The `spst` CLI in-process, from the trainer phase's model.ckpt."""
    out = os.path.join(tmp, "runs")
    exp = os.path.join(out, "spst")
    # for information: what the paper's threshold selects from this model
    model = make_model("dgcnn", NUM_CLASS, device=device)
    checkpoint.load_model_weights(model, model_file)
    ds = load_pointda("scannet", ".", "train", N, True, 1, device=device)
    with open(os.devnull, "w") as f, contextlib.redirect_stdout(f):
        sel, _ = select_pseudo_labels(
            model, torch.from_numpy(ds.data).to(device), ds.label,
            ds.train_ind, B, SPST_PAPER_THRESHOLD, True,
            IOStream(tmp, "select"), 0)
    argv = ["spst", "--synthetic", "True", "--model_file", model_file,
            "--rounds", str(SPST_ROUNDS), "--epochs", "1", "--threshold",
            str(SPST_THRESHOLD), "--apply_PCM", "True", "--out_path", out,
            "--exp_name", "spst"]
    t0 = time.perf_counter()
    launches = run_cli(argv, os.path.join(tmp, "spst.log"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        log = f.read()
    files = {f: os.path.exists(os.path.join(exp, f))
             for f in ("model.ckpt", "best_model.ckpt",
                       "finetune_convergence.json")}
    loaded = torch.load(model_file, map_location="cpu",
                        weights_only=True)["model"]
    heads_same = {}
    for f in ("model.ckpt", "best_model.ckpt"):
        if files[f]:
            sd = torch.load(os.path.join(exp, f), map_location="cpu",
                            weights_only=True)["model"]
            heads_same[f] = all(torch.equal(sd[k], t)
                                for k, t in loaded.items()
                                if k.startswith(SSL_HEADS))
    lrs = [r["lr"] for r in records]
    want_lrs = [torch_cosine_lr(SPST_LR, 1, e) for e in range(SPST_ROUNDS)]
    weights = [(r["spl_weight"], r["cls_weight"]) for r in records]
    want_weights = [1.0 - 5e-3 * (e + 1) for e in range(SPST_ROUNDS)]
    losses = [r["train"] for r in records]
    res = {"argv": argv, "seconds": seconds, "launches": launches,
           "launches_expected": spst_launches(SPST_ROUNDS),
           "selected_at_paper_threshold": f"{len(sel)}/{len(ds.train_ind)}",
           "selections": [ln.split("pseudo label selection: ")[1]
                          for ln in log.splitlines()
                          if "pseudo label selection: " in ln],
           "lrs": lrs, "lrs_expected": want_lrs, "weights": weights,
           "losses": losses, "files": files, "ssl_heads_unchanged": heads_same,
           "epoch_seconds": [r["seconds"] for r in records],
           "steps_per_epoch": SPST_STEPS,
           "train_steps_per_s": [SPST_STEPS / r["seconds"]["train"]
                                 for r in records],
           "trgt_test_acc": [r["trgt_test"]["acc"] for r in records]}
    emit("spst", **res)
    check(all(np.isfinite(v) for m in losses for v in m.values()),
          f"non-finite SPST losses: {losses}")
    check(launches == res["launches_expected"],
          f"spst did not launch every kernel as expected: {launches}")
    check(res["selections"] == ["256/256"] * SPST_ROUNDS,
          f"unexpected selections {res['selections']}")
    check(lrs == want_lrs and lrs[2] > lrs[1],
          f"the SPST learning rates {lrs} are not {want_lrs}")
    check(all(abs(s - w) < 1e-9 and abs(c - w) < 1e-9
              for (s, c), w in zip(weights, want_weights)),
          f"the spl/cls weights {weights} are not {want_weights}")
    check(all(files.values()) and heads_same
          and all(heads_same.values()),
          f"spst left {files}; SSL heads unchanged: {heads_same}")
    return res


# ---------------------------------------------------------------------------
# The `families` phase: PointNet, PointNet++, PointTransformer and the
# Hengshuang classifier and segmenter at full width (B=32, N=1024; seg
# B=16, N=2048). Launches, derived from the models: each forward of
# PointNet++ K4 2 (its two set abstractions), PointTransformer K4 1 (its
# group centers), Hengshuang K1 5 and K4 4 (a vector attention on the cloud
# and after each of 4 transition downs to N/4, N/16, N/64, N/256), with its
# DefRec or seg decoder K1 10 and K4 4 (5 more vector attentions; the
# decoder samples nothing); PointNet none; PCM K4 1 a step. The cross-set
# kNN of the groupings and the decoders' 3-NN interpolation are plain
# PyTorch on both routes (the JAX package runs them on XLA).
# ---------------------------------------------------------------------------

FAM_CONFIGS = {"point_transformer": "configs/pointda_pointtransformer.yaml",
               "hengshuang": "configs/pointda_hengshuang.yaml",
               "vit": "configs/pointda_vit.yaml"}
FAM_SEG_CONFIG = "configs/pointsegda_hengshuang.yaml"
FAM_FORWARD = {"pointnet": {}, "pointnet2": {"fps": 2},
               "point_transformer": {"fps": 1},
               "hengshuang": {"knn": 5, "fps": 4},
               "hengshuang_defrec": {"knn": 10, "fps": 4},
               "hengshuang_seg": {"knn": 10, "fps": 4},
               # vit with the "relative" embedder (the default) and the
               # "dgcnn" one (a self-kNN of each of its 5 graphs)
               "vit": {"fps": 1}, "vit_dgcnn": {"knn": 5, "fps": 1}}
FAM_STEPS, FAM_TIMED = 2, 6
FAM_TRAINER_EPOCHS = {"point_transformer": 2, "hengshuang": 1, "vit": 2}
FAM_SEG_EPOCHS = 1
FAM_REQUESTS = (32, 32, 32)


def launch_sum(*parts) -> dict:
    """Sum of (count, per-launch-dict) pairs over every kernel name."""
    return {k: sum(n * per.get(k, 0) for n, per in parts) for k in PER_STEP}


def fam_step_launches(name: str) -> dict:
    """One step of the family's recipe: the PCM forward, then (but for
    PointNet++, which has no DefRec head) the DefRec forward."""
    defrec = {"pointnet": FAM_FORWARD["pointnet"],
              "pointnet2": None,
              "point_transformer": FAM_FORWARD["point_transformer"],
              "hengshuang": FAM_FORWARD["hengshuang_defrec"],
              "vit": FAM_FORWARD["vit"],
              "vit_dgcnn": FAM_FORWARD["vit_dgcnn"]}[name]
    return launch_sum((1, {"fps": 1}), (1, FAM_FORWARD[name]),
                      *([(1, defrec)] if defrec is not None else []))


def fam_cfg(name: str) -> PointDAConfig:
    """PointNet: PCM + DefRec_on_trgt; PointNet++: PCM; PointTransformer and
    Hengshuang: their YAMLs (PCM + DefRec_on_trgt). B=32, N=1024."""
    if name in FAM_CONFIGS:
        return load_yaml(PointDAConfig, repo_file(FAM_CONFIGS[name]))
    return PointDAConfig(model=name, DefRec_on_trgt=name == "pointnet")


def fam_model(name: str, cfg, device, knn_backend: str = "auto",
              classes: int = NUM_CLASS, **extra):
    """Seeded weights and randomised BatchNorm, in train mode; `extra`:
    constructor-only keywords (vit's `encoder_type`)."""
    g = torch.Generator().manual_seed(SEED + 8)
    kw = model_kwargs(dataclasses.replace(cfg, knn_backend=knn_backend),
                      name)
    model = make_model(name, classes, device=device, generator=g, **kw,
                       **extra)
    randomise_batch_norm(model, g)
    return model.train()


@contextlib.contextmanager
def kernel_calls():
    """Records the inputs of every K1 and K4 launch made inside."""
    calls = {"knn": [], "fps": []}

    def keep(fn, into):
        def wrapped(*args):
            into.append(args)
            return fn(*args)
        return wrapped

    with mock.patch.object(_knn_mod, "knn_cuda",
                           keep(_knn_mod.knn_cuda, calls["knn"])), \
            mock.patch.object(_fps_mod, "fps_cuda",
                              keep(_fps_mod.fps_cuda, calls["fps"])):
        yield calls


def check_recorded(calls: dict, g: torch.Generator, device, phase: str
                   ) -> tuple[list, list]:
    """Each distinct K1 and K4 launch of `calls` (from `kernel_calls`)
    against its plain version: K1 by equal sorted distance sets and, on
    integer coordinates of its shape, equal indices; K4 index for index,
    on the recorded input and on integer coordinates."""
    knn_res, fps_res, seen = [], [], set()
    for x, k in calls["knn"]:
        key = ("knn", tuple(x.shape), k)
        if key in seen:
            continue
        seen.add(key)
        got, want = knn_cuda(x, k), knn_indices_torch(x, k)
        xi = integer_cloud(g, x.shape, device)
        exact = bool(torch.equal(knn_cuda(xi, k), knn_indices_torch(xi, k)))
        torch.cuda.synchronize()
        gap, tol = knn_set_gap(x, got, want)
        r = {"shape": list(x.shape), "k": k,
             "rows_same_indices": float((got == want).all(-1).float().mean()),
             "max_dist_gap": float(gap.max()),
             "max_gap_over_tol": float((gap / tol).max()),
             "integer_indices_equal": exact}
        emit(phase, kernel="knn", **r)
        check(bool((gap <= tol).all()) and exact,
              f"K1 disagrees with its plain version at a recorded shape: {r}")
        knn_res.append({**r, "x": x})
    for xyz, npoint, start in calls["fps"]:
        key = ("fps", tuple(xyz.shape), npoint)
        if key in seen:
            continue
        seen.add(key)
        xi = integer_cloud(g, xyz.shape, device)
        r = {"shape": list(xyz.shape), "npoint": npoint,
             "unequal_indices": int((fps_cuda(xyz, npoint, start)
                                     != fps_torch(xyz, npoint, start)).sum()),
             "integer_unequal_indices": int(
                 (fps_cuda(xi, npoint, start)
                  != fps_torch(xi, npoint, start)).sum())}
        emit(phase, kernel="fps", **r)
        check(r["unequal_indices"] == 0 and r["integer_unequal_indices"] == 0,
              f"K4 disagrees with the plain loop at a recorded shape: {r}")
        fps_res.append({**r, "x": xyz, "start": start})
    return knn_res, fps_res


def fam_kernel_checks(device, g: torch.Generator) -> dict:
    """K1 and K4 at every shape the families give them, on the inputs of
    full-width eval forwards (Hengshuang at [32, 1024, 3], its segmenter
    at [16, 2048, 3], PointNet++ and PointTransformer at [32, 1024, 3]):
    K1 by equal sorted distance sets and, on integer coordinates of the
    same shape, equal indices; K4 index for index, on the recorded inputs
    and on integer coordinates."""
    clouds = {n: torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                      seed=SEED + 9)[0]
                                  ).to(device)
              for b, n in ((B, N), (SEG_B, SEG_N))}
    cfg = PointDAConfig()
    with kernel_calls() as calls, torch.no_grad():
        for name, x in (("pointnet2", clouds[N]),
                        ("point_transformer", clouds[N]),
                        ("hengshuang", clouds[N]),
                        ("hengshuang_seg", clouds[SEG_N])):
            fam_model(name, cfg, device,
                      classes=SEG_NUM_CLASS if name == "hengshuang_seg"
                      else NUM_CLASS).eval()(x)
    knn_res, fps_res = check_recorded(calls, g, device, "families")
    levels = {max(n // 4 ** i, 1) for n in (N, SEG_N) for i in range(5)}
    check({(r["shape"][1], r["k"]) for r in knn_res}
          == {(n, min(16, n)) for n in levels},
          f"the Hengshuang forwards did not build kNN graphs at {levels}")
    # PointNet++ 512 of N and 128 of 512, PointTransformer 64 of N,
    # Hengshuang N/4 of N at each level (the seg model from SEG_N)
    want_fps = {(N, 512), (512, 128), (N, 64)} | {
        (max(n // 4 ** i, 1), max(n // 4 ** (i + 1), 1))
        for n in (N, SEG_N) for i in range(4)}
    check({(r["shape"][1], r["npoint"]) for r in fps_res} == want_fps,
          f"the family forwards did not sample at {want_fps}")
    return {"knn": knn_res, "fps": fps_res}


def fam_first_step(name, cfg, batch, init, device, **extra) -> dict:
    """The first step with eval-mode BN through the kernels, then through
    the plain versions on the kernel run's kNN graphs and FPS orders."""
    cfg = dataclasses.replace(cfg, debug_bn_eval=True)

    def rerun(backend, delta=0.0):
        m = fam_model(name, cfg, device, backend, **extra)
        m.load_state_dict(init)
        return first_step(m, dataclasses.replace(cfg, knn_backend=backend),
                          batch, device, delta)

    return compare_routes(rerun, False)


def fam_train(device, card: str) -> dict:
    """FAM_STEPS counted steps of each PointDA family at full width with
    exact launch counts, finite losses, p50 and peak memory; for
    PointTransformer and Hengshuang the first step again through the
    plain route (eval-mode BN; losses within LOSS_RTOL, gradients within
    GRAD_RTOL)."""
    batches = train_batches(train_cfg(), device)
    total = dict.fromkeys(PER_STEP, 0)
    res = {}
    for name in ("pointnet", "pointnet2", "point_transformer", "hengshuang"):
        cfg = fam_cfg(name)
        model = fam_model(name, cfg, device)
        init = copy.deepcopy(model.state_dict())
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH)
        gen = torch.Generator(device=device).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        steps = [pointda_train_step(model, opt, sched,
                                    *batches[i % len(batches)], gen, cfg)
                 for i in range(FAM_STEPS)]
        torch.cuda.synchronize()
        launches = kernels.launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [{k: float(v) for k, v in m.items()} for m in steps]
        per_step = fam_step_launches(name)
        r = {"model": name, "recipe": {"apply_PCM": cfg.apply_PCM,
                                       "DefRec_on_trgt": cfg.DefRec_on_trgt},
             "batch": cfg.batch_size, "points": cfg.num_points,
             "steps": FAM_STEPS, "launches": launches,
             "launches_expected": {k: FAM_STEPS * v
                                   for k, v in per_step.items()},
             "losses": losses,
             "finite": all(np.isfinite(v) for m in losses
                           for v in m.values()),
             "p50_ms": branch_step_time(model, opt, sched, batches, gen, cfg,
                                        FAM_TIMED),
             "steps_timed": FAM_TIMED, "peak_memory_gb": peak_gb,
             "card": card}
        if name in FAM_CONFIGS:
            c = fam_first_step(name, cfg, batches[0], init, device)
            r["first_step_plain_vs_kernel_eval_bn"] = c
        emit("families", what="train", **r)
        check(r["finite"], f"non-finite {name} losses: {losses}")
        check(launches == r["launches_expected"],
              f"the {name} steps did not launch K1/K4 as derived: {launches}")
        if name in FAM_CONFIGS:
            rep = c["replayed"]
            check(not any(c["plain_route_launches"].values()),
                  f"the plain route launched kernels: "
                  f"{c['plain_route_launches']}")
            check((rep["graphs"], rep["fps_orders"])
                  == (per_step["knn"], per_step["fps"])
                  and rep["plain_own_fps_entries_differ"] == 0,
                  f"{name} first step: unexpected kNN graphs or FPS orders "
                  f"{rep}")
            check(c["same_grad_set"] and not c["outside"],
                  f"{name} first step: the plain route or a kernel rerun "
                  f"disagrees with the kernel route on {c['outside']}")
        for k, v in launches.items():
            total[k] += v
        res[name] = r
    return {"families": res, "launches": total}


def fam_seg_train(device, card: str) -> dict:
    """FAM_STEPS seg steps of the Hengshuang segmenter, configs/
    pointsegda_hengshuang.yaml at B=16, N=2048 (the source seg forward and
    the DefRec forward, both decoding: K1 20, K4 8 a step), then p50 over
    FAM_TIMED more and peak memory (its vector attentions hold
    [16, 2048, 16, 128] tensors for the backward)."""
    cfg = load_yaml(PointSegDAConfig, repo_file(FAM_SEG_CONFIG)).resolved()
    batches = seg_batches(cfg, device)
    model = fam_model("hengshuang_seg", cfg, device, classes=cfg.num_class)
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                STEPS_PER_EPOCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    steps = [pointsegda_train_step(model, opt, sched,
                                   *batches[i % len(batches)], gen, cfg)[0]
             for i in range(FAM_STEPS)]
    torch.cuda.synchronize()
    launches = kernels.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = []
    for i in range(FAM_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pointsegda_train_step(model, opt, sched, *batches[i % len(batches)],
                              gen, cfg)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    losses = [{k: float(v) for k, v in m.items()} for m in steps]
    r = {"model": "hengshuang_seg", "batch": cfg.batch_size,
         "points": cfg.num_points, "steps": FAM_STEPS, "launches": launches,
         "launches_expected": launch_sum(
             (2 * FAM_STEPS, FAM_FORWARD["hengshuang_seg"])),
         "losses": losses, "finite": all(np.isfinite(v) for m in losses
                                         for v in m.values()),
         "p50_ms": statistics.median(times), "steps_timed": FAM_TIMED,
         "peak_memory_gb": peak_gb, "card": card}
    emit("families", what="seg_train", **r)
    check(r["finite"], f"non-finite hengshuang_seg losses: {losses}")
    check(launches == r["launches_expected"],
          f"the hengshuang_seg steps launched {launches}")
    return r


def fam_serve(bundle_dir: str, device, name: str = "point_transformer",
              phase: str = "families") -> dict:
    """A full-width bundle of `name` (PointTransformer; vit) answers
    FAM_REQUESTS on the card; launches counted over exactly those
    requests; answers held against the plain path."""
    cfg = fam_cfg(name)
    model = fam_model(name, cfg, device).eval()
    clouds, _ = make_classification(sum(FAM_REQUESTS), N, NUM_CLASS,
                                    seed=SEED + 10)
    requests = np.split(clouds, np.cumsum(FAM_REQUESTS)[:-1])
    save_serving_bundle(model, bundle_dir, num_points=N, num_class=NUM_CLASS)
    served = ServingModel(bundle_dir, device=device)
    kernels.reset_launches()
    answers = [served.predict(r) for r in requests]
    launches = kernels.launches()
    plain = fam_model(name, cfg, device, "torch").eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = np.concatenate([
            plain(torch.from_numpy(r).to(device))["cls"].cpu().numpy()
            for r in requests])
    got = np.concatenate(answers)
    res = {"model": served.meta["model"], "requests": list(FAM_REQUESTS),
           "launches": launches,
           "launches_expected": launch_sum((len(requests),
                                            FAM_FORWARD[name])),
           "finite": bool(np.isfinite(got).all()),
           "class_agreement": float((got.argmax(-1) == want.argmax(-1)).mean()),
           "max_logit_diff": float(np.abs(got - want).max())}
    emit(phase, what="serve", **res)
    check(res["model"] == name and res["finite"]
          and got.shape == (sum(FAM_REQUESTS), NUM_CLASS),
          f"the {name} bundle did not serve: {res}")
    check(launches == res["launches_expected"],
          f"the {name} bundle launched {launches}")
    check(res["class_agreement"] >= MIN_CLASS_AGREEMENT
          and res["max_logit_diff"] <= MAX_LOGIT_DIFF,
          f"the {name} bundle disagrees with the plain path: {res}")
    return res


def fam_eval_infer(tmp: str, tag: str, model_file: str, model: str,
                   forward: dict, seg: bool, phase: str = "families") -> dict:
    """`eval` and `infer` (`--task pointsegda` with `seg`) from
    `model_file`, through the kernels and with `--knn_backend torch`:
    classes (seg: per-point classes) agree on >= 99%, max |dprob| <= 2e-2,
    eval's accuracy equals infer's; launches exactly `forward` per eval
    forward (80 target test clouds at B=32: 3 forwards; seg: 16, 1)."""
    out = os.path.join(tmp, "runs")
    n_fwd = 1 if seg else EVAL_FORWARDS
    task = ["--task", "pointsegda"] if seg else []
    res, preds = {}, {}
    for route in ("kernels", "plain"):
        extra = [] if route == "kernels" else ["--knn_backend", "torch"]
        for cmd in ("eval", "infer"):
            exp = f"{tag}_{cmd}_{route}"
            argv = [cmd, *task, "--model", model, "--model_file", model_file,
                    "--synthetic", "True", "--out_path", out, "--exp_name",
                    exp, *extra]
            launches = run_cli(argv, os.path.join(tmp, f"{exp}.log"))
            with open(os.path.join(out, exp, "run.log")) as f:
                summary = json.loads(f.read().splitlines()[-1].split(": ",
                                                                     1)[1])
            res[f"{cmd}_{route}"] = {"launches": launches, **summary}
            if cmd == "infer":
                preds[route] = np.load(summary["output"])
    k, p = preds["kernels"], preds["plain"]
    expected = launch_sum((n_fwd, forward))
    cmp = {"rows": int(k["pred"].shape[0]),
           "class_agreement": float((k["pred"] == p["pred"]).mean()),
           "max_prob_diff": float(np.abs(k["prob"] - p["prob"]).max()),
           "finite": bool(np.isfinite(k["prob"]).all()),
           "launches_expected": expected}
    emit(phase, what=f"{tag}_eval_infer", **res, compare=cmp)
    for cmd in ("eval", "infer"):
        check(res[f"{cmd}_kernels"]["launches"] == expected,
              f"{tag} {cmd} launched {res[f'{cmd}_kernels']['launches']}, "
              f"not {expected}")
        check(not any(res[f"{cmd}_plain"]["launches"].values()),
              f"plain {tag} {cmd} launched kernels")
    shape = (16, SEG_N, SEG_NUM_CLASS) if seg else (80, NUM_CLASS)
    check(cmp["finite"] and k["prob"].shape == shape
          and np.array_equal(k["index"], p["index"]),
          f"{tag} infer's output is not finite probabilities of {shape}")
    check(cmp["class_agreement"] >= MIN_CLASS_AGREEMENT
          and cmp["max_prob_diff"] <= MAX_LOGIT_DIFF,
          f"{tag} infer through the kernels disagrees with the plain "
          f"route: {cmp}")
    for route in ("kernels", "plain"):
        check(res[f"eval_{route}"]["acc"] == res[f"infer_{route}"]["acc"],
              f"{tag} eval's accuracy differs from infer's ({route})")
    return {**res, "compare": cmp}


def fam_main_path(tmp: str, name: str, phase: str = "families") -> dict:
    """The CLI in-process at full width: `trainer --config` the family's
    YAML on the synthetic data for FAM_TRAINER_EPOCHS[name] epochs, `eval`
    and `infer --model name` from its model.ckpt on both routes, then
    `spst --model name` (1 round of 1 epoch with PCM at threshold 2.31,
    which selects every target cloud); exact launch counts throughout."""
    out = os.path.join(tmp, "runs")
    epochs = FAM_TRAINER_EPOCHS[name]
    tag = {"point_transformer": "pt", "hengshuang": "hs", "vit": "vit"}[name]
    exp = f"{tag}_trainer"
    argv = ["trainer", "--config", repo_file(FAM_CONFIGS[name]), "--synthetic",
            "True", "--epochs", str(epochs), "--out_path", out, "--exp_name",
            exp]
    fwd = FAM_FORWARD[name]
    want = launch_sum((8 * epochs, fam_step_launches(name)),
                      (4 * epochs + EVAL_FORWARDS, fwd))
    t0 = time.perf_counter()
    launches = run_cli(argv, os.path.join(tmp, f"{exp}.log"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train"] for r in records]
    model_file = os.path.join(out, exp, "model.ckpt")
    tr = {"argv": argv, "epochs": epochs, "seconds": seconds,
          "launches": launches, "launches_expected": want, "losses": losses,
          "finite": all(np.isfinite(v) for r in losses for v in r.values()),
          "epoch_seconds": [r["seconds"] for r in records],
          "val": [{k: r[k]["acc"] for k in ("src_val", "trgt_val")}
                  for r in records]}
    emit(phase, what=f"{tag}_trainer", **tr)
    check(tr["finite"] and len(records) == epochs
          and os.path.exists(model_file),
          f"the {name} trainer left {len(records)} records: {losses}")
    check(launches == want,
          f"the {name} trainer launched {launches}, not {want}")
    ei = fam_eval_infer(tmp, tag, model_file, name, fwd, False, phase)

    sp_exp = f"{tag}_spst"
    sp_argv = ["spst", "--model", name, "--synthetic", "True", "--model_file",
               model_file, "--rounds", "1", "--epochs", "1", "--threshold",
               str(SPST_THRESHOLD), "--apply_PCM", "True", "--out_path", out,
               "--exp_name", sp_exp]
    sp_want = launch_sum(
        (2 * EVAL_FORWARDS + SELECT_FORWARDS + VAL_FORWARDS + EVAL_FORWARDS
         + 2 * SPST_STEPS, fwd), (SPST_STEPS, {"fps": 1}))
    sp_launches = run_cli(sp_argv, os.path.join(tmp, f"{sp_exp}.log"))
    with open(os.path.join(out, sp_exp, "metrics.jsonl")) as f:
        sp_records = [json.loads(line) for line in f]
    with open(os.path.join(out, sp_exp, "run.log")) as f:
        sels = [ln.split("pseudo label selection: ")[1]
                for ln in f.read().splitlines()
                if "pseudo label selection: " in ln]
    sp = {"argv": sp_argv, "launches": sp_launches,
          "launches_expected": sp_want, "selections": sels,
          "losses": [r["train"] for r in sp_records],
          "epoch_seconds": [r["seconds"] for r in sp_records]}
    emit(phase, what=f"{tag}_spst", **sp)
    check(sp_launches == sp_want,
          f"{name} spst launched {sp_launches}, not {sp_want}")
    check(sels == ["256/256"] and all(
        np.isfinite(v) for m in sp["losses"] for v in m.values())
        and os.path.exists(os.path.join(out, sp_exp, "model.ckpt")),
        f"{name} spst: selections {sels}, losses {sp['losses']}")
    return {"trainer": tr, "eval_infer": ei, "spst": sp,
            "model_file": model_file}


def fam_seg_path(tmp: str) -> dict:
    """`seg --config configs/pointsegda_hengshuang.yaml --synthetic True
    --epochs 1` (B=16, N=2048, DefRec on the target: 3 steps of 2
    decoding forwards, 2 validation forwards and 1 final-test forward),
    then `eval` and `infer --task pointsegda --model hengshuang_seg` on
    both routes."""
    out = os.path.join(tmp, "runs")
    argv = ["seg", "--config", repo_file(FAM_SEG_CONFIG), "--synthetic",
            "True", "--epochs", str(FAM_SEG_EPOCHS), "--out_path", out,
            "--exp_name", "hs_seg"]
    fwd = FAM_FORWARD["hengshuang_seg"]
    want = launch_sum((3 * FAM_SEG_EPOCHS * 2 + 2 * FAM_SEG_EPOCHS + 1, fwd))
    t0 = time.perf_counter()
    launches = run_cli(argv, os.path.join(tmp, "hs_seg_trainer.log"))
    seconds = time.perf_counter() - t0
    exp = os.path.join(out, "hs_seg_adobe_faust")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    model_file = os.path.join(exp, "model.ckpt")
    tr = {"argv": argv, "seconds": seconds, "launches": launches,
          "launches_expected": want,
          "losses": [r["train"] for r in records],
          "epoch_seconds": [r["seconds"] for r in records]}
    emit("families", what="hs_seg_trainer", **tr)
    check(launches == want,
          f"the hengshuang_seg trainer launched {launches}, not {want}")
    check(len(records) == FAM_SEG_EPOCHS and os.path.exists(model_file)
          and all(np.isfinite(v) for r in tr["losses"]
                  for v in r.values() if isinstance(v, float)),
          f"the hengshuang_seg trainer left {records}")
    ei = fam_eval_infer(tmp, "hs_seg", model_file, "hengshuang_seg", fwd,
                        True)
    return {"trainer": tr, "eval_infer": ei, "model_file": model_file}


def fam_times(device, card: str, kc: dict, paths: dict,
              tag: str = "families") -> dict:
    """K1 and K4 per launch at the families' shapes beside their bounds
    (and K4's chain floor); each main path's epoch time and eval/infer
    clouds/s at its test batch on the target train split."""
    rows = {"knn": [], "fps": []}
    for r in kc["knn"]:
        x, k = r["x"], r["k"]
        b_ms, b_by = bound(*knn_cost(x, k))
        rows["knn"].append({"shape": r["shape"], "k": k,
                            "ms": median_ms(lambda: knn_cuda(x, k)),
                            "plain_ms": median_ms(
                                lambda: knn_indices_torch(x, k)),
                            "bound_ms": b_ms, "bound_by": b_by})
    for r in kc["fps"]:
        xf, npoint, start = r["x"], r["npoint"], r["start"]
        b, n = xf.shape[:2]
        b_ms, b_by = bound(*fps_cost(b, n, npoint))
        one, s1 = xf[:1].contiguous(), start[:1].contiguous()
        step = ((median_ms(lambda: fps_cuda(one, npoint, s1))
                 - median_ms(lambda: fps_cuda(one, 2, s1))) / (npoint - 2)
                if npoint > 2 else float("nan"))
        rows["fps"].append({"shape": r["shape"], "npoint": npoint,
                            "ms": median_ms(lambda: fps_cuda(xf, npoint,
                                                             start)),
                            "plain_ms": median_ms(
                                lambda: fps_torch(xf, npoint, start),
                                reps=3, warmup=1),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "chain_floor_ms": step * npoint})
    for kname, per in rows.items():
        emit("times", what=f"{tag}_{kname}", per_launch=per, card=card)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()  # returns host numpy: the device has finished
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    paths_res = {}
    for tag, (name, model_file, seg) in paths.items():
        classes = SEG_NUM_CLASS if seg else NUM_CLASS
        model = make_model(name, classes, device=device)
        checkpoint.load_model_weights(model, model_file)
        if seg:
            ds = load_pointsegda("faust", ".", "train", True, SEG_N)
            batch = SEG_TEST_B
        else:
            ds = load_pointda("scannet", ".", "train", N, True, 1,
                              device=device)
            batch = B
        x = torch.from_numpy(ds.data).to(device)
        sels, _ = eval_batches(len(ds.data), batch)
        if seg:
            t_eval = timed(lambda: evaluate_seg(model, x, ds.label, batch))
            t_infer = timed(lambda: eval_logits(model, x, sels, "seg"))
        else:
            t_eval = timed(lambda: evaluate(model, x, ds.label, batch,
                                            NUM_CLASS))
            t_infer = timed(lambda: eval_logits(model, x, sels))
        paths_res[tag] = {"model": name, "clouds": len(ds.data),
                          "batch": batch,
                          "eval_clouds_per_s": len(ds.data) / t_eval,
                          "infer_clouds_per_s": len(ds.data) / t_infer}
    emit("times", what=f"{tag}_paths", paths=paths_res, card=card)
    return {"rows": rows, "paths": paths_res}


def families(device, card: str, g: torch.Generator, tmp: str) -> dict:
    """The `families` phase (see FAM_FORWARD for the launch counts)."""
    kc = fam_kernel_checks(device, g)
    ft = fam_train(device, card)
    fst = fam_seg_train(device, card)
    with tempfile.TemporaryDirectory() as bundle_dir:
        srv = fam_serve(bundle_dir, device)
    pt = fam_main_path(tmp, "point_transformer")
    hs = fam_main_path(tmp, "hengshuang")
    seg = fam_seg_path(tmp)
    epochs = {"pt": pt["trainer"]["epoch_seconds"],
              "hs": hs["trainer"]["epoch_seconds"],
              "hs_seg": seg["trainer"]["epoch_seconds"]}
    emit("times", what="families_epochs", epoch_seconds=epochs, card=card)
    times = fam_times(device, card, kc, {
        "pt": ("point_transformer", pt["model_file"], False),
        "hs": ("hengshuang", hs["model_file"], False),
        "hs_seg": ("hengshuang_seg", seg["model_file"], True)})
    by_path = {"families_train": ft["launches"],
               "families_seg_train": fst["launches"],
               "families_serve": srv["launches"]}
    for tag, p in (("pt", pt), ("hs", hs)):
        by_path[f"{tag}_trainer"] = p["trainer"]["launches"]
        by_path[f"{tag}_eval"] = p["eval_infer"]["eval_kernels"]["launches"]
        by_path[f"{tag}_infer"] = p["eval_infer"]["infer_kernels"]["launches"]
        by_path[f"{tag}_spst"] = p["spst"]["launches"]
    by_path["hs_seg_trainer"] = seg["trainer"]["launches"]
    by_path["hs_seg_eval"] = seg["eval_infer"]["eval_kernels"]["launches"]
    by_path["hs_seg_infer"] = seg["eval_infer"]["infer_kernels"]["launches"]
    return {"kernel_checks": kc, "by_path": by_path, "times": times,
            "train": ft}


VIT_ENCODERS = ("relative", "dgcnn")
VIT_GROUPS, VIT_GROUP_SIZE, VIT_K = 64, 32, 20  # PointViT's defaults
VIT_BIG_B = 65_536 + 7  # clouds above gridDim.y's 65535


def vit_kernel_checks(device, g: torch.Generator) -> dict:
    """K1 and K4 on the inputs of a full-width eval forward of the vit
    with the "dgcnn" embedder at [32, 1024, 3]: K1 at [B·G, 32, C] = [2048,
    32, C], C in (3, 64, 128), k = 20, by sorted distance sets and, on
    integer coordinates, exact indices; K4 at [32, 1024] -> 64, index for
    index. Then K1 and K3 at VIT_BIG_B clouds of 32 points on integer
    coordinates: one launch each, indices equal to the plain version's."""
    x = torch.from_numpy(make_classification(B, N, NUM_CLASS,
                                             seed=SEED + 11)[0]).to(device)
    with kernel_calls() as calls, torch.no_grad():
        fam_model("vit", fam_cfg("vit"), device,
                  encoder_type="dgcnn").eval()(x)
    check(len(calls["knn"]) == FAM_FORWARD["vit_dgcnn"]["knn"]
          and len(calls["fps"]) == FAM_FORWARD["vit_dgcnn"]["fps"],
          f"the vit forward made {len(calls['knn'])} K1 and "
          f"{len(calls['fps'])} K4 launches")
    knn_res, fps_res = check_recorded(calls, g, device, "vit_interop")
    bg = B * VIT_GROUPS
    check({(tuple(r["shape"]), r["k"]) for r in knn_res}
          == {((bg, VIT_GROUP_SIZE, c), VIT_K) for c in (3, 64, 128)},
          f"the vit embedder built graphs at {[r['shape'] for r in knn_res]}")
    check([(r["shape"], r["npoint"]) for r in fps_res]
          == [([B, N, 3], VIT_GROUPS)],
          f"the vit grouping sampled at {fps_res}")
    xi = integer_cloud(g, (VIT_BIG_B, VIT_GROUP_SIZE, 3), device)
    want = knn_indices_torch(xi, VIT_K)
    kernels.reset_launches()
    got = knn_cuda(xi, VIT_K)
    got3 = knn_moments_cuda(xi, VIT_K, return_indices=True)[2]
    torch.cuda.synchronize()
    big = {"shape": list(xi.shape), "k": VIT_K,
           "launches": kernels.launches(),
           "knn_rows_unequal": int((got != want).any(-1).sum()),
           "knn_moments_rows_unequal": int((got3 != want).any(-1).sum())}
    emit("vit_interop", kernel="knn", what="batch_above_65535", **big)
    check(big["knn_rows_unequal"] == 0 and big["knn_moments_rows_unequal"] == 0
          and big["launches"]["knn"] == big["launches"]["knn_moments"] == 1,
          f"K1/K3 above 65535 clouds: {big}")
    return {"knn": knn_res, "fps": fps_res, "big": big}


def vit_train(device, card: str) -> dict:
    """FAM_STEPS steps of the full-width vit under configs/pointda_vit.yaml
    (PCM, DefRec on the target; B=32, N=1024) with the "relative" and the
    "dgcnn" embedders: launches exact (a forward K4 1, the "dgcnn" one also
    K1 5; PCM K4 1 a step), finite losses, p50 and peak memory; the first
    step again through the plain route on the kernel run's kNN graphs and
    FPS orders (eval-mode BN; LOSS_RTOL, GRAD_RTOL)."""
    batches = train_batches(train_cfg(), device)
    cfg = fam_cfg("vit")
    total, res = dict.fromkeys(PER_STEP, 0), {}
    for enc in VIT_ENCODERS:
        tag = "vit" if enc == "relative" else f"vit_{enc}"
        model = fam_model("vit", cfg, device, encoder_type=enc)
        init = copy.deepcopy(model.state_dict())
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH)
        gen = torch.Generator(device=device).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        steps = [pointda_train_step(model, opt, sched,
                                    *batches[i % len(batches)], gen, cfg)
                 for i in range(FAM_STEPS)]
        torch.cuda.synchronize()
        launches = kernels.launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [{k: float(v) for k, v in m.items()} for m in steps]
        per_step = fam_step_launches(tag)
        r = {"model": "vit", "encoder_type": enc,
             "recipe": {"apply_PCM": cfg.apply_PCM,
                        "DefRec_on_trgt": cfg.DefRec_on_trgt,
                        "DefRec_weight": cfg.DefRec_weight},
             "batch": cfg.batch_size, "points": cfg.num_points,
             "steps": FAM_STEPS, "launches": launches,
             "launches_derived": {k: FAM_STEPS * v
                                  for k, v in per_step.items()},
             "losses": losses,
             "finite": all(np.isfinite(v) for m in losses
                           for v in m.values()),
             "p50_ms": branch_step_time(model, opt, sched, batches, gen, cfg,
                                        FAM_TIMED),
             "steps_timed": FAM_TIMED, "peak_memory_gb": peak_gb,
             "card": card}
        c = fam_first_step("vit", cfg, batches[0], init, device,
                           encoder_type=enc)
        r["first_step_plain_vs_kernel_eval_bn"] = c
        emit("vit_interop", what="train", **r)
        check(r["finite"], f"non-finite vit ({enc}) losses: {losses}")
        check(launches == r["launches_derived"],
              f"the vit ({enc}) steps launched {launches}, not "
              f"{r['launches_derived']}")
        rep = c["replayed"]
        check(not any(c["plain_route_launches"].values()),
              f"the plain route launched kernels: {c['plain_route_launches']}")
        check((rep["graphs"], rep["fps_orders"])
              == (per_step["knn"], per_step["fps"])
              and rep["plain_own_fps_entries_differ"] == 0,
              f"vit ({enc}) first step: unexpected kNN graphs or FPS orders "
              f"{rep}")
        check(c["same_grad_set"] and not c["outside"],
              f"vit ({enc}) first step: the plain route or a kernel rerun "
              f"disagrees with the kernel route on {c['outside']}")
        for k, v in launches.items():
            total[k] += v
        res[enc] = r
    return {"train": res, "launches": total}


def interop(tmp: str, dgcnn_ckpt: str, seg_ckpt: str, device) -> dict:
    """`export` the trainer phase's DGCNN model.ckpt and the seg phase's
    DGCNNSeg one to reference model.pt files (no launch), then `eval` and
    `infer` of each model.pt with `--from_torch True` beside the same of
    its .ckpt, through the kernels: DGCNN predictions equal to the bit
    (the same tensors through the same kernels), DGCNNSeg per-point
    classes on >= 99% of points and max |dprob| <= 2e-2 (the pseudo-
    inverse of the conv pairs is exact only up to rounding); launches
    exact (DGCNN: 3 forwards of K1 5, K2-fwd 4; DGCNNSeg: 1 forward of K1
    4). Times `export` and a `--from_torch` load."""
    out = os.path.join(tmp, "runs")
    res = {}
    for tag, ckpt, task, fwd in (
            ("dgcnn", dgcnn_ckpt, [], launch_sum((EVAL_FORWARDS, {
                "knn": 5, "edge_moments": 4}))),
            ("dgcnn_seg", seg_ckpt, ["--task", "pointsegda"], SEG_FORWARD)):
        exp = f"export_{tag}"
        t0 = time.perf_counter()
        ex_launches = run_cli(["export", *task, "--model_file", ckpt,
                               "--out_path", out, "--exp_name", exp],
                              os.path.join(tmp, f"{exp}.log"))
        export_s = time.perf_counter() - t0
        pt = os.path.join(out, exp, "model.pt")
        runs, preds = {}, {}
        for src, argv in (("ckpt", ["--model_file", ckpt]),
                          ("pt", ["--model_file", pt, "--from_torch",
                                  "True"])):
            for cmd in ("eval", "infer"):
                name = f"interop_{tag}_{cmd}_{src}"
                launches = run_cli([cmd, *task, *argv, "--synthetic", "True",
                                    "--out_path", out, "--exp_name", name],
                                   os.path.join(tmp, f"{name}.log"))
                with open(os.path.join(out, name, "run.log")) as f:
                    summary = json.loads(
                        f.read().splitlines()[-1].split(": ", 1)[1])
                runs[f"{cmd}_{src}"] = {"launches": launches, **summary}
                if cmd == "infer":
                    preds[src] = np.load(summary["output"])
        model = make_model("dgcnn_seg" if task else "dgcnn",
                           SEG_NUM_CLASS if task else NUM_CLASS,
                           device=device)
        t0 = time.perf_counter()
        checkpoint.load_model_weights(model, pt, from_torch=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = preds["ckpt"], preds["pt"]
        r = {"export_seconds": export_s, "export_launches": ex_launches,
             "from_torch_load_seconds": load_s, "runs": runs,
             "launches_expected": fwd,
             "class_agreement": float((a["pred"] == b["pred"]).mean()),
             "max_prob_diff": float(np.abs(a["prob"] - b["prob"]).max()),
             "finite": bool(np.isfinite(b["prob"]).all())}
        emit("vit_interop", what=f"interop_{tag}", **r)
        check(not any(ex_launches.values()),
              f"export of {tag} launched {ex_launches}")
        for k, v in runs.items():
            check(v["launches"] == fwd,
                  f"interop {tag} {k} launched {v['launches']}, not {fwd}")
        check(r["finite"] and np.array_equal(a["index"], b["index"])
              and runs["eval_ckpt"]["acc"] == runs["infer_ckpt"]["acc"]
              and runs["eval_pt"]["acc"] == runs["infer_pt"]["acc"],
              f"interop {tag}: outputs {r}")
        if tag == "dgcnn":
            check(r["class_agreement"] == 1.0 and r["max_prob_diff"] == 0.0
                  and all(runs["eval_pt"][k] == runs["eval_ckpt"][k]
                          for k in ("acc", "balanced_acc", "loss")),
                  f"eval --from_torch of the DGCNN model.pt differs from "
                  f"eval of its .ckpt: {r}, {runs}")
        else:
            check(r["class_agreement"] >= MIN_CLASS_AGREEMENT
                  and r["max_prob_diff"] <= MAX_LOGIT_DIFF,
                  f"DGCNNSeg from model.pt disagrees with its .ckpt: {r}")
        res[tag] = r
    return res


def vit_interop(device, card: str, g: torch.Generator, tmp: str,
                dgcnn_ckpt: str, seg_ckpt: str) -> dict:
    """The `vit_interop` phase: K1 at the vit embedder's shapes and above
    65535 clouds, vit train steps with both embedders and their first
    steps on the plain route, a vit bundle, the vit main path through the
    CLI (trainer, eval, infer, spst), checkpoint interop, and the times."""
    kc = vit_kernel_checks(device, g)
    tr = vit_train(device, card)
    with tempfile.TemporaryDirectory() as bundle_dir:
        srv = fam_serve(bundle_dir, device, "vit", "vit_interop")
    path = fam_main_path(tmp, "vit", "vit_interop")
    io = interop(tmp, dgcnn_ckpt, seg_ckpt, device)
    times = fam_times(device, card, kc, {"vit": ("vit", path["model_file"],
                                                 False)}, "vit")
    emit("times", what="vit", card=card,
         epoch_seconds=path["trainer"]["epoch_seconds"],
         step_p50_ms={e: r["p50_ms"] for e, r in tr["train"].items()},
         peak_memory_gb={e: r["peak_memory_gb"]
                         for e, r in tr["train"].items()},
         export_seconds={t: r["export_seconds"] for t, r in io.items()},
         from_torch_load_seconds={t: r["from_torch_load_seconds"]
                                  for t, r in io.items()})
    by_path = {"vit_train": tr["launches"], "vit_serve": srv["launches"],
               "vit_trainer": path["trainer"]["launches"],
               "vit_eval": path["eval_infer"]["eval_kernels"]["launches"],
               "vit_infer": path["eval_infer"]["infer_kernels"]["launches"],
               "vit_spst": path["spst"]["launches"]}
    for tag, r in io.items():
        for k, v in r["runs"].items():
            if k.endswith("_pt"):
                by_path[f"interop_{tag}_{k}"] = v["launches"]
    return {"kernel_checks": kc, "by_path": by_path, "times": times}


# ---------------------------------------------------------------------------
# Slice G2: segmentation and AOT serving bundles; data-parallel training,
# native ingest and calibrate
# ---------------------------------------------------------------------------

G2_REQUESTS = (32, 32, 32)
SEG_BUNDLE_FORWARD = {"dgcnn_seg": {"knn": 4},
                      "hengshuang_seg": {"knn": 10, "fps": 4}}
INGEST_CLOUDS = 96
# The native ingest against a float64 unit cube and rotation: float32
# rounding of coordinates of at most 1.
INGEST_ATOL = 1e-6
CAL_REPS = 3 + 20  # chipcal: warm-ups + timed calls, per route and shape


def launches_times(forward: dict, n: int) -> dict:
    return {**dict.fromkeys(PER_STEP, 0),
            **{k: v * n for k, v in forward.items()}}


def prob_gap(a: np.ndarray, b: np.ndarray) -> float:
    pa, pb = (torch.softmax(torch.from_numpy(t).double(), -1) for t in (a, b))
    return float((pa - pb).abs().max())


def predict_times(predict, x, n: int = 20, warm: int = 3) -> dict:
    """Host clock around `predict(x)`, which returns host numpy (the card
    has finished): p50 and clouds/s over `n` calls after `warm`."""
    for _ in range(warm):
        predict(x)
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        predict(x)
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"batch": len(x), "samples": n, "p50_ms": statistics.median(lat),
            "clouds_per_s": len(x) * n / (sum(lat) / 1e3)}


def seg_bundles(device, tmp: str) -> dict:
    """DGCNNSeg and HengshuangSeg weights bundles (N = 2048, 8 classes) on
    the card: G2_REQUESTS of 32 clouds each, exact launches, per-point
    logits against the plain route."""
    out = {}
    clouds = make_segmentation(sum(G2_REQUESTS), SEG_N, SEG_NUM_CLASS,
                               seed=SEED + 30)[0]
    requests = np.split(clouds, np.cumsum(G2_REQUESTS)[:-1])
    for i, (name, forward) in enumerate(SEG_BUNDLE_FORWARD.items()):
        g = torch.Generator().manual_seed(SEED + 31 + i)
        model = make_model(name, SEG_NUM_CLASS, device=device, generator=g)
        randomise_batch_norm(model, g)
        bdir = os.path.join(tmp, f"bundle_{name}")
        meta = save_serving_bundle(model, bdir, num_points=SEG_N,
                                   num_class=SEG_NUM_CLASS)
        served = ServingModel(bdir, device=device)
        kernels.reset_launches()
        got = np.concatenate([served.predict(r) for r in requests])
        torch.cuda.synchronize()
        launches = kernels.launches()
        plain = make_model(name, SEG_NUM_CLASS, device=device,
                           knn_backend="torch", **model.config)
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            want = np.concatenate([plain(torch.from_numpy(r).to(device),
                                         ("seg",))["seg"].cpu().numpy()
                                   for r in requests])
        res = {"task": meta["task"], "requests": list(G2_REQUESTS),
               "shape": list(got.shape), "launches": launches,
               "launches_expected": launches_times(forward,
                                                   len(G2_REQUESTS)),
               "finite": bool(np.isfinite(got).all()),
               "class_agreement": float((got.argmax(-1)
                                         == want.argmax(-1)).mean()),
               "max_prob_diff": prob_gap(got, want)}
        emit("serving_g2", what=f"{name} bundle", **res)
        check(res["shape"] == [sum(G2_REQUESTS), SEG_N, SEG_NUM_CLASS]
              and res["finite"] and meta["task"] == "pointsegda",
              f"the {name} bundle's answers are not per-point logits")
        check(launches == res["launches_expected"],
              f"the {name} bundle launched {launches}")
        check(res["class_agreement"] >= MIN_CLASS_AGREEMENT
              and res["max_prob_diff"] <= MAX_LOGIT_DIFF,
              f"the {name} bundle disagrees with the plain route: {res}")
        out[name] = {**res, "served": served, "x": requests[0]}
    return out


def aot_bundles(device, tmp: str, dgcnn_ckpt: str, seg_ckpt: str) -> dict:
    """`aot` (the CLI, in-process) of the trainer's DGCNN and the seg
    trainer's DGCNNSeg checkpoints: the program is traced on the CPU on the
    plain route, `ServingModel` moves it to the card; its self-check, its
    answers against the weights bundle's (the kernels) and no launch."""
    out = {}
    for name, ckpt, n, nc, extra in (
            ("dgcnn", dgcnn_ckpt, N, NUM_CLASS, []),
            ("dgcnn_seg", seg_ckpt, SEG_N, SEG_NUM_CLASS,
             ["--task", "pointsegda"])):
        bdir = os.path.join(tmp, f"aot_{name}")
        log = os.path.join(tmp, f"aot_{name}.log")
        t0 = time.perf_counter()
        launches = run_cli(["aot", "--model_file", ckpt, "--output", bdir,
                            "--out_path", os.path.join(tmp, "runs"),
                            "--exp_name", f"aot_{name}", *extra], log)
        seconds = time.perf_counter() - t0
        with open(log) as f:
            summary = json.loads(f.read().splitlines()[-1].split(": ", 1)[1])
        served = ServingModel(bdir, device=device)
        model = make_model(name, nc, device=device)
        checkpoint.load_model_weights(model, ckpt)
        wdir = os.path.join(tmp, f"weights_{name}")
        save_serving_bundle(model, wdir, num_points=n, num_class=nc)
        weights = ServingModel(wdir, device=device)
        x = (make_segmentation(B, n, nc, seed=SEED + 33)[0] if nc == 8
             else make_classification(B, n, nc, seed=SEED + 33)[0])
        kernels.reset_launches()
        got = served.predict(x)
        torch.cuda.synchronize()
        aot_launches = kernels.launches()
        want = weights.predict(x)
        res = {"format": summary["format"], "task": summary["task"],
               "export_and_selfcheck_seconds": seconds,
               "selfcheck_max_diff": summary["selfcheck_max_diff"],
               "cli_launches": launches, "serving_launches": aot_launches,
               "shape": list(got.shape),
               "class_agreement_vs_weights_bundle": float(
                   (got.argmax(-1) == want.argmax(-1)).mean()),
               "max_prob_diff_vs_weights_bundle": prob_gap(got, want),
               "times": predict_times(served.predict, x),
               "weights_bundle_times": predict_times(weights.predict, x)}
        emit("serving_g2", what=f"{name} aot", **res)
        check(not any(launches.values()) and not any(aot_launches.values()),
              f"the AOT program launched kernels: {launches}, {aot_launches}")
        check(summary["format"] == "torch.export/pt2-v1"
              and res["selfcheck_max_diff"] <= MAX_LOGIT_DIFF,
              f"the {name} AOT bundle failed its self-check: {summary}")
        check(res["class_agreement_vs_weights_bundle"] >= MIN_CLASS_AGREEMENT
              and res["max_prob_diff_vs_weights_bundle"] <= MAX_LOGIT_DIFF,
              f"the {name} AOT bundle disagrees with the kernels: {res}")
        out[name] = res
    return out


def serving_g2(device, card: str, tmp: str, dgcnn_ckpt: str,
               seg_ckpt: str) -> dict:
    seg = seg_bundles(device, tmp)
    aot = aot_bundles(device, tmp, dgcnn_ckpt, seg_ckpt)
    times = {name: predict_times(r["served"].predict, r["x"])
             for name, r in seg.items()}
    emit("times", what="serving_g2", seg_bundles=times,
         aot={k: {"aot": r["times"], "weights_bundle":
                  r["weights_bundle_times"]} for k, r in aot.items()},
         card=card)
    launches = {k: sum(r["launches"][k] for r in seg.values())
                for k in PER_STEP}
    return {"launches": launches, "aot_launches": dict.fromkeys(PER_STEP, 0),
            "seg": {k: {kk: v for kk, v in r.items()
                        if kk not in ("served", "x")}
                    for k, r in seg.items()}, "aot": aot, "times": times}


def _rank_gaps(r0: dict, one: dict) -> dict:
    """A rank's step against one process's: each loss term's relative gap,
    each gradient tensor's (`grad_gaps`) and each running statistic's
    (relative L2)."""
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    return {"loss": {k: abs(r0["metrics"][k] - w) / max(abs(w), 1e-12)
                     for k, w in one["metrics"].items()},
            "grad": grad_gaps({k: torch.from_numpy(v)
                               for k, v in r0["grads"].items()},
                              {k: torch.from_numpy(v)
                               for k, v in one["grads"].items()}),
            "running": {k: rel(r0["state"][k], v)
                        for k, v in one["state"].items() if "running" in k}}


def _ddp_compare(r0: dict, r1: dict, plain: dict, batch: int,
                 train_bn: bool) -> dict:
    """Rank 0's step against one process's on the plain route replaying
    the ranks' kNN graphs and FPS orders, held to the limits of
    `ddp_gloo_step`. With train-mode BN each loss term, gradient tensor
    and running statistic has its own floor: its largest change in the
    single process under input shifts of +-PERTURB. Returns the gaps,
    the limits and what lies outside."""
    one = step_case(None, plain, merge_rank_tapes((r0, r1), batch))
    gaps = _rank_gaps(r0, one)
    base = ({"loss": LOSS_RTOL, "grad": GRAD_RTOL_TRAIN,
             "running": DDP_RUNNING_RTOL} if train_bn else
            {"loss": LOSS_RTOL, "grad": DDP_GRAD_RTOL,
             "running": DDP_RUNNING_RTOL})
    floor = {kind: dict.fromkeys(g, 0.0) for kind, g in gaps.items()}
    if train_bn:
        for d in (PERTURB, -PERTURB):
            sh = step_case(None, {**plain, "batch": {
                k: v + d if v.is_floating_point() else v
                for k, v in plain["batch"].items()}},
                merge_rank_tapes((r0, r1), batch))
            for kind, g in _rank_gaps(sh, one).items():
                for k, v in g.items():
                    floor[kind][k] = max(floor[kind][k], v)
    limit = {kind: {k: base[kind] + 3 * f for k, f in fl.items()}
             for kind, fl in floor.items()}
    outside = [(kind, k, gaps[kind][k], lim)
               for kind, lims in limit.items() for k, lim in lims.items()
               if gaps[kind][k] > lim]
    median = statistics.median(gaps["grad"].values())
    median_limit = ((GRAD_MEDIAN_TRAIN + 3 * statistics.median(
        floor["grad"].values())) if train_bn else DDP_GRAD_MEDIAN)
    if median > median_limit:
        outside.append(("grad", "median over the tensors", median,
                        median_limit))

    def nearest(kind):  # the entries closest to their limits
        ratio = {k: gaps[kind][k] / limit[kind][k] for k in gaps[kind]}
        return [{"name": k, "gap": gaps[kind][k], "limit": limit[kind][k]}
                for k in sorted(ratio, key=ratio.get)[-3:]]

    return {"one": one,
            "plain_launches": one["launches"],
            "same_grad_set": set(r0["grads"]) == set(one["grads"]),
            "loss_rel_gap": gaps["loss"],
            "grad_gap": {"max": max(gaps["grad"].values()),
                         "median": median, "median_limit": median_limit,
                         "nearest_limit": nearest("grad")},
            "running_gap": {"max": max(gaps["running"].values()),
                            "nearest_limit": nearest("running")},
            "grad_floor_shifted": {
                "median": statistics.median(floor["grad"].values()),
                "max": max(floor["grad"].values())} if train_bn else None,
            "outside_count": len(outside),
            "outside_kinds": sorted({w for w, *_ in outside}),
            "outside": [{"what": w, "name": k, "gap": g, "limit": lim}
                        for w, k, g, lim in sorted(
                            outside, key=lambda o: -o[2] / o[3])[:8]]}


def ddp_gloo_step(device, card: str) -> dict:
    """The paper-recipe step at B=32, N=1024 on 2 gloo ranks sharing the
    card (16 rows each, NCCL refuses two ranks on one device), through the
    kernels, with eval-mode and with train-mode BN, against one process's
    step on the plain route replaying the ranks' kNN graphs and FPS
    orders; float32 heads (bf16 matmuls over 16 rows and over 32 round
    apart by ~1e-3, which no rounding bound of float32 covers).
    Eval-mode BN: losses within LOSS_RTOL, gradients within DDP_GRAD_RTOL,
    their median within DDP_GRAD_MEDIAN (rounding alone). Train-mode BN,
    where the ranks' BN statistics (combined from each rank's own) and
    matmuls over half the rows round apart from the single process and
    the step amplifies it through ReLU and max-pool kinks: each loss term
    within LOSS_RTOL, each gradient tensor within GRAD_RTOL_TRAIN, their
    median within GRAD_MEDIAN_TRAIN, each running statistic within
    DDP_RUNNING_RTOL, each plus 3 times its own change in the single
    process under a +-PERTURB input shift (`_ddp_compare`), as
    tests/test_torch_port_ddp.py. The control: the same train-mode step
    with the planted fault of BN statistics over each rank's own rows
    (`testing.local_batch_norm`) must leave these limits in the gradients
    and in the running statistics. Each rank also holds every K1 graph of
    its step ([16, 1024, C], a shape no other phase gives K1) against the
    plain kNN of the same input (`Tape.knn_against_plain`), and K1 must
    give the plain version's indices on integer coordinates of each of
    those shapes."""
    cfg = dataclasses.replace(train_cfg(), head_dtype="f32")
    model = train_model(cfg, device)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    src_x, src_y, trgt_x = (t.cpu() for t in train_batches(cfg, device)[0])
    case = {"kind": "pointda", "model": "dgcnn", "num_class": NUM_CLASS,
            "kwargs": {**model_kwargs(cfg), "k": K}, "state": state,
            "cfg": cfg, "seed": SEED, "device": str(device),
            "batch": {"src_x": src_x, "src_y": src_y, "trgt_x": trgt_x}}
    cases = {"eval_bn": {**case, "cfg": dataclasses.replace(
        cfg, debug_bn_eval=True)}, "train_bn": case,
        "train_bn_local_fault": case}
    planted = [name.endswith("fault") for name in cases]
    t0 = time.perf_counter()
    r0s, r1s = run_ranks(2, step_cases, list(cases.values()), planted,
                         backend="gloo", device=str(device), timeout_s=300)
    seconds = time.perf_counter() - t0
    run = {"ranks": 2, "backend": "gloo", "batch": cfg.batch_size,
           "rows_per_rank": cfg.batch_size // 2, "points": cfg.num_points,
           "seconds_spawn_to_results": seconds}
    out = dict(run)
    launches = dict.fromkeys(PER_STEP, 0)
    knn_shapes = set()
    for (name, c), r0, r1, fault in zip(cases.items(), r0s, r1s, planted):
        plain = {**c, "cfg": dataclasses.replace(c["cfg"], knn_backend="torch"),
                 "kwargs": {**c["kwargs"], "knn_backend": "torch"}}
        res = _ddp_compare(r0, r1, plain, cfg.batch_size,
                           not c["cfg"].debug_bn_eval)
        res.pop("one")
        knn = r0["knn_against_plain"] + r1["knn_against_plain"]
        knn_shapes |= {(tuple(r["shape"]), r["k"]) for r in knn}
        res.update(launches_per_rank=[r0["launches"], r1["launches"]],
                   ranks_bit_equal=r0["metrics"] == r1["metrics"] and all(
                       np.array_equal(g, r1["grads"][k])
                       for k, g in r0["grads"].items()),
                   losses=r0["metrics"],
                   knn_vs_plain={"launches": len(knn),
                                 "shapes": sorted({str(r["shape"])
                                                   for r in knn}),
                                 "max_gap_over_tol": max(
                                     r["max_gap_over_tol"] for r in knn),
                                 "min_rows_same_indices": min(
                                     r["rows_same_indices"] for r in knn)})
        emit("ddp_ingest", what=f"2 gloo ranks on the card vs one process, "
             f"{name}", **run, **res)
        check(res["ranks_bit_equal"], f"the two ranks disagree ({name})")
        check(r0["launches"] == PER_STEP and r1["launches"] == PER_STEP,
              f"a rank's step launched {r0['launches']}, {r1['launches']}")
        check(len(knn) == 2 * PER_STEP["knn"]
              and res["knn_vs_plain"]["max_gap_over_tol"] <= 1.0,
              f"K1 on a rank disagrees with the plain kNN: "
              f"{res['knn_vs_plain']}")
        check(not any(res["plain_launches"].values()) and res["same_grad_set"],
              f"the plain route launched {res['plain_launches']} or another "
              "gradient set")
        if fault:
            check({"grad", "running"} <= set(res["outside_kinds"]),
                  "the limits do not catch BN statistics over each rank's "
                  f"own rows: {res['outside']}")
        else:
            check(not res["outside_count"],
                  f"2 ranks differ from one process ({name}): "
                  f"{res['outside']}")
            for k in PER_STEP:
                launches[k] += r0["launches"][k] + r1["launches"][k]
        out[name] = res
    g = torch.Generator().manual_seed(SEED + 50)
    for shape, k in sorted(knn_shapes):
        xi = integer_cloud(g, shape, device)
        unequal = int((knn_cuda(xi, k) != knn_indices_torch(xi, k)
                       ).any(-1).sum())
        emit("ddp_ingest", kernel="knn", input="integer coordinates at a "
             "rank's shape", shape=list(shape), k=k, rows_unequal=unequal)
        check(unequal == 0, f"K1 indices differ on integer coordinates at "
              f"a rank's shape {shape}")
    return {"launches": launches, **out}


def cli_rank(out: str, argv: list) -> int:
    """A rank of `torchrun ... chip_smoke.py --cli-rank OUT ARGV`: the CLI
    in this process, then its return code, kernel launches and process
    group into OUT (JSON)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seen = {}
    destroy = dist.destroy_process_group

    def record_then_destroy(*args, **kwargs):
        seen.update(backend=dist.get_backend(),
                    world_size=dist.get_world_size())
        return destroy(*args, **kwargs)

    kernels.reset_launches()
    with mock.patch.object(dist, "destroy_process_group",
                           record_then_destroy):
        rc = cli.main(argv)
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": kernels.launches(), **seen}, f)
    return rc


def ddp_cli(tmp: str) -> dict:
    """`torchrun --standalone --nproc_per_node 1` of the trainer CLI with
    `--mesh_data 1`: a world of one over NCCL, 2 epochs at full width,
    exact launches (those of the single-process trainer)."""
    out = os.path.join(tmp, "ddp_cli.json")
    argv = ["trainer", "--mesh_data", "1", "--paper_recipe", "True",
            "--synthetic", "True", "--epochs", str(TRAINER_EPOCHS),
            "--out_path", os.path.join(tmp, "runs"), "--exp_name", "ddp"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--cli-rank",
           out, *argv]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(done.returncode == 0,
          f"torchrun trainer --mesh_data 1 exited {done.returncode}:\n"
          f"{done.stderr[-4000:]}")
    with open(out) as f:
        rank = json.load(f)
    with open(os.path.join(tmp, "runs", "ddp", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    res = {"argv": argv, "seconds_with_startup": seconds, **rank,
           "launches_expected": trainer_launches(TRAINER_EPOCHS),
           "records": len(records),
           "epoch_seconds": [r["seconds"] for r in records],
           "finite": all(np.isfinite(v) for r in records
                         for v in r["train"].values()),
           "val": [{k: r[k]["acc"] for k in ("src_val", "trgt_val")}
                   for r in records]}
    emit("ddp_ingest", what="torchrun trainer --mesh_data 1", **res)
    check(rank.get("backend") == "nccl" and rank.get("world_size") == 1,
          f"the trainer ran on {rank}")
    check(rank["launches"] == res["launches_expected"],
          f"the data-parallel trainer launched {rank['launches']}")
    check(res["finite"] and res["records"] == TRAINER_EPOCHS,
          f"the data-parallel trainer left {res['records']} records")
    return res


def ingest(device, tmp: str) -> dict:
    """`standardize_files` over INGEST_CLOUDS seeded .npy clouds of 1,000
    to 16,384 points: the native route (C++ ingest, K4 per bucket chunk)
    against the same ingest with the plain FPS on the card (bitwise); its
    unit-cubed, rotated clouds before FPS against a float64 reference
    (within INGEST_ATOL); against the numpy route, which sums its unit
    cube in float32 (its difference reported, and the clouds whose FPS
    order flips at a near tie counted, not failed)."""
    d = os.path.join(tmp, "npy")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 40)
    files = []
    for i, n in enumerate(rng.integers(1000, FPS_LIMIT + 1, INGEST_CLOUDS)):
        pc = (make_classification(1, int(n), NUM_CLASS, seed=SEED + 41 + i
                                  )[0][0] * rng.uniform(0.5, 2.0)
              + rng.uniform(-1, 1, 3)).astype(np.float32)
        path = os.path.join(d, f"{i:03d}.npy")
        np.save(path, pc)
        files.append(path)
    kw = dict(rotate_axis="x", rotate_angle=-np.pi / 2, device=device)
    native.load()  # the g++ build is set-up
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = standardize_files(files, N, native_ingest=True, **kw)
    seconds = time.perf_counter() - t0
    launches = kernels.launches()
    t0 = time.perf_counter()
    numpy_route = standardize_files(files, N, native_ingest=False, **kw)
    numpy_seconds = time.perf_counter() - t0
    plain_fps = standardize_files(files, N, native_ingest=True,
                                  backend="torch", **kw)
    sizes = native.npy_sizes(files)
    stage_gap = numpy_stage_gap = 0.0
    c, sn = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rot_x = np.array([[1, 0, 0], [0, c, -sn], [0, sn, c]])
    for f, n in zip(files, sizes):
        nat = native.load_npy_clouds([f], int(n), rotate_axis="x",
                                     rotate_angle=-np.pi / 2)[0][0]
        x = np.load(f).astype(np.float64)
        x -= x.mean(0)
        ref = x / np.linalg.norm(x, axis=1).max() @ rot_x
        stage_gap = max(stage_gap, float(np.abs(nat - ref).max()))
        plain = pipeline_mod._rotate(pipeline_mod._unit_cube(np.load(f)),
                                     "x", -np.pi / 2)
        numpy_stage_gap = max(numpy_stage_gap,
                              float(np.abs(nat - plain).max()))
    buckets: dict[int, int] = {}
    for n in sizes:
        b = 1 << (int(n) - 1).bit_length()
        buckets[b] = buckets.get(b, 0) + 1
    differ = np.abs(got - numpy_route).max(axis=(1, 2))
    res = {"clouds": INGEST_CLOUDS, "sizes": [int(sizes.min()),
                                              int(sizes.max())],
           "buckets": {str(k): v for k, v in sorted(buckets.items())},
           "launches": launches,
           "launches_expected": {**dict.fromkeys(PER_STEP, 0), "fps": sum(
               -(-c // 64) for c in buckets.values())},
           "native_seconds": seconds, "numpy_seconds": numpy_seconds,
           "native_vs_plain_fps_bitwise": bool(np.array_equal(got,
                                                              plain_fps)),
           "stage_max_abs_diff_vs_float64": stage_gap,
           "stage_max_abs_diff_vs_numpy": numpy_stage_gap,
           "clouds_equal_to_numpy_route_within_2e-6": int(
               (differ <= 2e-6).sum()),
           "max_abs_diff_vs_numpy_route": float(differ.max()),
           "shape": list(got.shape)}
    emit("ddp_ingest", what="native ingest", **res)
    check(res["native_vs_plain_fps_bitwise"]
          and got.shape == (INGEST_CLOUDS, N, 3),
          "the native ingest's K4 route differs from its plain route")
    check(stage_gap <= INGEST_ATOL,
          f"the native ingest's unit cube is off by {stage_gap}")
    check(launches == res["launches_expected"],
          f"the native ingest launched {launches}")
    return res


def calibrate_routes(device) -> dict:
    """At each shape of chipcal.SHAPES, on the seeded inputs `calibrate`
    times (`chipcal.edge_routes`): K1's graph against the plain kNN
    (`check_knn`), and K2's route against the gather route, as
    `check_edge` and `check_edge_bwd` hold them: max and min bit-equal,
    the sums within 1e-5 of the sums of their terms' magnitudes, du
    within 1e-5 of the magnitudes of its terms (`edge_grad_magnitude`)."""
    out = {}
    for shape in chipcal.SHAPES:
        xg, u, cot, routes = chipcal.edge_routes(shape, device)
        knn = check_knn(f"calibrate {shape}", xg, phase="ddp_ingest")
        (want, want_du), (got, got_du) = (routes["moments"](),
                                          routes["fused"]())
        want, got = ([t.detach() for t in s] for s in (want, got))
        idx = knn_cuda(xg, K)
        uu = u.detach()
        torch.cuda.synchronize()
        res = {"shape": shape, "max_min_bit_equal": bool(
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))}
        scale = (edge_moments_torch(uu.abs(), idx, True)[2], want[3])
        for label, gs, ws, sc in zip(("s1", "s2"), got[2:], want[2:], scale):
            res[f"{label}_max_err_over_tol"] = float(
                ((gs - ws).abs() / (1e-5 * sc + 1e-30)).max())
        res["du_max_abs_err"] = float((got_du - want_du).abs().max())
        res["du_max_err_over_tol"] = float(
            ((got_du - want_du).abs()
             / (1e-5 * edge_grad_magnitude(uu, idx, tuple(cot)) + 1e-30)
             ).max())
        emit("ddp_ingest", what="calibrate: K2 against the gather route",
             knn_max_gap_over_tol=knn["max_gap_over_tol"], **res)
        check(res["max_min_bit_equal"]
              and max(res["s1_max_err_over_tol"], res["s2_max_err_over_tol"],
                      res["du_max_err_over_tol"]) <= 1.0,
              f"K2 disagrees with the gather route at {shape}: {res}")
        out[shape] = res
    return out


def calibrate(device, tmp: str) -> dict:
    """`calibrate --force` (the CLI, in-process): both routes' ms at each
    shape of chipcal.SHAPES; then the two routes held against each other
    on the same inputs (`calibrate_routes`)."""
    log = os.path.join(tmp, "calibrate.log")
    launches = run_cli(["calibrate", "--force"], log)
    with open(log) as f:
        records = json.load(f)
    n = len(chipcal.SHAPES)
    expected = {**dict.fromkeys(PER_STEP, 0), "knn": 2 * CAL_REPS * n,
                "edge_moments": CAL_REPS * n,
                "edge_moments_bwd": CAL_REPS * n}
    res = {"records": records, "launches": launches,
           "launches_expected": expected,
           "speedup": {k: r["moments_ms"] / r["fused_ms"]
                       for k, r in records.items()}}
    emit("ddp_ingest", what="calibrate --force", **res)
    check(set(records) == set(chipcal.SHAPES) and all(
        r["moments_ms"] > 0 and r["fused_ms"] > 0 for r in records.values()),
        f"calibrate returned {records}")
    check(launches == expected, f"calibrate launched {launches}")
    return {**res, "routes": calibrate_routes(device)}


def ddp_ingest(device, card: str, tmp: str) -> dict:
    dd = ddp_gloo_step(device, card)
    dc = ddp_cli(tmp)
    ing = ingest(device, tmp)
    cal = calibrate(device, tmp)
    emit("times", what="ddp_ingest", card=card,
         ingest_seconds={"native": ing["native_seconds"],
                         "numpy": ing["numpy_seconds"],
                         "clouds": INGEST_CLOUDS},
         ddp_cli_epoch_seconds=dc["epoch_seconds"],
         calibrate_ms=cal["records"])
    return {"by_path": {
        "ddp": {k: dd["launches"][k] + dc["launches"][k] for k in PER_STEP},
        "ingest": ing["launches"], "calibrate": cal["launches"]}}


# What each kernel entry sums over: the serving kernels (K1, K2-fwd) over
# one B=32 serving forward, the train-only kernels over one B=32 train step.
KERNELS = {
    "knn": ("mlsp_tpu_torch/csrc/knn.cu",
            "mlsp_tpu/ops/pallas/knn_pallas.py:69", "one B=32 serving forward"),
    "edge_moments": ("mlsp_tpu_torch/csrc/edge_moments.cu",
                     "mlsp_tpu/ops/pallas/edge_pallas.py:233",
                     "one B=32 serving forward"),
    "edge_moments_bwd": ("mlsp_tpu_torch/csrc/edge_moments.cu",
                         "mlsp_tpu/ops/pallas/edge_pallas.py:302",
                         "one B=32 train step (the 4 shapes, 2 forwards)"),
    "knn_moments": ("mlsp_tpu_torch/csrc/knn_moments.cu",
                    "mlsp_tpu/ops/pallas/normals_pallas.py:93",
                    "one B=32 train step (1 launch)"),
    "fps": ("mlsp_tpu_torch/csrc/fps.cu", "mlsp_tpu/ops/pallas/fps_pallas.py:59",
            "one B=32 train step (1 launch at [2B, N, 3] = [64, 1024, 3])"),
}


def run(device: torch.device, card: str) -> None:
    """Every phase after `device`; prints the `kernels` line."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, dir=str(_build.build_dir()),
         ptxas={name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "entry function" in ln or "registers" in ln
                       or "spill" in ln]
                for name, log in logs.items()})

    g = torch.Generator().manual_seed(SEED)
    model = make_model("dgcnn", NUM_CLASS, device=device, generator=g, k=K)
    randomise_batch_norm(model, g)
    x = torch.from_numpy(make_classification(B, N, NUM_CLASS, seed=SEED + 2)[0]
                         ).to(device)
    knn_in, edge_in = kernel_inputs(model, x)

    knn_checks = [check_knn(name, t) for name, t in knn_in]
    ragged = torch.randn(B, RAGGED_N, 64, generator=g).to(device)
    knn_checks.append(check_knn("ragged", ragged))
    check_knn_exact(g, device)
    # a ragged N at C = 64, and the repeated-point graph at conv1's shape
    edge_extra = [
        ("ragged", torch.randn(B, RAGGED_N, 64, generator=g).to(device),
         torch.randn(B, RAGGED_N, 64, generator=g).to(device)),
        ("conv1, one repeated point", repeated_point(B, N, device),
         edge_in[0][2])]
    edge_checks = [check_edge(name, xg, u)
                   for name, xg, u in edge_in + edge_extra]

    fps_checks = []
    for b, n in FPS_SHAPES:
        xf = torch.from_numpy(make_classification(b, n, NUM_CLASS,
                                                  seed=SEED + n)[0]).to(device)
        start = torch.randint(0, n, (b,), generator=g).to(device)
        fps_checks.append(check_fps(xf, start))
        if b == B:
            fps_checks.append(check_fps(xf, start, n // 3))
    # ties: every odd point repeats its predecessor; and integer points
    xf = torch.from_numpy(make_classification(B, N, NUM_CLASS,
                                              seed=SEED + 6)[0]).to(device)
    xf[:, 1::2] = xf[:, 0::2]
    start = torch.randint(0, N, (B,), generator=g).to(device)
    fps_checks.append(check_fps(xf, start, what="duplicated points"))
    fps_checks.append(check_fps(integer_cloud(g, (B, N, 3), device), start,
                                what="integer points"))
    fps_checks += check_fps_pipeline(g, device)
    moments_check = check_knn_moments(x)
    bwd_checks = [check_edge_bwd(name, xg, u, g) for name, xg, u in edge_in]
    # every odd point repeats its predecessor, in the graph features and in
    # u: each point's duplicate is its neighbour, so max and min are tied
    tied = [t.clone() for t in edge_in[1][1:]]
    for t in tied:
        t[:, 1::2] = t[:, 0::2]
    bwd_checks.append(check_edge_bwd("conv2, tied values", *tied, g))
    bwd_checks += [check_edge_bwd(name, xg, u, g) for name, xg, u in edge_extra]

    with tempfile.TemporaryDirectory() as bundle_dir:
        srv = serve(model, bundle_dir, device)
    tr = train(device)
    br = branches(device, card)
    dt = data(device)
    seg = seg_kernels(device, g)
    seg_tr = seg_train(device)
    with tempfile.TemporaryDirectory() as tmp:
        trn = trainer(tmp)
        ei = eval_infer(tmp, trn["model_file"])
        sp = spst(tmp, trn["model_file"], device)
        seg_trn = seg_trainer(tmp)
        seg_ei = seg_eval_infer(tmp, seg_trn["model_file"])
        fam = families(device, card, g, tmp)
        vit = vit_interop(device, card, g, tmp, trn["model_file"],
                          seg_trn["model_file"])
        g2 = serving_g2(device, card, tmp, trn["model_file"],
                        seg_trn["model_file"])
        ddp = ddp_ingest(device, card, tmp)

        kt = kernel_times(device, card, knn_in, edge_in, g)
        serving_times(srv["served"], srv["plain"], device, card)
        st = step_times(tr, device, card)
        trainer_times(trn, trn["model_file"], st["p50_ms"], device, card)
        seg_kt = seg_kernel_times(device, card, seg, g)
        seg_st = seg_step_times(seg_tr, device, card)
        seg_trainer_times(seg_trn, seg_st["p50_ms"], device, card)
        sg = scan_graph(device, card, g)

    errs = {
        "knn": max(c["max_dist_gap"]
                   for c in knn_checks + seg["knn"] + sg["knn_checks"]),
        "edge_moments": max(c["max_abs_err"] for c in edge_checks),
        "edge_moments_bwd": max(c["max_abs_err"]
                                for c in bwd_checks + sg["bwd_checks"]),
        "knn_moments": max(moments_check["max_abs_err"],
                           seg["knn_moments"]["max_abs_err"]),
        "fps": float(max(c["unequal_indices"]
                         for c in fps_checks + [seg["fps"]]
                         + fam["kernel_checks"]["fps"]
                         + vit["kernel_checks"]["fps"])),
    }
    errs["knn"] = max(errs["knn"], max(
        c["max_dist_gap"] for c in fam["kernel_checks"]["knn"]
        + vit["kernel_checks"]["knn"]))
    rows = kt["rows"]
    # (launches, per-launch row) over one train step's shapes, by kernel
    step_rows = {"knn": [(2, r) for r in rows["knn"]],
                 "edge_moments": [(2, r) for r in rows["edge_moments_train"]],
                 "edge_moments_bwd": [(2, r) for r in rows["edge_moments_bwd"]],
                 "knn_moments": [(1, rows["knn_moments"][0])],
                 "fps": [(1, rows["fps"][0])]}
    # (launches, per-launch row) over one B=16 seg train step: K1 twice at
    # each of a forward's four shapes, K3 once, K4 once
    seg_rows = seg_kt["rows"]
    seg_step_rows = {"knn": [(2, r) for r in seg_rows["knn"][:4]],
                     "knn_moments": [(1, seg_rows["knn_moments"][0])],
                     "fps": [(1, seg_rows["fps"][0])]}

    def total(weighted):
        by_ops = sum(w * r["bound_ms"] for w, r in weighted
                     if r["bound_by"] == "operations")
        by_bytes = sum(w * r["bound_ms"] for w, r in weighted
                       if r["bound_by"] == "bytes")
        return {"ms": sum(w * r["ms"] for w, r in weighted),
                "plain_ms": sum(w * r["plain_ms"] for w, r in weighted),
                "bound_ms": by_ops + by_bytes,
                "bound_by": "operations" if by_ops > by_bytes else "bytes"}

    entries = []
    for kname, (source, replaces, over) in KERNELS.items():
        main = (total([(1, r) for r in rows[kname]])
                if kname in ("knn", "edge_moments") else total(step_rows[kname]))
        by_path = {"serve": srv["launches"][kname],
                   "train": tr["launches"][kname],
                   "branches": br["launches"][kname],
                   "data": dt["launches"][kname],
                   "trainer": trn["launches"][kname],
                   "eval": ei["eval_kernels"]["launches"][kname],
                   "infer": ei["infer_kernels"]["launches"][kname],
                   "spst": sp["launches"][kname],
                   "seg_train": seg_tr["launches"][kname],
                   "seg_trainer": seg_trn["launches"][kname],
                   "seg_eval": seg_ei["seg_eval_kernels"]["launches"][kname],
                   "seg_infer": seg_ei["seg_infer_kernels"]["launches"][kname],
                   **{path: n[kname] for path, n in fam["by_path"].items()},
                   **{path: n[kname] for path, n in vit["by_path"].items()},
                   "seg_bundle": g2["launches"][kname],
                   "aot": g2["aot_launches"][kname],
                   **{path: n[kname] for path, n in ddp["by_path"].items()}}
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[kname],
            **main, "library_ms": None, "ms_over": over,
            "per_train_step": total(step_rows[kname]),
            "per_launch_at_family_shapes": fam["times"]["rows"].get(kname),
            "per_launch_at_vit_shapes": vit["times"]["rows"].get(kname),
            "per_seg_train_step": (total(seg_step_rows[kname])
                                   if kname in seg_step_rows else None),
            "check": "passed",  # a failed check exits before this line
        })
    print(json.dumps({"kernels": entries}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--cli-rank"]:  # a torchrun rank of `ddp_cli`
        return cli_rank(sys.argv[2], sys.argv[3:])
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
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)
    run(device, card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
