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
               repeated-point graph; two launches bit-equal (it sums in
               fixed point)
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
               orders, losses and gradients compared at fixed bounds, and
               twice more through the kernels: bit-equal
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
               take one epoch (its trace gives the device's busy share),
               and match `--epochs 3` run without a break: last.ckpt's
               tensors and every epoch's losses bit-equal
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
               `trainer --mesh_data 1 --paper_recipe True --scan_steps 8`
               (2 epochs, NCCL, the single-process trainer's launches, the
               train steps' inside replays of the captured mesh step,
               "step graphs: on" and "step_graphs" true in every record);
               `standardize_files` over 96 seeded .npy clouds of 1,000-16,384 points through the
               native C++ ingest (K4 per bucket chunk), bitwise against the
               same ingest with the plain FPS, its unit cube within 1e-6 of
               a float64 one, and against the numpy route (the difference,
               and the clouds whose FPS order flips at a near tie,
               reported), seconds of both; `calibrate --force` (K2
               against the gather route at chipcal.SHAPES, K1 138, K2-fwd
               69, K2-bwd 69 launches), then on its inputs K1 against the
               plain kNN and K2's statistics and du against the gather
               route's
  step_graphs  fused step dispatch (`scan_steps`): one replay of the
               captured paper step (`pointda_train_scan` on a chunk of one
               step: warm-up, restore, capture, replay) against one eager
               step from the same weights, fresh Adam and generator seed:
               the augmented clouds and every draw bit-equal, the
               generators' states equal, losses within 1e-4, gradients
               within the train-mode bounds (2e-2, median 2e-3), BN
               statistics within 1e-4, the same parameters moved and within
               2.5 lr, launches K1 10, K2-fwd 8, K2-bwd 8, K3 1, K4 1 all
               inside the graph; K1 at a forward's five inputs and on
               integer coordinates (K3 too), K2-fwd and K2-bwd at the four
               EdgeConv shapes, K3 at [32, 1024, 3] and K4 at [64, 1024,
               3] (random and integer points), each launched from inside a
               CUDA graph on fresh inputs copied into its static ones, by
               the kernel phases' checks, K2-bwd's replays bit-equal to its
               eager launches; 2 chunks of 3 replays against 6 eager steps
               (twice: bit-equal) for PointNet (PCM, DefRec) and the DGCNN
               paper recipe at their LRs, within 1e-4; the CLIs `trainer
               --scan_steps 3`
               (2 epochs: 2 chunks and 2 single steps an epoch), `seg
               --scan_steps 2` and `spst --scan_steps 2` with the exact
               launches of their eager runs, counted through the replays,
               finite losses and "step_graphs" true in every record; the
               trainer's epoch at `--scan_steps` 1 and 8, interleaved (the
               two runs at one scan_steps bit-equal, epoch-0 losses within
               5% across them), and a profiled epoch at 8 (the device's
               busy share); the scanned
               eval against the eager forwards; step p50 of replayed
               chunks of 8 against eager steps, interleaved, for the
               paper, all-branch and seg recipes, with peak memory
               allocated and reserved (the graph's pool)
  ddp_graphs   the NCCL version; in a process of its own (an NCCL world
               of one, a 600 s timeout), a chunk of 8 replays of the
               captured paper step as a rank of the world (global
               BatchNorm's, the gradient's and the loss terms' all-reduces
               inside the graph) against 8 eager mesh steps from the same
               weights and generator seed at LR 0: the last step's draws
               and the generators bit-equal, losses within 1e-4, the last
               gradients within the train-mode bounds, launches (per step
               K1 10, K2-fwd 8, K2-bwd 8, K3 1, K4 1) all inside the
               replays; the world's step p50 replayed against eager; the
               torchrun trainer's epochs against the same trainer in one
               process (same launches)
  precision_routes  the calibration record and the route "auto" resolves
               to at each layer of the default DGCNN: "fused" (K1 + K2) on
               all four, or the phase fails with the record; K1 on a bf16
               forward's five graphs (upcast) by sorted distance sets and
               on bf16 integer coordinates index-equal, K2-fwd and K2-bwd
               on its u computed in bf16, upcast; the paper step at
               `compute_dtype` bf16 as a chunk of 3 replays (per step K1
               10, K2-fwd 8, K2-bwd 8, K3 1, K4 1 inside the replays), its
               first step against the plain route on the kernel run's
               graphs and FPS order with eval-mode BN (losses 1e-2, each
               gradient's cosine >= 0.999); the trainer CLI at
               `--compute_dtype bf16 --scan_steps 8` (2 epochs: exact
               launches, the steps' inside replays, every EdgeConv layer
               on "fused" in its log) and the seg CLI at `--compute_dtype
               bf16` (exact launches); each EdgeConv route's forward and
               backward ms per layer at [32, 1024, C]; the bf16 step's
               replayed p50 and peak memory against float32's
  points_mesh  the points axis (`--mesh_points`): K1's query range
               against the whole K1's rows, index for index, at the DGCNN
               layers' [32, 1024, C] (C = 3, 64, 64, 128) and the seg
               layers' [16, 2048, C] (C = 3, 64), every rank's rows at P
               = 2 and 4, q0 = 45 with 300 rows and the last 7 rows (nq <
               k), on the forward's values, integer coordinates and a
               quarter of exact-zero points, eagerly and from a CUDA
               graph, with the ms of a rank's range, the whole launch's,
               the plain version's and the bound; then 2 gloo ranks
               sharing the card as data 1 x points 2 (NCCL refuses two
               ranks on one device): the paper step (float32 heads,
               eval- and train-mode BN) and the seg step, each against
               the same ranks' unsplit step (draws bit-equal, gathered
               graphs index-equal, losses 1e-4, gradients 1e-4) and
               against one process replaying the gathered graphs
               (`ddp_ingest`'s limits; under eval-mode BN its own K1
               graphs equal too), per rank and step K1 10 ranges, K2-fwd
               8, K2-bwd 8, K3 1, K4 1 (seg K1 8, K3 1, K4 1); one paper
               trainer epoch and one SPST round, each rank the launches
               of one process's run of the same (K1 115, K2-fwd 92,
               K2-bwd 64, K3 8, K4 8; K1 185, K2-fwd 148, K2-bwd 64, K4
               8), finite losses, epoch seconds beside one process's; a
               PointNet++ eval forward at B=32, N=1024 (ball query split,
               K4 2) within 1e-5 of one process's
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
import shutil
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
    points_step_cases,
    run_ranks,
    step_case,
    step_cases,
)
from mlsp_tpu_torch.train import (
    make_optimizer,
    pointda_train_step,
    pointsegda_train_step,
)
from mlsp_tpu_torch.train import steps as steps_mod
from mlsp_tpu_torch.train.graphs import Graphs, capture
from mlsp_tpu_torch.train.seg_steps import pointsegda_train_scan
from mlsp_tpu_torch.train.steps import pointda_train_scan
from mlsp_tpu_torch.train.pointda_trainer import (
    eval_batches,
    eval_logits,
    evaluate,
    train_pointda,
)
from mlsp_tpu_torch.train.pointsegda_trainer import evaluate_seg
from mlsp_tpu_torch.train.spst import select_pseudo_labels, train_spst
from mlsp_tpu_torch.train.state import torch_cosine_lr
from mlsp_tpu_torch.transforms.scan import draw_scan, scan_batch
from mlsp_tpu_torch.utils import checkpoint, chipcal
from mlsp_tpu_torch.utils.config import (
    PointDAConfig,
    PointSegDAConfig,
    SPSTConfig,
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
# repeat itself on identical inputs bit for bit (every kernel sums in a
# fixed order). Its change under inputs moved by ±PERTURB, which flips FPS
# and kNN choices, is printed and not checked.
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal (NaNs and the sign of zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(kind), b.view(kind))
    return torch.equal(a, b)


def check_edge_bwd(name: str, xg: torch.Tensor, u: torch.Tensor,
                   g: torch.Generator) -> dict:
    """Pass: du from K2-bwd (through the autograd function) bit-equal over
    two launches, and within 1e-5 of the summed magnitudes of its terms of
    autograd's du through the plain version, on the same graph and random
    cotangents (K2-bwd sums in fixed point, the plain version in float, in
    another order: they agree to rounding)."""
    idx = knn_cuda(xg, K)
    cots = [torch.randn(u.shape, generator=g).to(u.device) for _ in range(4)]

    def grad(fn):
        uu = u.detach().clone().requires_grad_()
        loss = sum((c * o).sum() for c, o in zip(cots, fn(uu)))
        return torch.autograd.grad(loss, uu)[0]

    got = grad(lambda uu: edge_moments(xg, uu, K, True))
    again = grad(lambda uu: edge_moments(xg, uu, K, True))
    want = grad(lambda uu: edge_moments_torch(uu, idx, True))
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * edge_grad_magnitude(u, idx, cots)
    res = {"input": name, "shape": list(u.shape),
           "bit_equal_over_launches": same_bits(got, again),
           "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / (tol + 1e-30)).max())}
    emit("edge_bwd", **res)
    check(bool((err <= tol).all()), f"K2-bwd outside tolerance on {name}: {res}")
    check(res["bit_equal_over_launches"],
          f"K2-bwd gave another du on a second launch on {name}: {res}")
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
                       compute_dtype=cfg.compute_dtype,
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
    on the kernel run's kNN graphs and FPS orders (see LOSS_RTOL). The
    kernel route's two repeats must be bit-equal to its first run."""
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
    repeat_bit_equal = all(
        r == k_loss and g.keys() == k_grad.keys()
        and all(same_bits(g[n], k_grad[n]) for n in k_grad)
        for r, g in repeats)
    if not repeat_bit_equal:
        bad.append("the repeats are not bit-equal")
    return {"bn": "train" if train_bn else "eval",
            "repeat_bit_equal": repeat_bit_equal,
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
    # K2-bwd over a paper train step: its four shapes, each twice
    bwd = rows["edge_moments_bwd"]
    per = PER_STEP["edge_moments_bwd"] / len(bwd)
    emit("times", what="edge_moments_bwd_per_train_step",
         launches_per_step=PER_STEP["edge_moments_bwd"],
         **{key: per * sum(r[key] for r in bwd)
            for key in ("ms", "bound_ms", "plain_ms")}, card=card)
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
    save = checkpoint.save_train_state

    def keep_epoch0(path, *args, **kw):  # last.ckpt after epoch 0, kept
        save(path, *args, **kw)
        if path.endswith("last.ckpt") and kw.get("epoch", args[3]) == 0:
            shutil.copy(path, path.replace("last.ckpt", "last_e0.ckpt"))

    t0 = time.perf_counter()
    with mock.patch.object(checkpoint, "save_train_state", keep_epoch0):
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

    # the same run resumed from epoch 0's last.ckpt: every tensor of its
    # last.ckpt and epoch 1's losses bit-equal to the uninterrupted run's
    resumed = os.path.join(out, "smoke_resumed")
    run_cli([*argv[:-1], "smoke_resumed", "--resume",
             os.path.join(exp, "last_e0.ckpt")],
            os.path.join(tmp, "resumed.log"))
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        resumed_losses = [json.loads(line)["train"] for line in f]
    states = []
    for path in (os.path.join(resumed, "last.ckpt"),
                 os.path.join(exp, "last.ckpt")):
        m = make_model("dgcnn", NUM_CLASS, device="cpu")
        states.append((checkpoint.load_train_state(path, m)[0],
                       m.state_dict()))
    (e_res, got), (e_whole, want) = states
    vs_whole = {"epochs": [e_res, e_whole], "tensors": len(want),
                "tensors_differ": [k for k in want
                                   if not same_bits(got[k], want[k])],
                "last_epoch_losses_equal": resumed_losses == losses[1:]}
    emit("trainer", what="resumed_vs_uninterrupted", **vs_whole)
    check(e_res == e_whole == TRAINER_EPOCHS - 1
          and not vs_whole["tensors_differ"]
          and vs_whole["last_epoch_losses_equal"],
          f"the run resumed from epoch 0 differs from the uninterrupted "
          f"one: {vs_whole}")

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
    return {**res, "resume": rres, "vs_uninterrupted": vs_whole,
            "model_file": os.path.join(exp, "model.ckpt")}


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
    graphs = Graphs()  # the eval graph is captured in the untimed call
    t_eval = timed(lambda: evaluate(model, x, ds.label, B, NUM_CLASS,
                                    graphs=graphs))
    t_infer = timed(lambda: eval_logits(model, x, sels, graphs=graphs))
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

    graphs = Graphs()  # the eval graph is captured in the untimed call
    t_eval = timed(lambda: evaluate_seg(model, x, labels, SEG_TEST_B,
                                        graphs=graphs))
    t_infer = timed(lambda: eval_logits(model, x, sels, "seg",
                                        graphs=graphs))
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
        graphs = Graphs()  # the eval graph is captured in the untimed call
        if seg:
            t_eval = timed(lambda: evaluate_seg(model, x, ds.label, batch,
                                                graphs=graphs))
            t_infer = timed(lambda: eval_logits(model, x, sels, "seg",
                                                graphs=graphs))
        else:
            t_eval = timed(lambda: evaluate(model, x, ds.label, batch,
                                            NUM_CLASS, graphs=graphs))
            t_infer = timed(lambda: eval_logits(model, x, sels,
                                                graphs=graphs))
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
                 train_bn: bool, points: int = 1) -> dict:
    """Rank 0's step against one process's on the plain route replaying
    the ranks' kNN graphs and FPS orders (on a points mesh of `points`
    ranks, their gathered rows), held to the limits of `ddp_gloo_step`.
    With train-mode BN each loss term, gradient tensor and running
    statistic has its own floor: its largest change in the single process
    under input shifts of +-PERTURB. Returns the gaps, the limits and what
    lies outside."""
    one = step_case(None, plain, merge_rank_tapes((r0, r1), batch, points))
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
                merge_rank_tapes((r0, r1), batch, points))
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
        json.dump({"rc": rc, "launches": kernels.launches(),
                   "in_graphs": kernels.launches_in_graphs(), **seen}, f)
    return rc


def ddp_cli(tmp: str) -> dict:
    """`torchrun --standalone --nproc_per_node 1` of the trainer CLI with
    `--mesh_data 1 --scan_steps GRAPH_EPOCH`: a world of one over NCCL, 2
    epochs at full width, each epoch's 8 steps one chunk of replays of the
    captured mesh step ("step graphs: on" in the log, "step_graphs" true
    in every record), exact launches (those of the single-process
    trainer), the train steps' inside the replays and the eval forwards'
    (eager under a mesh) outside."""
    out = os.path.join(tmp, "ddp_cli.json")
    argv = ["trainer", "--mesh_data", "1", "--paper_recipe", "True",
            "--synthetic", "True", "--epochs", str(TRAINER_EPOCHS),
            "--scan_steps", str(GRAPH_EPOCH),
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
    exp = os.path.join(tmp, "runs", "ddp")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        routes = [ln.split("step graphs: ", 1)[-1]
                  for ln in f.read().splitlines() if "step graphs:" in ln]
    steps = GRAPH_EPOCH * TRAINER_EPOCHS
    res = {"argv": argv, "seconds_with_startup": seconds, **rank,
           "launches_expected": trainer_launches(TRAINER_EPOCHS),
           "in_graphs_expected": {k: steps * v for k, v in PER_STEP.items()},
           "records": len(records), "route_line": routes,
           "step_graphs": [r["step_graphs"] for r in records],
           "epoch_seconds": [r["seconds"] for r in records],
           "finite": all(np.isfinite(v) for r in records
                         for v in r["train"].values()),
           "val": [{k: r[k]["acc"] for k in ("src_val", "trgt_val")}
                   for r in records]}
    emit("ddp_ingest", what="torchrun trainer --mesh_data 1", **res)
    check(rank.get("backend") == "nccl" and rank.get("world_size") == 1,
          f"the trainer ran on {rank}")
    check(rank["launches"] == res["launches_expected"]
          and rank["in_graphs"] == res["in_graphs_expected"],
          f"the data-parallel trainer launched {rank['launches']} "
          f"({rank['in_graphs']} inside graph replays)")
    check(res["finite"] and res["records"] == TRAINER_EPOCHS,
          f"the data-parallel trainer left {res['records']} records")
    check(len(routes) == 1 and routes[0].startswith("on (")
          and all(res["step_graphs"]),
          f"the NCCL world did not replay step graphs: {routes}, "
          f"{res['step_graphs']}")
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
        "ingest": ing["launches"], "calibrate": cal["launches"]},
        "cli": dc}


# ---------------------------------------------------------------------------
# The `step_graphs` phase: fused step dispatch (`scan_steps`). On the card a
# chunk of S train steps is S replays of one captured CUDA graph of the step
# (`train.graphs.StepGraph`), and the eval forward runs as a captured graph
# (`EvalGraph`). Launches made inside a replay are counted by the graph
# module (the wrappers are not called there), so the exact launch checks
# hold through the replays.
# ---------------------------------------------------------------------------

GRAPH_TRAINER_SCAN = 3  # 8 steps an epoch: 2 chunks of 3, then 2 single steps
GRAPH_SEG_SCAN = 2  # 3 seg steps an epoch: 1 chunk of 2, then 1 single step
GRAPH_SPST_SCAN = 2  # 8 SPST steps an epoch: 4 chunks of 2
GRAPH_EPOCH = 8  # scan_steps of one chunk an epoch (8 synthetic steps)
GRAPH_TIMED_EPOCHS = 3  # the interleaved trainer runs' epochs
GRAPH_CHUNKS, GRAPH_STEPS = 4, 16  # timed chunks of GRAPH_EPOCH, eager steps
# A replay against an eager step from the same state: Adam's first update
# moves each element by at most lr (1 + eps); a gradient element of
# rounding size may flip its sign, so the parameters may differ by 2 lr.
GRAPH_PARAM_SLACK = 2.5
# Chunks held to eager steps at a nonzero LR (`graph_chunks_vs_eager`): 2
# chunks of 3, one an epoch, for PointNet under PCM (K4) and DefRec and for
# the DGCNN paper recipe. Two eager runs of the same steps must be
# bit-equal (every kernel sums in a fixed order), and a chunk's replays
# must take the eager steps' updates within LOSS_RTOL (whether bit for bit
# is reported).
GRAPH_CHUNK_CHECK = 3
# The paper trainer's epoch-0 mean losses, scan_steps 1 against 3 and 8,
# within 5%: before K2-bwd summed in a fixed order even two eager runs
# parted by ~1.4% there (on an H100 80GB HBM3 at 700 W, totals 8.260 and
# 8.324 at scan_steps 1, 8.279 and 8.379 at 3), rounding gaps flipping
# near-tied kNN choices in feature space. Two runs at one scan_steps must
# be bit-equal; whether the scan_steps agree bit for bit is reported.
EPOCH0_LOSS_RTOL = 5e-2


class Graphed:
    """`fn` launched from inside a CUDA graph: one graph per signature of
    the arguments, captured on static copies (`train.graphs.capture`:
    warm-up, capture, launch counts put back); each call copies the tensor
    arguments in, replays and returns copies of the outputs. The replays
    add no launches: they compare kernels with their plain versions."""

    def __init__(self, fn):
        self.fn, self.graphs, self.replays = fn, {}, 0

    def __call__(self, *args, **kwargs):
        key = tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a
                    for a in args) + tuple(sorted(kwargs.items()))
        if key not in self.graphs:
            static = [a.clone() if torch.is_tensor(a) else a for a in args]
            device = next(a.device for a in static if torch.is_tensor(a))
            graph, out, _ = capture(lambda: self.fn(*static, **kwargs),
                                    device)
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for buf, a in zip(static, args):
            if torch.is_tensor(a):
                buf.copy_(a)
        graph.replay()
        self.replays += 1
        if isinstance(out, tuple):
            return tuple(o.clone() for o in out)
        return out.clone()


def graph_vs_eager(device) -> dict:
    """One replay of the paper step's graph (`pointda_train_scan` on a
    chunk of one step: warm-up, restore, capture, replay) against one
    eager step, each from the same seeded weights, a fresh optimizer and
    the same generator seed. The augmented clouds and every draw of the
    step must be bit-equal and the generators must end in the same state;
    losses within LOSS_RTOL, gradients within the train-mode bounds, BN
    running statistics within DDP_RUNNING_RTOL, the parameters that move
    the same and within GRAPH_PARAM_SLACK x lr."""
    cfg = train_cfg()
    batch = train_batches(cfg, device)[0]
    runs = {}
    for route in ("graph", "eager"):
        model = train_model(cfg, device)
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH)
        gen = torch.Generator(device=device).manual_seed(SEED)
        before = {n: t.detach().clone()
                  for n, t in model.state_dict().items()}
        seen = {}

        def recorded(name, fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                seen.setdefault(name, []).append(out)
                return out
            return call

        kernels.reset_launches()
        with mock.patch.object(steps_mod, "augment_batch", recorded(
                "augmented", steps_mod.augment_batch)), \
                mock.patch.object(steps_mod, "draw_step", recorded(
                    "draws", steps_mod.draw_step)):
            if route == "graph":
                m = {k: v[0] for k, v in pointda_train_scan(
                    model, opt, sched, *(t[None] for t in batch), gen,
                    cfg).items()}
            else:
                m = pointda_train_step(model, opt, sched, *batch, gen, cfg)
        torch.cuda.synchronize()
        # the last step's: the graph's capture (its tensors hold what the
        # replay wrote), or the eager step
        draws = {**dict(zip(("src", "trgt"), seen["augmented"][-2:])),
                 **seen["draws"][-1]}
        runs[route] = {
            "losses": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "after": {n: t.detach().clone()
                      for n, t in model.state_dict().items()},
            "before": before, "draws": {k: v.clone() for k, v in draws.items()},
            "gen": gen.get_state(), "launches": kernels.launches(),
            "in_graphs": kernels.launches_in_graphs(),
            "lr": float(opt.param_groups[0]["lr"]),
            "sched_steps": sched.last_epoch}
    g, e = runs["graph"], runs["eager"]
    loss_gap = {k: abs(g["losses"][k] - w) / max(abs(w), 1e-12)
                for k, w in e["losses"].items()}
    grad_gap = grad_gaps(g["grads"], e["grads"])
    moved = {r: {n for n, t in runs[r]["after"].items()
                 if "running" not in n and "num_batches" not in n
                 and not torch.equal(t, runs[r]["before"][n])}
             for r in runs}
    param_gap = max(float((g["after"][n] - e["after"][n]).abs().max())
                    for n in moved["eager"] | moved["graph"])
    running = {n: float((g["after"][n] - e["after"][n]).norm()
                        / max(float(e["after"][n].norm()), 1e-30))
               for n in e["after"] if "running" in n}
    res = {
        "config": "PointDAConfig().paper_recipe", "batch": cfg.batch_size,
        "draws_bit_equal": {k: bool(torch.equal(g["draws"][k],
                                                e["draws"][k]))
                            for k in e["draws"]},
        "generator_state_equal": bool(torch.equal(g["gen"], e["gen"])),
        "loss_rel_gap": loss_gap, "losses_graph": g["losses"],
        "losses_eager": e["losses"],
        "grad_gap": {"max": max(grad_gap.values()),
                     "median": statistics.median(grad_gap.values()),
                     "worst": max(grad_gap, key=grad_gap.get)},
        "same_grad_set": set(g["grads"]) == set(e["grads"]),
        "params_moved": len(moved["eager"]),
        "same_params_moved": moved["graph"] == moved["eager"],
        "param_max_abs_gap": param_gap, "param_slack": GRAPH_PARAM_SLACK * cfg.lr,
        "running_rel_gap_max": max(running.values()),
        "lr_and_schedule_equal": (g["lr"], g["sched_steps"])
        == (e["lr"], e["sched_steps"]),
        "launches_graph": g["launches"], "launches_in_graph": g["in_graphs"],
        "launches_eager": e["launches"]}
    emit("step_graphs", what="replay_vs_eager", **res)
    check(all(res["draws_bit_equal"].values())
          and res["generator_state_equal"],
          f"a replay draws other numbers than the eager step: {res}")
    check(max(loss_gap.values()) <= LOSS_RTOL, f"losses differ: {loss_gap}")
    check(res["same_grad_set"] and res["grad_gap"]["max"] <= GRAD_RTOL_TRAIN
          and res["grad_gap"]["median"] <= GRAD_MEDIAN_TRAIN,
          f"gradients differ: {res['grad_gap']}")
    check(res["same_params_moved"] and param_gap <= res["param_slack"]
          and res["running_rel_gap_max"] <= DDP_RUNNING_RTOL
          and res["lr_and_schedule_equal"],
          f"the replay's update differs from the eager step's: {res}")
    check(g["launches"] == PER_STEP and g["in_graphs"] == PER_STEP
          and e["launches"] == PER_STEP,
          f"launches: graph {g['launches']} (in the graph "
          f"{g['in_graphs']}), eager {e['launches']}")
    return res


def chunk_cfg() -> PointDAConfig:
    """The recipe of the chunk checks: PointNet, PCM and DefRec on the
    target (see GRAPH_CHUNK_CHECK)."""
    return dataclasses.replace(PointDAConfig(model="pointnet").resolved(),
                               DefRec_on_trgt=True)


def train_state(model, opt, sched, gen) -> dict:
    """A train run's state: weights, BN statistics, the optimizer's
    state tensors, its LR, the schedule's count, the generator."""
    state = {f"model.{k}": v for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        state.update({f"opt.{i}.{k}": v for k, v in st.items()
                      if torch.is_tensor(v)})
    return {**state, "lr": torch.as_tensor(opt.param_groups[0]["lr"]).cpu(),
            "sched": torch.tensor(sched.last_epoch), "gen": gen.get_state()}


def chunk_models(device) -> dict:
    """The chunk checks' recipes (`graph_chunks_vs_eager`): name ->
    (config, model builder, K4 and K1 launches a step)."""
    return {"pointnet": (chunk_cfg(), lambda cfg: make_model(
                "pointnet", cfg.num_class, device=device,
                generator=torch.Generator().manual_seed(SEED + 4),
                dropout=cfg.dropout).train(), {"fps": 1, "knn": 0}),
            "dgcnn_paper": (train_cfg(), lambda cfg: train_model(cfg, device),
                            {"fps": PER_STEP["fps"],
                             "knn": PER_STEP["knn"]})}


def graph_chunks_vs_eager(device) -> dict:
    """For PointNet under PCM and DefRec (`chunk_cfg`) and the DGCNN paper
    recipe: two chunks of GRAPH_CHUNK_CHECK replays of the step graph, one
    an epoch of the cosine (the LR halves between them), against as many
    eager steps from the same weights and generator seed, twice, Adam at
    the recipe's LR, B=32, N=1024. The two eager runs bit-equal (losses
    and every weight, BN statistic, Adam moment and step count); the
    replays' losses within LOSS_RTOL of the eager steps', every state
    tensor within LOSS_RTOL of the tensor's largest magnitude; the LR, the
    schedule's count and the generator equal; K4's and K1's launches
    counted through the replays. Whether the replays are bit-equal to the
    eager steps is reported."""
    S = GRAPH_CHUNK_CHECK
    out = {}
    for name, (cfg, build, per_step) in chunk_models(device).items():
        clouds, labels = make_classification(2 * S * cfg.batch_size,
                                             cfg.num_points, cfg.num_class,
                                             seed=SEED + 13)
        x = torch.from_numpy(clouds).to(device).view(
            2 * S, cfg.batch_size, cfg.num_points, 3)
        y = torch.from_numpy(labels).to(device).view(2 * S, cfg.batch_size)
        runs = {}
        for route in ("graph", "eager", "eager_again"):
            model = build(cfg)
            opt, sched = make_optimizer(model, cfg.lr, cfg.wd, 2, S)
            gen = torch.Generator(device=device).manual_seed(SEED)
            kernels.reset_launches()
            if route == "graph":
                graphs = Graphs()
                chunks = [pointda_train_scan(model, opt, sched, x[c:c + S],
                                             y[c:c + S], x[c:c + S].flip(1),
                                             gen, cfg, graphs)
                          for c in (0, S)]
                m = {k: torch.cat([o[k] for o in chunks]) for k in chunks[0]}
            else:
                steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                            x[i].flip(0), gen, cfg)
                         for i in range(2 * S)]
                m = {k: torch.stack([o[k] for o in steps]) for k in steps[0]}
            torch.cuda.synchronize()
            runs[route] = {"losses": m,
                           "state": train_state(model, opt, sched, gen),
                           "launches": kernels.launches(),
                           "in_graphs": kernels.launches_in_graphs()}
            del model, opt, sched
        g, e, e2 = runs["graph"], runs["eager"], runs["eager_again"]

        def bit_equal(a, b):
            return (a["state"].keys() == b["state"].keys()
                    and all(same_bits(a["losses"][k], v)
                            for k, v in b["losses"].items())
                    and all(same_bits(a["state"][k], v)
                            for k, v in b["state"].items()))

        loss_gap = max(float(((g["losses"][k] - w).abs()
                              / w.abs().clamp_min(1e-12)).max())
                       for k, w in e["losses"].items())
        state_gap = {k: float((g["state"][k].double() - v.double()).abs()
                              .max() / max(float(v.double().abs().max()),
                                           1e-30))
                     for k, v in e["state"].items()
                     if k not in ("lr", "sched", "gen")}
        exact = ("lr", "sched", "gen")
        res = {"config": {"pointnet": "pointnet, PCM + DefRec_on_trgt, ADAM",
                          "dgcnn_paper": "dgcnn, paper recipe, ADAM"}[name],
               "chunks": 2, "chunk": S, "batch": cfg.batch_size,
               "points": cfg.num_points, "lr": cfg.lr,
               "eager_runs_bit_equal": bit_equal(e, e2),
               "loss_rel_gap_max": loss_gap,
               "state_rel_gap_max": max(state_gap.values()),
               "state_worst": max(state_gap, key=state_gap.get),
               "state_tensors": len(state_gap),
               "same_state_keys": g["state"].keys() == e["state"].keys(),
               "lr_schedule_generator_equal": all(
                   torch.equal(g["state"][k], e["state"][k]) for k in exact),
               "bit_equal": bit_equal(g, e),
               "lr_end": float(e["state"]["lr"]),
               "sched_steps": int(e["state"]["sched"]),
               "launches_graph": g["launches"],
               "launches_in_graphs": g["in_graphs"],
               "launches_eager": e["launches"]}
        emit("step_graphs", what=f"chunks_vs_eager {name}", **res)
        check(res["eager_runs_bit_equal"],
              f"two eager runs of the same steps differ ({name}): {res}")
        check(res["same_state_keys"] and res["lr_schedule_generator_equal"]
              and res["sched_steps"] == 2 * S and loss_gap <= LOSS_RTOL
              and res["state_rel_gap_max"] <= LOSS_RTOL,
              f"chunks of replays part from the eager steps ({name}): {res}")
        for kname, n in per_step.items():
            check(g["launches"][kname] == e["launches"][kname]
                  == g["in_graphs"][kname] == 2 * S * n,
                  f"{kname} launches through the chunks ({name}): {res}")
        out[name] = res
    return out


def graph_kernels(device, g: torch.Generator) -> dict:
    """Each kernel launched from inside a CUDA graph (`Graphed`, in place
    of every wrapper the checks and the ops reach), fresh seeded inputs
    copied into its static inputs, held against its plain version by the
    checks of the kernel phases: K1 at a B=32 forward's five inputs (C = 3,
    3, 64, 64, 128) and on integer coordinates (K3 too), K2-fwd and K2-bwd
    at the four EdgeConv shapes, K3 at [32, 1024, 3], K4 at PCM's
    [64, 1024, 3] on random and on integer points."""
    wrap = {name: Graphed(fn) for name, fn in (
        ("knn_cuda", knn_cuda), ("edge_moments_cuda", edge_moments_cuda),
        ("edge_moments_bwd_cuda", edge_moments_bwd_cuda),
        ("knn_moments_cuda", knn_moments_cuda), ("fps_cuda", fps_cuda))}
    model = make_model("dgcnn", NUM_CLASS, device=device, generator=g, k=K)
    randomise_batch_norm(model, g)
    x = torch.from_numpy(make_classification(B, N, NUM_CLASS,
                                             seed=SEED + 11)[0]).to(device)
    knn_in, edge_in = kernel_inputs(model, x)
    edge_mod = importlib.import_module("mlsp_tpu_torch.ops.edge")
    normals_mod = importlib.import_module("mlsp_tpu_torch.ops.normals")
    targets = [(sys.modules[__name__], n) for n in wrap] + [
        (_knn_mod, "knn_cuda"), (edge_mod, "edge_moments_cuda"),
        (edge_mod, "edge_moments_bwd_cuda"), (normals_mod, "knn_moments_cuda"),
        (_fps_mod, "fps_cuda")]
    with contextlib.ExitStack() as stack:
        for mod, name in targets:
            stack.enter_context(mock.patch.object(mod, name, wrap[name]))
        res = {"knn": [check_knn(f"graph {n}", t, phase="step_graphs")
                       for n, t in knn_in]}
        check_knn_exact(g, device)
        res["edge"] = [check_edge(f"graph {n}", xg, u)
                       for n, xg, u in edge_in]
        # capture K2-bwd's graphs here, not inside autograd's backward
        for _, xg, u in edge_in:
            idx = knn_cuda(xg, K)
            mx, mn = edge_moments_cuda(u, idx, False)
            wrap["edge_moments_bwd_cuda"](u, idx, mx, mn, *[u] * 4)
        res["edge_bwd"] = [check_edge_bwd(f"graph {n}", xg, u, g)
                           for n, xg, u in edge_in]
        # K2-bwd replayed against an eager launch on the same inputs
        bwd = wrap["edge_moments_bwd_cuda"]
        res["edge_bwd_replay_equals_eager"] = []
        for _, xg, u in edge_in:
            idx = knn_cuda(xg, K)
            mx, mn = edge_moments_cuda(u, idx, False)
            cots = [torch.randn(u.shape, generator=g).to(device)
                    for _ in range(4)]
            res["edge_bwd_replay_equals_eager"].append(same_bits(
                bwd(u, idx, mx, mn, *cots), bwd.fn(u, idx, mx, mn, *cots)))
        check(all(res["edge_bwd_replay_equals_eager"]),
              f"K2-bwd replayed differs from K2-bwd launched eagerly: "
              f"{res['edge_bwd_replay_equals_eager']}")
        res["knn_moments"] = check_knn_moments(x, phase="step_graphs")
        xf = torch.from_numpy(make_classification(2 * B, N, NUM_CLASS,
                                                  seed=SEED + 12)[0]).to(device)
        start = torch.randint(0, N, (2 * B,), generator=g).to(device)
        res["fps"] = [check_fps(xf, start, phase="step_graphs"),
                      check_fps(integer_cloud(g, (2 * B, N, 3), device),
                                start, what="integer points",
                                phase="step_graphs")]
    res["replays"] = {n: w.replays for n, w in wrap.items()}
    res["graphs"] = {n: len(w.graphs) for n, w in wrap.items()}
    emit("step_graphs", what="kernels_in_graphs", replays=res["replays"],
         graphs=res["graphs"])
    check(all(res["replays"].values()),
          f"a kernel was not replayed from a graph: {res['replays']}")
    return res


def graph_cli(tmp: str, argv: list, name: str) -> dict:
    """A CLI run in-process; its launches, those inside graph replays, its
    metrics.jsonl records and log."""
    launches = run_cli(argv, os.path.join(tmp, f"{name}.log"))
    in_graphs = kernels.launches_in_graphs()
    exp = os.path.join(argv[argv.index("--out_path") + 1],
                       argv[argv.index("--exp_name") + 1])
    if argv[0] == "seg":
        exp += "_adobe_faust"
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(exp, "run.log")) as f:
        log = f.read()
    return {"launches": launches, "in_graphs": in_graphs,
            "records": records, "log": log, "exp": exp}


def graph_trainers(tmp: str, model_file: str) -> dict:
    """The trainer CLI with scan_steps GRAPH_TRAINER_SCAN (2 epochs: 2
    chunks and 2 single steps an epoch), the seg CLI with GRAPH_SEG_SCAN
    and the SPST CLI with GRAPH_SPST_SCAN: exact launches through the
    replays, finite losses, "step_graphs" true in every record; then the
    trainer's epoch wall time with scan_steps 1 and GRAPH_EPOCH,
    interleaved, and a profiled run."""
    out = os.path.join(tmp, "graph_runs")
    common = ["--synthetic", "True", "--out_path", out]
    runs = {}
    runs["trainer"] = graph_cli(tmp, [
        "trainer", "--paper_recipe", "True", "--epochs",
        str(TRAINER_EPOCHS), "--scan_steps", str(GRAPH_TRAINER_SCAN),
        "--exp_name", "graph_trainer", *common], "graph_trainer")
    runs["seg"] = graph_cli(tmp, [
        "seg", "--config", repo_file(SEG_CONFIG), "--apply_PCM", "True",
        "--epochs", str(SEG_TRAINER_EPOCHS), "--scan_steps",
        str(GRAPH_SEG_SCAN), "--exp_name", "graph_seg", *common], "graph_seg")
    runs["spst"] = graph_cli(tmp, [
        "spst", "--model_file", model_file, "--rounds", str(SPST_ROUNDS),
        "--epochs", "1", "--threshold", str(SPST_THRESHOLD), "--apply_PCM",
        "True", "--scan_steps", str(GRAPH_SPST_SCAN), "--exp_name",
        "graph_spst", *common], "graph_spst")
    expected = {"trainer": trainer_launches(TRAINER_EPOCHS),
                "seg": seg_trainer_launches(SEG_TRAINER_EPOCHS),
                "spst": spst_launches(SPST_ROUNDS)}
    res = {}
    for name, r in runs.items():
        losses = [rec["train"] for rec in r["records"]]
        res[name] = {"launches": r["launches"],
                     "launches_expected": expected[name],
                     "launches_in_graphs": r["in_graphs"],
                     "step_graphs": [rec["step_graphs"]
                                     for rec in r["records"]],
                     "losses": losses,
                     "finite": all(np.isfinite(v) for m in losses
                                   for v in m.values()),
                     "epoch_seconds": [rec["seconds"]
                                       for rec in r["records"]],
                     "route_line": [ln.split(": ", 1)[-1]
                                    for ln in r["log"].splitlines()
                                    if "step graphs:" in ln]}
        emit("step_graphs", what=f"{name}_cli", **res[name])
        check(r["launches"] == expected[name],
              f"{name} with step graphs launched {r['launches']}, not "
              f"{expected[name]}")
        check(res[name]["finite"] and all(res[name]["step_graphs"])
              and r["in_graphs"]["knn"] > 0,
              f"{name} with step graphs: {res[name]}")

    # the trainer's chunks and single steps against its eager steps, on the
    # recipe whose steps are reproducible (`chunk_cfg`): 2 epochs
    pn = {S: graph_cli(tmp, [
        "trainer", "--model", "pointnet", "--DefRec_on_trgt", "True",
        "--epochs", "2", "--scan_steps", str(S), "--exp_name",
        f"graph_pointnet_{S}", *common], f"graph_pointnet_{S}")["records"]
        for S in (GRAPH_TRAINER_SCAN, 1)}
    pn_losses = {S: [rec["train"] for rec in recs] for S, recs in pn.items()}
    gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for a, b in zip(*pn_losses.values()) for k in b)
    res["pointnet_cli"] = {"losses": pn_losses, "loss_rel_gap_max": gap,
                           "step_graphs": [rec["step_graphs"]
                                           for rec in pn[GRAPH_TRAINER_SCAN]]}
    emit("step_graphs", what="pointnet_cli_scan_vs_eager",
         **res["pointnet_cli"])
    check(len(pn_losses[1]) == 2 and gap <= LOSS_RTOL
          and all(res["pointnet_cli"]["step_graphs"]),
          f"the trainer's chunks part from its eager steps: "
          f"{res['pointnet_cli']}")

    # epoch wall time: scan_steps 1 (eager) against GRAPH_EPOCH (the epoch
    # as one chunk), interleaved
    times = {1: [], GRAPH_EPOCH: []}
    epoch0 = {f"scan_steps_{GRAPH_TRAINER_SCAN}":
              runs["trainer"]["records"][0]["train"]["total"]}
    train_losses = {}
    for i, S in enumerate((1, GRAPH_EPOCH, GRAPH_EPOCH, 1)):
        r = graph_cli(tmp, [
            "trainer", "--paper_recipe", "True", "--epochs",
            str(GRAPH_TIMED_EPOCHS), "--scan_steps", str(S), "--exp_name",
            f"graph_timed_{i}", *common], f"graph_timed_{i}")
        times[S] += [rec["seconds"] for rec in r["records"][1:]]
        epoch0[f"scan_steps_{S}_run_{i}"] = r["records"][0]["train"]["total"]
        train_losses[i] = [rec["train"] for rec in r["records"]]
    spread = (max(epoch0.values()) - min(epoch0.values())) / min(
        abs(v) for v in epoch0.values())
    # two runs at one scan_steps: every epoch's mean losses bit-equal (JSON
    # floats round-trip their bits)
    same_runs = {f"scan_steps_{S}": train_losses[a] == train_losses[b]
                 for S, (a, b) in ((1, (0, 3)), (GRAPH_EPOCH, (1, 2)))}
    res["epoch0_total"] = {"totals": epoch0, "spread": spread,
                           "bound": EPOCH0_LOSS_RTOL,
                           "runs_at_one_scan_steps_bit_equal": same_runs,
                           "scan_steps_1_and_8_bit_equal":
                               train_losses[0] == train_losses[1]}
    emit("step_graphs", what="trainer_epoch0_losses", **res["epoch0_total"])
    check(spread <= EPOCH0_LOSS_RTOL,
          f"the paper trainer's epoch-0 losses part by scan_steps: "
          f"{res['epoch0_total']}")
    check(all(same_runs.values()),
          f"two paper trainer runs at one scan_steps part: "
          f"{res['epoch0_total']}, {train_losses}")
    trace_dir = os.path.join(tmp, "graph_trace")
    r = graph_cli(tmp, ["trainer", "--paper_recipe", "True", "--epochs", "2",
                        "--scan_steps", str(GRAPH_EPOCH), "--exp_name",
                        "graph_profiled", "--profile_dir", trace_dir, *common],
                  "graph_profiled")
    busy = busy_share(os.path.join(trace_dir, "trace.json"), "mlsp/epoch 1")
    res["epochs"] = {
        f"scan_steps_{S}": {
            "epoch_s_median": statistics.median(t["epoch"] for t in ts),
            "train_s_median": statistics.median(t["train"] for t in ts),
            "epochs": len(ts)} for S, ts in times.items()}
    res["profiled"] = {"scan_steps": GRAPH_EPOCH, "epoch": 1, **busy,
                       "seconds": r["records"][-1]["seconds"]}
    emit("step_graphs", what="trainer_epochs", epochs=res["epochs"],
         profiled=res["profiled"])
    return res


def graph_eval(device, model_file: str) -> dict:
    """The scanned eval (`eval_logits` through `scan_in_chunks` of
    `eval_scan`: a captured eval forward) against the eager forward loop
    on the same model and batches."""
    model = make_model("dgcnn", NUM_CLASS, device=device)
    checkpoint.load_model_weights(model, model_file)
    ds = load_pointda("scannet", ".", "train", N, True, 1, device=device)
    x = torch.from_numpy(ds.data).to(device)
    sels, _ = eval_batches(len(ds), B)
    kernels.reset_launches()
    got = eval_logits(model, x, sels, graphs=Graphs())
    launches, in_graphs = kernels.launches(), kernels.launches_in_graphs()
    with torch.inference_mode():
        want = torch.stack([model(x[torch.from_numpy(s).to(device)])["cls"]
                            for s in sels]).float().cpu().numpy()
    res = {"batches": len(sels), "max_abs_diff": float(np.abs(got - want).max()),
           "class_agreement": float((got.argmax(-1) == want.argmax(-1)).mean()),
           "launches": launches, "launches_in_graphs": in_graphs}
    emit("step_graphs", what="eval_scan", **res)
    check(res["class_agreement"] >= MIN_CLASS_AGREEMENT
          and res["max_abs_diff"] <= MAX_LOGIT_DIFF
          and in_graphs["knn"] == 5 * len(sels) == launches["knn"],
          f"the scanned eval disagrees with the eager forwards: {res}")
    return res


def graph_step_times(device, card: str) -> dict:
    """Step wall time (host clock, ending in a synchronize) of chunks of
    GRAPH_EPOCH replays against eager steps, interleaved, for the paper,
    all-branch and seg recipes; peak memory allocated and reserved, after
    the graph's capture and replays and again after the eager steps
    beside it (reserved counts the graph's private pool)."""
    pcfg = train_cfg()
    recipes = {"paper": (pcfg, pointda_train_scan, pointda_train_step,
                         train_model),
               "all_branch": (dataclasses.replace(pcfg, **ALL_BRANCHES),
                              pointda_train_scan, pointda_train_step,
                              train_model),
               "seg": (seg_cfg(), pointsegda_train_scan,
                       pointsegda_train_step, seg_model)}
    res = {}
    for name, (cfg, scan, step, build) in recipes.items():
        model = build(cfg, device)
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH)
        gen = torch.Generator(device=device).manual_seed(SEED)
        batches = (seg_batches(cfg, device) if name == "seg"
                   else train_batches(cfg, device))
        chunk = [torch.stack([batches[i % len(batches)][j]
                              for i in range(GRAPH_EPOCH)]) for j in range(3)]
        graphs = Graphs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scan(model, opt, sched, *chunk, gen, cfg, graphs)  # capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        ms = {"graph": [], "eager": []}
        # allocated: live tensors; reserved: the caching allocator's
        # memory, the graph's private pool included
        peak = {"graph_allocated": torch.cuda.max_memory_allocated() / 1e9,
                "graph_reserved": torch.cuda.max_memory_reserved() / 1e9}
        for _ in range(2):
            for _ in range(GRAPH_CHUNKS // 2):
                t0 = time.perf_counter()
                scan(model, opt, sched, *chunk, gen, cfg, graphs)
                torch.cuda.synchronize()
                ms["graph"].append((time.perf_counter() - t0) * 1e3
                                   / GRAPH_EPOCH)
            for i in range(GRAPH_STEPS // 2):
                t0 = time.perf_counter()
                step(model, opt, sched, *batches[i % len(batches)], gen, cfg)
                torch.cuda.synchronize()
                ms["eager"].append((time.perf_counter() - t0) * 1e3)
        peak["with_eager_allocated"] = torch.cuda.max_memory_allocated() / 1e9
        peak["with_eager_reserved"] = torch.cuda.max_memory_reserved() / 1e9
        res[name] = {"batch": cfg.batch_size, "points": cfg.num_points,
                     "graph_step_p50_ms": statistics.median(ms["graph"]),
                     "eager_step_p50_ms": statistics.median(ms["eager"]),
                     "speedup": statistics.median(ms["eager"])
                     / statistics.median(ms["graph"]),
                     "graph_ms": ms["graph"], "eager_ms": ms["eager"],
                     "capture_s": capture_s, "peak_memory_gb": peak,
                     "card": card}
        emit("times", what=f"step_graphs_{name}", **res[name])
        del model, opt, sched, graphs
        torch.cuda.empty_cache()
    return res


def step_graphs(device, card: str, g: torch.Generator, tmp: str,
                model_file: str) -> dict:
    """The `step_graphs` phase; returns the launches of its paths."""
    rv = graph_vs_eager(device)
    ce = graph_chunks_vs_eager(device)
    kc = graph_kernels(device, g)
    tr = graph_trainers(tmp, model_file)
    ev = graph_eval(device, model_file)
    times = graph_step_times(device, card)
    by_path = {f"graph_{n}": tr[n]["launches"] for n in ("trainer", "seg",
                                                          "spst")}
    by_path["graph_replay_vs_eager"] = rv["launches_graph"]
    in_graphs = {k: sum(tr[n]["launches_in_graphs"][k]
                        for n in ("trainer", "seg", "spst"))
                 + rv["launches_in_graph"][k] for k in PER_STEP}
    return {"by_path": by_path, "in_graphs": in_graphs, "kernel_checks": kc,
            "replay_vs_eager": rv, "chunks_vs_eager": ce, "trainers": tr,
            "eval": ev,
            "times": times}


# ---------------------------------------------------------------------------
# PR 12: NCCL capture of the data-parallel step (`ddp_graphs`), and the
# precision and EdgeConv-route knobs (`precision_routes`).
# ---------------------------------------------------------------------------

MESH_CHUNK = 8  # the world-of-one chunk held to eager mesh steps
MESH_TIMED_CHUNKS, MESH_TIMED_STEPS = 4, 16  # timed, interleaved
# The bf16 bounds of the CPU tests (tests/test_torch_port_precision.py),
# here for the kernel route against the plain one on the same card: loss
# terms within 1e-2 relative, each gradient tensor's cosine >= 0.999.
BF16_LOSS_RTOL, BF16_GRAD_COS = 1e-2, 0.999
# The EdgeConv layers of the flagship DGCNN: (input, output) widths.
EDGE_LAYERS = ((3, 64), (64, 64), (64, 128), (128, 256))
ROUTES = {"fused": ("fused", ""), "moments": ("moments", ""),
          "moments_gather_bf16": ("moments", "bf16"),
          "direct": ("direct", "")}


def nccl_version() -> str:
    return ".".join(map(str, torch.cuda.nccl.version()))


def mesh_chunk(out: str) -> int:
    """`chip_smoke.py --mesh-chunk OUT`, a process of its own: an NCCL
    world of one (`parallel.init_local_world`, the CLI's `--mesh_data 1`).
    A chunk of MESH_CHUNK replays of the captured paper step as a rank of
    the world (global BatchNorm's, the gradient's and the loss terms'
    all-reduces inside the graph) against as many eager mesh steps, each
    from the same seeded weights and generator seed, SGD at LR 0 (DGCNN's
    steps part at the rounding level at a nonzero LR, eager against eager;
    `graph_chunks_vs_eager`); then the step p50 of chunks of replays
    against eager mesh steps, interleaved. Writes OUT (JSON)."""
    from mlsp_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    parallel.init_local_world("nccl")
    mesh = parallel.make_mesh(1, device=device)
    cfg = train_cfg()
    batches = train_batches(cfg, device)
    chunk = [torch.stack([batches[i % len(batches)][j]
                          for i in range(MESH_CHUNK)]) for j in range(3)]
    runs = {}
    for route in ("graph", "eager"):
        model = train_model(cfg, device)
        opt, sched = make_optimizer(model, 0.0, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH, "SGD")
        gen = torch.Generator(device=device).manual_seed(SEED)
        seen = {}

        def recorded(name, fn, seen=seen):
            def call(*a, **kw):
                res = fn(*a, **kw)
                seen.setdefault(name, []).append(res)
                return res
            return call

        graphs = Graphs()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(steps_mod, "augment_batch", recorded(
                "augmented", steps_mod.augment_batch)), \
                mock.patch.object(steps_mod, "draw_step", recorded(
                    "draws", steps_mod.draw_step)):
            if route == "graph":
                m = pointda_train_scan(model, opt, sched, *chunk, gen, cfg,
                                       graphs, mesh)
            else:
                ms = [pointda_train_step(model, opt, sched, *(
                    t[i] for t in chunk), gen, cfg, mesh)
                    for i in range(MESH_CHUNK)]
                m = {k: torch.stack([s[k] for s in ms]) for k in ms[0]}
        torch.cuda.synchronize()
        # the last step's draws: the capture's tensors hold what the last
        # replay wrote
        draws = {**dict(zip(("src", "trgt"), seen["augmented"][-2:])),
                 **seen["draws"][-1]}
        runs[route] = {
            "seconds": time.perf_counter() - t0, "losses": m,
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "draws": {k: v.clone() for k, v in draws.items()},
            "gen": gen.get_state(), "launches": kernels.launches(),
            "in_graphs": kernels.launches_in_graphs(),
            "step": (model, opt, sched, gen, graphs)}
    g, e = runs["graph"], runs["eager"]
    loss_gap = max(float(((g["losses"][k] - w).abs()
                          / w.abs().clamp_min(1e-12)).max())
                   for k, w in e["losses"].items())
    grad_gap = grad_gaps(g["grads"], e["grads"])
    res = {
        "nccl": nccl_version(), "backend": mesh.backend,
        "world_size": mesh.size, "chunk": MESH_CHUNK,
        "config": "PointDAConfig().paper_recipe, SGD at LR 0",
        "batch": cfg.batch_size, "points": cfg.num_points,
        "draws_bit_equal": {k: bool(torch.equal(g["draws"][k],
                                                e["draws"][k]))
                            for k in e["draws"]},
        "generator_state_equal": bool(torch.equal(g["gen"], e["gen"])),
        "loss_rel_gap_max": loss_gap,
        "losses_bit_equal": all(torch.equal(g["losses"][k], v)
                                for k, v in e["losses"].items()),
        "same_grad_set": set(g["grads"]) == set(e["grads"]),
        "grad_gap": {"max": max(grad_gap.values()),
                     "median": statistics.median(grad_gap.values()),
                     "worst": max(grad_gap, key=grad_gap.get)},
        "capture_and_chunk_seconds": g["seconds"],
        "eager_seconds": e["seconds"],
        "launches_graph": g["launches"], "launches_in_graphs": g["in_graphs"],
        "launches_eager": e["launches"],
        "launches_eager_in_graphs": e["in_graphs"]}
    # step p50: chunks of replays against eager mesh steps, interleaved
    model, opt, sched, gen, graphs = g["step"]
    ms = {"graph": [], "eager": []}
    for _ in range(2):
        for _ in range(MESH_TIMED_CHUNKS // 2):
            t0 = time.perf_counter()
            pointda_train_scan(model, opt, sched, *chunk, gen, cfg, graphs,
                               mesh)
            torch.cuda.synchronize()
            ms["graph"].append((time.perf_counter() - t0) * 1e3 / MESH_CHUNK)
        for i in range(MESH_TIMED_STEPS // 2):
            t0 = time.perf_counter()
            pointda_train_step(model, opt, sched, *batches[i % len(batches)],
                               gen, cfg, mesh)
            torch.cuda.synchronize()
            ms["eager"].append((time.perf_counter() - t0) * 1e3)
    res["times"] = {"graph_step_p50_ms": statistics.median(ms["graph"]),
                    "eager_step_p50_ms": statistics.median(ms["eager"]),
                    "graph_ms": ms["graph"], "eager_ms": ms["eager"]}
    with open(out, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def ddp_graphs(device, card: str, tmp: str, dc: dict) -> dict:
    """NCCL capture of the data-parallel step: the NCCL version; the
    `mesh_chunk` process (a subprocess with a timeout of its own: a hung
    peer inside a replay is bounded by no process-group timeout, see
    PERF.md); the world-of-one trainer's epochs (`ddp_cli`, step graphs
    on) against the same trainer in one process."""
    emit("ddp_graphs", what="nccl", version=nccl_version(), card=card)
    out = os.path.join(tmp, "mesh_chunk.json")
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--mesh-chunk", out], capture_output=True,
                          text=True, timeout=600)
    check(done.returncode == 0,
          f"the NCCL mesh chunk exited {done.returncode}:\n"
          f"{done.stderr[-4000:]}")
    with open(out) as f:
        mc = json.load(f)
    times = mc.pop("times")
    emit("ddp_graphs", what="chunk_vs_eager_mesh_steps", **mc)
    steps = {k: MESH_CHUNK * v for k, v in PER_STEP.items()}
    check(all(mc["draws_bit_equal"].values())
          and mc["generator_state_equal"],
          f"a mesh replay draws other numbers than the eager step: {mc}")
    check(mc["loss_rel_gap_max"] <= LOSS_RTOL,
          f"mesh replays' losses differ: {mc['loss_rel_gap_max']}")
    check(mc["same_grad_set"] and mc["grad_gap"]["max"] <= GRAD_RTOL_TRAIN
          and mc["grad_gap"]["median"] <= GRAD_MEDIAN_TRAIN,
          f"mesh replays' gradients differ: {mc['grad_gap']}")
    check(mc["launches_graph"] == mc["launches_in_graphs"] == steps
          == mc["launches_eager"] and not any(
              mc["launches_eager_in_graphs"].values()),
          f"mesh chunk launches: {mc}")
    one = graph_cli(tmp, [
        "trainer", "--paper_recipe", "True", "--synthetic", "True",
        "--epochs", str(TRAINER_EPOCHS), "--scan_steps", str(GRAPH_EPOCH),
        "--out_path", os.path.join(tmp, "runs"), "--exp_name",
        "one_process"], "one_process")
    # one process also replays its eval forwards (EvalGraph); a mesh
    # evaluates eagerly
    check(one["launches"] == dc["launches"]
          == one["in_graphs"],
          f"one process launched {one['launches']} ({one['in_graphs']} "
          f"inside graph replays), the NCCL world {dc['launches']}")
    res = {"card": card, "nccl": mc["nccl"], "batch": mc["batch"],
           "world_of_one_step": times,
           "epoch_seconds": {"nccl_world_of_one": dc["epoch_seconds"],
                             "one_process": [r["seconds"]
                                             for r in one["records"]]},
           "scan_steps": GRAPH_EPOCH}
    emit("times", what="ddp_graphs", **res)
    return {"by_path": {"ddp_graphs_chunk": {
        k: mc["launches_graph"][k] + mc["launches_eager"][k]
        for k in PER_STEP}, "ddp_graphs_one_process": one["launches"]},
        "in_graphs": {k: mc["launches_in_graphs"][k] + dc["in_graphs"][k]
                      + one["in_graphs"][k] for k in PER_STEP},
        "times": res}


def edge_calibration_routes(device) -> dict:
    """This card's `calibrate` record and the route "auto" resolves to at
    each EdgeConv layer of the default DGCNN (N = 1024): "fused" (K1 + K2)
    everywhere, or the phase fails with the record."""
    records = chipcal.calibrated(device)
    model = train_model(train_cfg(), device)
    routes = model.edge_routes(N, device)
    res = {"records": records, "auto_routes": list(routes), "points": N,
           "layers": [list(io) for io in EDGE_LAYERS]}
    emit("precision_routes", what="calibration", **res)
    check(routes == ("fused",) * len(EDGE_LAYERS),
          f'edge_impl="auto" resolves to {routes} on this card, not K2 '
          f"(fused) on every layer; the record: {records}")
    return res


def bf16_kernels(device, g: torch.Generator) -> dict:
    """K1 and K2 on a bf16 forward's inputs (the kernels take them upcast
    to float32): K1 at the five graphs (cloud, then each EdgeConv layer's
    bf16 input) by the distance-set bound of `check_knn`, and on integer
    coordinates in bf16 (exact), index-equal; K2-fwd and K2-bwd at the
    four layers on u computed in bf16 and upcast, as `check_edge` and
    `check_edge_bwd` hold them."""
    cfg = dataclasses.replace(train_cfg(), compute_dtype="bf16")
    model = train_model(cfg, device).eval()
    x = torch.from_numpy(make_classification(B, N, NUM_CLASS,
                                             seed=SEED + 21)[0]).to(device)
    with torch.no_grad():
        idx = knn_indices(x, K)
        T = model.input_transform_net(edge_features(x, idx))
        feats = [torch.einsum("bnc,bdc->bnd", x, T).to(torch.bfloat16)]
        for conv in (model.conv1, model.conv2, model.conv3):
            feats.append(conv(feats[-1]))
        us = [dense_u(conv, f) for conv, f in zip(
            (model.conv1, model.conv2, model.conv3, model.conv4), feats)]
    check(all(f.dtype == torch.bfloat16 for f in feats + us),
          "the bf16 forward's features are not bf16")
    knn_checks = [check_knn(name, t.float(), phase="precision_routes")
                  for name, t in [("bf16 cloud", x)] + [
                      (f"bf16 conv{i + 1}", f) for i, f in enumerate(feats)]]
    exact = []
    for c in (3, 64):
        xi = integer_cloud(g, (B, N, c), device).to(torch.bfloat16)
        got, want = knn_cuda(xi, K), knn_indices_torch(xi, K)
        torch.cuda.synchronize()
        exact.append({"shape": [B, N, c], "dtype": "bf16",
                      "rows_unequal": int((got != want).any(-1).sum())})
    emit("precision_routes", kernel="knn", what="bf16 integer coordinates",
         cases=exact)
    check(all(e["rows_unequal"] == 0 for e in exact),
          f"K1 indices differ on bf16 integer coordinates: {exact}")
    edge = [check_edge(f"bf16 conv{i + 1}", f.float(), u.float())
            for i, (f, u) in enumerate(zip(feats, us))]
    bwd = [check_edge_bwd(f"bf16 conv{i + 1}", f.float(), u.float(), g)
           for i, (f, u) in enumerate(zip(feats, us))]
    return {"knn": knn_checks, "edge": edge, "edge_bwd": bwd}


def dense_u(conv, x: torch.Tensor) -> torch.Tensor:
    """u = W_d x of an EdgeConv layer, in its compute dtype."""
    from mlsp_tpu_torch.models.layers import dense

    w = conv.conv[0].weight.flatten(1)
    return dense(x, w[:, :x.shape[-1]], dtype=conv.dtype)


def cosines(got: dict, want: dict) -> dict:
    """Per tensor, the cosine of two gradients (1 where both are 0)."""
    out = {}
    for n, w in want.items():
        a, b = got[n].double(), w.double()
        norms = float(a.norm() * b.norm())
        out[n] = (float((a * b).sum()) / norms if norms
                  else float(not a.any() and not b.any()))
    return out


def bf16_step(device) -> dict:
    """The paper step at `compute_dtype` bf16 as a chunk of TRAIN_STEPS
    replays of its captured graph (per step K1 10, K2-fwd 8, K2-bwd 8, K3
    1, K4 1, all inside the replays), finite losses; then its first step
    through the kernels, recorded, against the plain route on the same
    card replaying the kernel run's kNN graphs and FPS order, eval-mode BN
    (rounding alone separates them): loss terms within BF16_LOSS_RTOL,
    each gradient's cosine >= BF16_GRAD_COS."""
    cfg = dataclasses.replace(train_cfg(), compute_dtype="bf16")
    batches = train_batches(cfg, device)
    model = train_model(cfg, device)
    init = copy.deepcopy(model.state_dict())
    opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                STEPS_PER_EPOCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    chunk = [torch.stack([b[j] for b in batches]) for j in range(3)]
    kernels.reset_launches()
    m = pointda_train_scan(model, opt, sched, *chunk, gen, cfg, Graphs())
    torch.cuda.synchronize()
    launches, in_graphs = kernels.launches(), kernels.launches_in_graphs()
    losses = {k: v.tolist() for k, v in m.items()}
    expected = {k: TRAIN_STEPS * v for k, v in PER_STEP.items()}
    ecfg = dataclasses.replace(cfg, debug_bn_eval=True)

    def rerun(backend):
        mm = train_model(ecfg, device, backend)
        mm.load_state_dict(init)
        return first_step(mm, dataclasses.replace(ecfg, knn_backend=backend),
                          batches[0], device)

    tape = Tape()
    kernels.reset_launches()
    with tape.record():
        k_loss, k_grad = rerun("auto")
    kernels_launched = kernels.launches()
    kernels.reset_launches()
    with tape.replay():
        p_loss, p_grad = rerun("torch")
    torch.cuda.synchronize()
    plain_launches = kernels.launches()
    loss_gap = {n: abs(p_loss[n] - w) / max(abs(w), 1e-12)
                for n, w in k_loss.items()}
    cos = cosines(p_grad, k_grad)
    res = {"config": "PointDAConfig().paper_recipe, compute_dtype bf16",
           "batch": cfg.batch_size, "steps": TRAIN_STEPS,
           "launches": launches, "launches_in_graphs": in_graphs,
           "launches_expected": expected, "losses": losses,
           "finite": all(np.isfinite(v).all() for v in losses.values()),
           "first_step_plain_vs_kernel_eval_bn": {
               "loss_rel_gap": loss_gap, "grad_cos_min": min(cos.values()),
               "grad_cos_worst": min(cos, key=cos.get),
               "same_grad_set": set(p_grad) == set(k_grad),
               "graphs_replayed": len(tape.graphs),
               "plain_route_launches": plain_launches}}
    emit("precision_routes", what="bf16 paper step", **res)
    check(res["finite"] and launches == in_graphs == expected,
          f"the bf16 step graph launched {launches} ({in_graphs} inside "
          f"its replays), not {expected}")
    check(not any(plain_launches.values()) and kernels_launched == PER_STEP
          and set(p_grad) == set(k_grad)
          and max(loss_gap.values()) <= BF16_LOSS_RTOL
          and min(cos.values()) >= BF16_GRAD_COS,
          f"the bf16 first step: plain route against kernels {res}")
    return {**res, "cfg": cfg, "batches": batches}


def bf16_clis(tmp: str) -> dict:
    """The trainer CLI at `--compute_dtype bf16 --scan_steps GRAPH_EPOCH`
    (2 epochs, each one chunk of replays: exact launches, all inside graph
    replays, the eval forwards' too; the log's EdgeConv routes all
    "fused") and the seg
    CLI at `--compute_dtype bf16` (exact launches), finite losses."""
    out = os.path.join(tmp, "bf16_runs")
    tr = graph_cli(tmp, [
        "trainer", "--paper_recipe", "True", "--synthetic", "True",
        "--epochs", str(TRAINER_EPOCHS), "--scan_steps", str(GRAPH_EPOCH),
        "--compute_dtype", "bf16", "--out_path", out, "--exp_name",
        "bf16_trainer"], "bf16_trainer")
    seg = graph_cli(tmp, [
        "seg", "--config", repo_file(SEG_CONFIG), "--synthetic", "True",
        "--apply_PCM", "True", "--epochs", str(SEG_TRAINER_EPOCHS),
        "--compute_dtype", "bf16", "--out_path", out, "--exp_name",
        "bf16_seg"], "bf16_seg")
    routes = [ln.rsplit(": ", 1)[-1] for ln in tr["log"].splitlines()
              if "EdgeConv routes" in ln]
    res = {}
    for name, r, want in (
            ("trainer", tr, trainer_launches(TRAINER_EPOCHS)),
            ("seg", seg, seg_trainer_launches(SEG_TRAINER_EPOCHS))):
        losses = [rec["train"] for rec in r["records"]]
        res[name] = {"launches": r["launches"], "launches_expected": want,
                     "launches_in_graphs": r["in_graphs"], "losses": losses,
                     "finite": all(np.isfinite(v) for m in losses
                                   for v in m.values()),
                     "step_graphs": [rec["step_graphs"]
                                     for rec in r["records"]],
                     "epoch_seconds": [rec["seconds"]
                                       for rec in r["records"]]}
        emit("precision_routes", what=f"bf16 {name} cli", **res[name])
        check(r["launches"] == want and res[name]["finite"],
              f"the bf16 {name} CLI: {res[name]}")
    res["trainer"]["edge_routes_line"] = routes
    # each epoch one chunk of replays, every eval forward an EvalGraph
    check(res["trainer"]["launches_in_graphs"] == res["trainer"]["launches"]
          and all(res["trainer"]["step_graphs"])
          and routes == ["fused, fused, fused, fused"],
          f"the bf16 trainer's replays or routes: {res['trainer']}, "
          f"{routes}")
    return res


def route_times(device, card: str) -> dict:
    """Each EdgeConv route's forward and forward + backward ms per layer
    (CUDA events, `median_ms`) in train mode at [B, N, C_in] -> C_out for
    the flagship's four layers, float32, the kNN graph built by K1 in
    every route; "moments_gather_bf16" is the moments route at
    `gather_dtype` bf16. The backward takes a fixed cotangent to the
    layer's input and weights."""
    from mlsp_tpu_torch.models.dgcnn import EdgeConvM
    from mlsp_tpu_torch.models.layers import init_parameters

    g = torch.Generator().manual_seed(SEED + 22)
    rows = []
    for cin, cout in EDGE_LAYERS:
        x = torch.randn(B, N, cin, generator=g).to(device)
        cot = torch.randn(B, N, cout, generator=g).to(device)
        row = {"shape": [B, N, cin], "c_out": cout}
        for name, (route, gd) in ROUTES.items():
            layer = EdgeConvM(cin, cout, K, "auto", None,
                              torch.bfloat16 if gd else None)
            init_parameters(layer, torch.Generator().manual_seed(SEED))
            layer = layer.to(device).train()
            xr = x.clone().requires_grad_()

            def fwd(layer=layer, route=route, xr=xr):
                with torch.no_grad():
                    return layer(xr, route)

            def fwd_bwd(layer=layer, route=route, xr=xr):
                torch.autograd.backward(layer(xr, route), cot)

            f, fb = median_ms(fwd), median_ms(fwd_bwd)
            row[name] = {"fwd_ms": f, "fwd_bwd_ms": fb, "bwd_ms": fb - f}
        rows.append(row)
    res = {"card": card, "batch": B, "points": N, "k": K, "layers": rows,
           "total_fwd_bwd_ms": {name: sum(r[name]["fwd_bwd_ms"]
                                          for r in rows) for name in ROUTES}}
    emit("times", what="edge_routes", **res)
    return res


def precision_times(device, card: str) -> dict:
    """Step p50 (host clock, chunks of GRAPH_EPOCH replays ending in a
    synchronize) and peak memory of the paper step at `compute_dtype`
    float32 and bf16, each route's graph captured alone (peak allocated
    and reserved after its capture and replays), then their chunks
    interleaved."""
    runs = {}
    for dt in ("f32", "bf16"):
        cfg = dataclasses.replace(train_cfg(), compute_dtype=dt)
        batches = train_batches(cfg, device)
        chunk = [torch.stack([batches[i % len(batches)][j]
                              for i in range(GRAPH_EPOCH)]) for j in range(3)]
        model = train_model(cfg, device)
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs,
                                    STEPS_PER_EPOCH)
        gen = torch.Generator(device=device).manual_seed(SEED)
        graphs = Graphs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            pointda_train_scan(model, opt, sched, *chunk, gen, cfg, graphs)
        torch.cuda.synchronize()
        runs[dt] = {"args": (model, opt, sched, *chunk, gen, cfg, graphs),
                    "ms": [],
                    "peak_allocated_gb": torch.cuda.max_memory_allocated()
                    / 1e9,
                    "peak_reserved_gb": torch.cuda.max_memory_reserved()
                    / 1e9}
    for dt in ("f32", "bf16", "bf16", "f32", "f32", "bf16", "bf16", "f32"):
        t0 = time.perf_counter()
        pointda_train_scan(*runs[dt]["args"])
        torch.cuda.synchronize()
        runs[dt]["ms"].append((time.perf_counter() - t0) * 1e3 / GRAPH_EPOCH)
    res = {"card": card, "chunk": GRAPH_EPOCH, **{
        dt: {"graph_step_p50_ms": statistics.median(r["ms"]), "ms": r["ms"],
             "peak_allocated_gb": r["peak_allocated_gb"],
             "peak_reserved_gb": r["peak_reserved_gb"]}
        for dt, r in runs.items()}}
    res["bf16_over_f32"] = (res["bf16"]["graph_step_p50_ms"]
                            / res["f32"]["graph_step_p50_ms"])
    emit("times", what="precision_step", **res)
    return res


def precision_routes(device, card: str, g: torch.Generator,
                     tmp: str) -> dict:
    """The `precision_routes` phase; returns the launches of its paths."""
    cal = edge_calibration_routes(device)
    kc = bf16_kernels(device, g)
    st = bf16_step(device)
    cl = bf16_clis(tmp)
    rt = route_times(device, card)
    pt = precision_times(device, card)
    return {"by_path": {"bf16_step": st["launches"],
                        "bf16_trainer": cl["trainer"]["launches"],
                        "bf16_seg_trainer": cl["seg"]["launches"]},
            "in_graphs": {k: st["launches_in_graphs"][k]
                          + cl["trainer"]["launches_in_graphs"][k]
                          + cl["seg"]["launches_in_graphs"][k]
                          for k in PER_STEP},
            "kernel_checks": kc, "calibration": cal, "route_times": rt,
            "times": pt}


# What each kernel entry sums over: the serving kernels (K1, K2-fwd) over
# one B=32 serving forward, the train-only kernels over one B=32 train step.
# ---------------------------------------------------------------------------
# points_mesh: the points axis (`parallel.make_mesh(data, points)`) on one
# card, as gloo ranks sharing it (NCCL refuses two ranks on one device).
# ---------------------------------------------------------------------------

POINTS = 2  # the steps' and trainers' mesh: data 1 x points 2
# The split step's gradients against the unsplit step's: the points group
# sums the cotangents of each split producer's rows (`copy_to_points`)
# where the unsplit step holds them whole, and the sums round apart (on
# an H100 80GB HBM3 at 700 W: 3.2e-7 to 1.1e-5)
SPLIT_RTOL = 1e-4
RANGE_P = (2, 4)  # the points axes whose ranges K1 is checked and timed
# (q0, nq) beyond the P ranks' own ranges, for N >= 1024: q0 off the
# 32-query tile with a ragged last tile, and nq < k at the cloud's end
RANGE_EXTRA = ((45, 300), (-7, 7))
POINTS_TIMED_REPS = 20
PN2_ATOL = 1e-5


def range_rows(n: int, p: int) -> list:
    """The (q0, nq) of each of p points ranks (`parallel.points_rows`)."""
    from mlsp_tpu_torch.parallel import Mesh, points_rows

    return [points_rows(n, Mesh(0, 1, torch.device("cpu"), points=p,
                                points_rank=r)) for r in range(p)]


def knn_ranges(device, card: str, g: torch.Generator, knn_in: list,
               seg_in: list) -> dict:
    """K1's query range against the whole K1 at the DGCNN layers' inputs
    [32, 1024, C] (C = 3, 64, 64, 128) and the seg layers' [16, 2048, C]
    (C = 3, 64): every rank's rows at P = 2 and 4, a q0 off the 32-query
    tile and an nq below k at the cloud's end, on the forward's own
    values, on integer coordinates and with a quarter of exact-zero points
    (a scan batch's ties); each range index-equal to the whole launch's
    rows, eagerly and launched from inside a CUDA graph (`Graphed`); then
    the ms of a rank's range at P = 2 and 4 beside the whole launch, the
    plain version and the bound (B·nq·N·(2C + 4) operations)."""
    inputs = [(f"dgcnn {n}", t) for n, t in knn_in[1:]] + [
        (f"seg {n}", t) for n, t in seg_in if n in ("edge1", "edge2")]
    graphed = Graphed(knn_cuda)
    checks, rows = [], []
    for name, x in inputs:
        n = x.shape[1]
        ranges = [r for p in RANGE_P for r in range_rows(n, p)] + [
            (q0 % n, nq) for q0, nq in RANGE_EXTRA]
        zeros = x.clone()
        zeros[:, ::4] = 0.0
        for data, xd in (("forward", x),
                         ("integer", integer_cloud(g, x.shape, device)),
                         ("quarter exact zeros", zeros)):
            whole = knn_cuda(xd, K)
            unequal = {}
            for q0, nq in ranges:
                want = whole[:, q0:q0 + nq]
                got = knn_cuda(xd, K, (q0, nq))
                bad = int((got != want).any(-1).sum())
                if data == "forward":
                    bad += int((graphed(xd, K, (q0, nq)) != want
                                ).any(-1).sum())
                unequal[f"{q0}+{nq}"] = bad
            res = {"input": name, "shape": list(x.shape), "data": data,
                   "ranges": len(ranges),
                   "rows_unequal": sum(unequal.values())}
            emit("points_mesh", kernel="knn range", **res)
            check(res["rows_unequal"] == 0,
                  f"K1's query range differs from the whole launch's rows: "
                  f"{res} {unequal}")
            checks.append(res)
        for p in RANGE_P:
            q0, nq = range_rows(n, p)[0]
            row = {"input": name, "shape": list(x.shape), "points": p,
                   "rows": [q0, nq],
                   "ms": median_ms(lambda: knn_cuda(x, K, (q0, nq)),
                                   POINTS_TIMED_REPS),
                   "whole_ms": median_ms(lambda: knn_cuda(x, K),
                                         POINTS_TIMED_REPS),
                   "plain_ms": median_ms(
                       lambda: knn_indices_torch(x, K, (q0, nq)),
                       POINTS_TIMED_REPS),
                   **dict(zip(("bound_ms", "bound_by"),
                              bound(*knn_cost(x, K, nq))))}
            emit("times", what="points_mesh knn range", card=card, **row)
            rows.append(row)
    check(graphed.replays > 0, "no K1 range was launched from a graph")
    return {"checks": checks, "rows": rows, "graph_replays": graphed.replays}


def points_rank(mesh, cases: list, trainer_cfg, spst_cfg, pn2: dict,
                log: str) -> dict:
    """A rank of the points mesh (spawned by `points_mesh`): each case's
    step split and whole (`testing.points_step_cases`), then, each with
    the launch counts set to 0 just before and read just after, one epoch
    of `train_pointda`, one SPST round (`train_spst`) and a PointNet++
    eval forward under `points_sharding`; the trainers' lines go to
    `log`.RANK."""
    out = {"steps": points_step_cases(mesh, cases)}
    rank = mesh.rank * mesh.points + mesh.points_rank
    with open(f"{log}.{rank}", "w") as f, contextlib.redirect_stdout(f):
        for name, run_one in (
                ("trainer", lambda: train_pointda(trainer_cfg, mesh=mesh)),
                ("spst", lambda: train_spst(spst_cfg, mesh=mesh))):
            kernels.reset_launches()
            t0 = time.perf_counter()
            _, res = run_one()
            torch.cuda.synchronize()
            out[name] = {"seconds": time.perf_counter() - t0,
                         "launches": kernels.launches(),
                         "test_acc": (res.get("test") or res["final"])["acc"]}
    out["pn2"] = pn2_forward(mesh, pn2)
    return out


def pn2_forward(mesh, pn2: dict) -> dict:
    """A full-width PointNet++ eval forward at B=32, N=1024 from seeded
    weights and BatchNorm, under `points_sharding(mesh)` (None: one
    process): its logits and launches."""
    from mlsp_tpu_torch import parallel

    device = torch.device(pn2["device"])
    g = torch.Generator().manual_seed(SEED + 21)
    model = make_model("pointnet2", NUM_CLASS, device=device, generator=g)
    randomise_batch_norm(model, g)
    model.eval()
    x = torch.from_numpy(pn2["x"]).to(device)
    kernels.reset_launches()
    with torch.no_grad(), parallel.points_sharding(mesh):
        logits = model(x)["cls"]
    torch.cuda.synchronize()
    return {"logits": logits.float().cpu().numpy(),
            "launches": kernels.launches()}


def points_cases(device) -> dict:
    """The paper step (float32 heads, as `ddp_gloo_step`) with eval- and
    train-mode BN, and the seg step (configs/pointsegda_mlsp.yaml plus
    PCM, B=16, N=2048), from seeded weights and batches."""
    cfg = dataclasses.replace(train_cfg(), head_dtype="f32")
    src_x, src_y, trgt_x = (t.cpu() for t in train_batches(cfg, device)[0])
    case = {"kind": "pointda", "model": "dgcnn", "num_class": NUM_CLASS,
            "kwargs": {**model_kwargs(cfg), "k": K},
            "state": {k: v.cpu() for k, v in
                      train_model(cfg, device).state_dict().items()},
            "cfg": cfg, "seed": SEED, "device": str(device),
            "batch": {"src_x": src_x, "src_y": src_y, "trgt_x": trgt_x}}
    scfg = seg_cfg()
    sx, sy, tx = (t.cpu() for t in seg_batches(scfg, device)[0])
    seg = {"kind": "seg", "model": "dgcnn_seg", "num_class": SEG_NUM_CLASS,
           "kwargs": {"k": K, "dropout": scfg.dropout,
                      "density_num_cls": scfg.density_num_class,
                      "pergroup": scfg.pergroup},
           "state": {k: v.cpu() for k, v in
                     seg_model(scfg, device).state_dict().items()},
           "cfg": scfg, "seed": SEED, "device": str(device),
           "batch": {"src_x": sx, "src_y": sy, "trgt_x": tx}}
    return {"paper_eval_bn": {**case, "cfg": dataclasses.replace(
        cfg, debug_bn_eval=True)}, "paper_train_bn": case, "seg": seg}


def points_steps(name: str, case: dict, split: list, whole: list) -> dict:
    """One case's step on the points mesh against the same ranks' step
    without the split and against one process: the ranks bit-equal; the
    augmented batch and draws bit-equal to the unsplit step's and the
    single process's; the gathered K1 graphs index-equal to the unsplit
    step's whole K1 graphs (and, under eval-mode BN, to the single
    process's); the split step's losses within LOSS_RTOL and gradients
    within SPLIT_RTOL of the unsplit one's; K1's range graphs against the
    plain kNN of their rows;
    then rank 0 against one process on the plain route replaying the
    gathered graphs and FPS orders, at `ddp_gloo_step`'s limits
    (`_ddp_compare`). Returns the largest gaps and the launches."""
    r0, r1 = split
    train_bn = not getattr(case["cfg"], "debug_bn_eval", False)
    batch = case["cfg"].batch_size
    got = merge_rank_tapes(split, batch, POINTS)
    want = merge_rank_tapes(whole, batch, POINTS)
    one = step_case(None, case)
    per_step = SEG_PER_STEP if case["kind"] == "seg" else PER_STEP
    graphs_unequal = sum(int((a != b).any(-1).sum()) for a, b in zip(
        got.graphs, want.graphs)) if len(got.graphs) == len(want.graphs) \
        else -1
    one_unequal = sum(int((a != torch.from_numpy(b)).any(-1).sum())
                      for a, b in zip(got.graphs, one["graphs"]))
    draws_equal = all(
        r["draws"].keys() == r0["draws"].keys()
        and all(np.array_equal(v, r["draws"][k])
                for k, v in r0["draws"].items())
        for r in (whole[0], one))
    knn = r0["knn_against_plain"] + r1["knn_against_plain"]
    plain = {**case, "cfg": dataclasses.replace(case["cfg"],
                                                knn_backend="torch"),
             "kwargs": {**case["kwargs"], "knn_backend": "torch"}}
    res = _ddp_compare(r0, r1, plain, batch, train_bn, POINTS)
    res.pop("one")
    split_vs_whole = _rank_gaps(r0, whole[0])
    sw = {"loss_max": max(split_vs_whole["loss"].values()),
          "grad_max": max(split_vs_whole["grad"].values())}
    res.update(
        ranks_bit_equal=r0["metrics"] == r1["metrics"] and all(
            np.array_equal(g, r1["grads"][k]) for k, g in r0["grads"].items()),
        draws_bit_equal=draws_equal, graphs=len(got.graphs),
        graph_rows_unequal_vs_unsplit=graphs_unequal,
        graph_rows_unequal_vs_one_process=one_unequal,
        split_vs_unsplit=sw,
        launches_per_rank=[r0["launches"], r1["launches"]],
        knn_vs_plain={"launches": len(knn),
                      "rows": sorted({str(r["rows"]) for r in knn}),
                      "max_gap_over_tol": max(r["max_gap_over_tol"]
                                              for r in knn)},
        losses=r0["metrics"])
    emit("points_mesh", what=f"data 1 x points {POINTS} gloo ranks on the "
         f"card vs the unsplit step and one process, {name}", **res)
    check(res["ranks_bit_equal"], f"the points ranks disagree ({name})")
    check(draws_equal, f"the draws differ on the points mesh ({name})")
    check(graphs_unequal == 0, f"the gathered K1 graphs differ from the "
          f"whole K1's ({name}): {graphs_unequal} rows")
    check(sw["loss_max"] <= LOSS_RTOL and sw["grad_max"] <= SPLIT_RTOL,
          f"the split step differs from the unsplit one ({name}): {sw}")
    check(train_bn or one_unequal == 0, f"the gathered K1 graphs differ "
          f"from one process's ({name}): {one_unequal} rows")
    check(r0["launches"] == per_step and r1["launches"] == per_step,
          f"a points rank's step launched {r0['launches']}, "
          f"{r1['launches']} ({name})")
    check(len(knn) == 2 * per_step["knn"]
          and all(r["rows"] is not None for r in knn)
          and res["knn_vs_plain"]["max_gap_over_tol"] <= 1.0,
          f"K1's ranges on a rank disagree with the plain kNN: "
          f"{res['knn_vs_plain']}")
    check(not any(res["plain_launches"].values()) and res["same_grad_set"],
          f"the plain route launched {res['plain_launches']} or another "
          "gradient set")
    check(not res["outside_count"], f"the points mesh differs from one "
          f"process ({name}): {res['outside']}")
    return res


def points_mesh(device, card: str, g: torch.Generator, tmp: str,
                model_file: str, knn_in: list, seg_in: list) -> dict:
    """The points axis on one card: K1's query ranges (`knn_ranges`); then
    2 gloo ranks sharing the card as data 1 x points 2 (`points_rank`, one
    spawn): the paper and seg steps (`points_steps`), one epoch of the
    paper trainer and one SPST round (3 PCM epochs' worth of the spst
    phase's launches: exact launches, each rank the one-process count, as
    each rank launches one range a kNN build), finite losses, wall time
    beside one process's run of the same; and a PointNet++ eval forward at
    B=32, N=1024 (ball query split, K4 whole) within PN2_ATOL of one
    process's. Returns the launches by path."""
    kr = knn_ranges(device, card, g, knn_in, seg_in)
    cases = points_cases(device)
    out = os.path.join(tmp, "runs")
    trainer_cfg = PointDAConfig(synthetic=True, epochs=1, out_path=out,
                                exp_name="points_trainer",
                                device=str(device)).paper_recipe
    spst_cfg = SPSTConfig(synthetic=True, model_file=model_file, rounds=1,
                          epochs=1, threshold=SPST_THRESHOLD, apply_PCM=True,
                          out_path=out, exp_name="points_spst",
                          device=str(device))
    pn2 = {"device": str(device), "x": make_classification(
        B, N, NUM_CLASS, seed=SEED + 22)[0]}
    t0 = time.perf_counter()
    ranks = run_ranks(POINTS, points_rank, list(cases.values()), trainer_cfg,
                      spst_cfg, pn2, os.path.join(tmp, "points_rank.log"),
                      backend="gloo", device=str(device), timeout_s=600,
                      points=POINTS)
    spawn_s = time.perf_counter() - t0
    steps = {}
    for i, (name, case) in enumerate(cases.items()):
        steps[name] = points_steps(name, case,
                                   [r["steps"]["split"][i] for r in ranks],
                                   [r["steps"]["whole"][i] for r in ranks])
    # one process: the same trainer epoch and SPST round, then PointNet++
    alone = {}
    for name, cfg, run_one in (
            ("trainer", dataclasses.replace(trainer_cfg,
                                            exp_name="points_alone"),
             lambda c: train_pointda(c)),
            ("spst", dataclasses.replace(spst_cfg, exp_name="points_alone"),
             lambda c: train_spst(c))):
        with open(os.path.join(tmp, f"points_{name}_alone.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            kernels.reset_launches()
            t = time.perf_counter()
            run_one(cfg)
            torch.cuda.synchronize()
            alone[name] = {"seconds": time.perf_counter() - t,
                           "launches": kernels.launches()}
    with open(os.path.join(out, "points_trainer", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(out, "points_alone", "metrics.jsonl")) as f:
        alone_records = [json.loads(line) for line in f]
    pn2_one = pn2_forward(None, pn2)
    pn2_gap = max(float(np.abs(r["pn2"]["logits"] - pn2_one["logits"]).max())
                  for r in ranks)
    res = {"mesh": {"data": 1, "points": POINTS}, "backend": "gloo",
           "seconds_spawn_to_results": spawn_s,
           "trainer": {"per_rank": [r["trainer"] for r in ranks],
                       "alone": alone["trainer"],
                       "epoch_seconds": records[0]["seconds"],
                       "alone_epoch_seconds": alone_records[0]["seconds"],
                       "losses": records[0]["train"]},
           "spst": {"per_rank": [r["spst"] for r in ranks],
                    "alone": alone["spst"]},
           "pn2": {"launches_per_rank": [r["pn2"]["launches"] for r in ranks],
                   "alone_launches": pn2_one["launches"],
                   "max_logit_gap": pn2_gap, "atol": PN2_ATOL}}
    emit("points_mesh", what="trainer epoch, SPST round and PointNet++ eval "
         "forward on data 1 x points 2 vs one process", card=card, **res)
    for name in ("trainer", "spst"):
        for r in ranks:
            check(r[name]["launches"] == alone[name]["launches"],
                  f"a points rank's {name} launched {r[name]['launches']}, "
                  f"one process {alone[name]['launches']}")
    check(all(np.isfinite(v) for v in records[0]["train"].values()),
          f"non-finite trainer losses on the points mesh: {records[0]}")
    check(alone["trainer"]["launches"] == trainer_launches(1),
          f"the one-process trainer epoch launched "
          f"{alone['trainer']['launches']}")
    check(all(r["pn2"]["launches"] == pn2_one["launches"] for r in ranks)
          and pn2_one["launches"]["fps"] == 2 and pn2_gap <= PN2_ATOL,
          f"PointNet++ on the points mesh: {res['pn2']}")
    check(alone["spst"]["launches"] == spst_launches(1),
          f"the one-process SPST round launched {alone['spst']['launches']}")

    def added(counts):
        return {k: sum(c[k] for c in counts) for k in PER_STEP}

    by_path = {
        "points_steps": added([r["steps"]["split"][i]["launches"]
                               for r in ranks for i in range(len(cases))]),
        "points_trainer": added([r["trainer"]["launches"] for r in ranks]),
        "points_spst": added([r["spst"]["launches"] for r in ranks]),
        "points_pn2": added([r["pn2"]["launches"] for r in ranks])}
    return {"by_path": by_path, "knn_ranges": kr, "steps": steps, **res}


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
        dg = ddp_graphs(device, card, tmp, ddp["cli"])
        sgr = step_graphs(device, card, g, tmp, trn["model_file"])
        pr = precision_routes(device, card, g, tmp)
        pm = points_mesh(device, card, g, tmp, trn["model_file"], knn_in,
                         seg["knn_in"])

        kt = kernel_times(device, card, knn_in, edge_in, g)
        serving_times(srv["served"], srv["plain"], device, card)
        st = step_times(tr, device, card)
        trainer_times(trn, trn["model_file"], st["p50_ms"], device, card)
        seg_kt = seg_kernel_times(device, card, seg, g)
        seg_st = seg_step_times(seg_tr, device, card)
        seg_trainer_times(seg_trn, seg_st["p50_ms"], device, card)
        sg = scan_graph(device, card, g)

    gk, pk = sgr["kernel_checks"], pr["kernel_checks"]
    errs = {
        "knn": max(c["max_dist_gap"] for c in knn_checks + seg["knn"]
                   + sg["knn_checks"] + gk["knn"] + pk["knn"]),
        "edge_moments": max(c["max_abs_err"]
                            for c in edge_checks + gk["edge"] + pk["edge"]),
        "edge_moments_bwd": max(c["max_abs_err"] for c in bwd_checks
                                + sg["bwd_checks"] + gk["edge_bwd"]
                                + pk["edge_bwd"]),
        "knn_moments": max(moments_check["max_abs_err"],
                           seg["knn_moments"]["max_abs_err"],
                           gk["knn_moments"]["max_abs_err"]),
        "fps": float(max(c["unequal_indices"]
                         for c in fps_checks + [seg["fps"]]
                         + fam["kernel_checks"]["fps"]
                         + vit["kernel_checks"]["fps"] + gk["fps"])),
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
                   **{path: n[kname] for path, n in ddp["by_path"].items()},
                   **{path: n[kname] for path, n in dg["by_path"].items()},
                   **{path: n[kname] for path, n in sgr["by_path"].items()},
                   **{path: n[kname] for path, n in pr["by_path"].items()},
                   **{path: n[kname] for path, n in pm["by_path"].items()}}
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_in_step_graphs": sgr["in_graphs"][kname]
            + dg["in_graphs"][kname] + pr["in_graphs"][kname],
            "max_abs_err": errs[kname],
            **main, "library_ms": None, "ms_over": over,
            "per_train_step": total(step_rows[kname]),
            "per_launch_at_family_shapes": fam["times"]["rows"].get(kname),
            "per_launch_at_vit_shapes": vit["times"]["rows"].get(kname),
            "per_seg_train_step": (total(seg_step_rows[kname])
                                   if kname in seg_step_rows else None),
            # K1's query-range form (a points rank's rows): every K1 launch
            # on the points_mesh paths, and a rank's range at P = 2 and 4
            "query_range": {
                "launches": sum(n["knn"] for n in pm["by_path"].values()),
                "per_launch": pm["knn_ranges"]["rows"]}
            if kname == "knn" else None,
            "check": "passed",  # a failed check exits before this line
            **({"bit_equal_over_launches": True}  # `check_edge_bwd`
               if kname == "edge_moments_bwd" else {}),
        })
    print(json.dumps({"kernels": entries}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--cli-rank"]:  # a torchrun rank of `ddp_cli`
        return cli_rank(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--mesh-chunk"]:  # `ddp_graphs`'s NCCL world
        return mesh_chunk(sys.argv[2])
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
