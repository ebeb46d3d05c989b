"""Drive the PyTorch/CUDA port (`mlsp_tpu_torch`) on one NVIDIA card.

Usage: python3 chip_smoke.py

It needs one CUDA card and nvcc, and exits non-zero without them. Phases,
one JSON line each; any failure exits non-zero before the last line:

  device  the card, with the name and power limit nvidia-smi reports
  build   compile every kernel of the serving path from mlsp_tpu_torch/csrc
  knn     the kNN kernel (K1) against its plain version, on the inputs the
          serving forward gives it, plus a ragged N
  edge    the neighbourhood-statistics kernel (K2, forward) against its
          plain version, on the serving forward's inputs
  serve   the main path: a full-width DGCNN (k=20, N=1024, 10 classes,
          random seeded weights and BatchNorm) is saved as a serving bundle,
          loaded with ServingModel on the card, and answers 5 requests
          (4 x 32 clouds, 1 x 7); launches of each kernel are counted over
          exactly those requests, and the answers are held against the same
          weights run through the plain versions on the card
  times   median kernel and plain-version times (CUDA events) beside each
          kernel's bound, and serving latency and throughput at B=32

Then the `kernels` line, nvidia-smi's line and `{"ok": true, ...}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mlsp_tpu_torch import ServingModel, make_model, save_serving_bundle
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.edge import edge_moments_torch
from mlsp_tpu_torch.ops.kernels import _build, edge_moments_cuda, knn_cuda
from mlsp_tpu_torch.ops.knn import edge_features, knn_indices, knn_indices_torch

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
U32 = 2.0 ** -24  # float32 unit roundoff


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
    """Median over `reps` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
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


def knn_cost(x: torch.Tensor) -> tuple[float, float]:
    """Per pair of points: 2C for the dot product, 4 to form, clamp and
    compare the distance; x read once, the indices written once."""
    b, n, c = x.shape
    return b * n * n * (2 * c + 4), b * n * c * 4 + b * n * K * 8


def edge_cost(u: torch.Tensor, idx: torch.Tensor) -> tuple[float, float]:
    """Eval form (max and min): 2 compares per gathered value; u and idx
    read once, mx and mn written once."""
    b, n, c = u.shape
    return b * n * K * c * 2, b * n * c * 4 + idx.numel() * 8 + 2 * b * n * c * 4


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


def check_knn(name: str, x: torch.Tensor) -> dict:
    """Pass: in every row the two neighbour sets' sorted float64 distances
    agree within the float32 rounding bound of the distance formula,
    4 (C + 3) u max_j(‖q‖² + ‖x_j‖²); both pick among near ties only."""
    got = knn_cuda(x, K)
    want = knn_indices_torch(x, K)
    torch.cuda.synchronize()
    xd = x.double()
    sq = xd.square().sum(-1)
    d = (sq[:, :, None] + sq[:, None, :] - 2 * xd @ xd.transpose(1, 2))
    dg = torch.sort(torch.gather(d, -1, got), -1).values
    dw = torch.sort(torch.gather(d, -1, want), -1).values
    tol = 4 * (x.shape[-1] + 3) * U32 * (sq + sq.amax(-1, keepdim=True))
    gap = (dg - dw).abs().amax(-1)
    res = {"input": name, "shape": list(x.shape),
           "rows": gap.numel(),
           "rows_same_indices": float((got == want).all(-1).float().mean()),
           "rows_same_set": float((gap == 0).float().mean()),
           "max_dist_gap": float(gap.max()),
           "max_gap_over_tol": float((gap / tol).max())}
    emit("knn", **res)
    check(bool((gap <= tol).all()), f"knn kernel disagrees on {name}: {res}")
    return res


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
           "launches_expected": {"knn": 5 * len(requests),
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
    edge_checks = [check_edge(name, xg, u) for name, xg, u in edge_in]

    with tempfile.TemporaryDirectory() as bundle_dir:
        srv = serve(model, bundle_dir, device)

    rows = {"knn": [], "edge_moments": []}
    for name, t in knn_in:
        ms = median_ms(lambda: knn_cuda(t, K))
        plain_ms = median_ms(lambda: knn_indices_torch(t, K))
        b_ms, b_by = bound(*knn_cost(t))
        rows["knn"].append({"input": name, "shape": list(t.shape), "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by})
    for name, xg, u in edge_in:
        idx = knn_cuda(xg, K)
        ms = median_ms(lambda: edge_moments_cuda(u, idx, False))
        plain_ms = median_ms(lambda: edge_moments_torch(u, idx, False))
        b_ms, b_by = bound(*edge_cost(u, idx))
        rows["edge_moments"].append({"input": name, "shape": list(u.shape),
                                     "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": b_ms, "bound_by": b_by})
    for kname, per_shape in rows.items():
        emit("times", what=kname, per_forward=per_shape, card=card)
    serving_times(srv["served"], srv["plain"], device, card)

    meta = {
        "knn": ("mlsp_tpu_torch/csrc/knn.cu",
                "mlsp_tpu/ops/pallas/knn_pallas.py:69",
                max(c["max_dist_gap"] for c in knn_checks)),
        "edge_moments": ("mlsp_tpu_torch/csrc/edge_moments.cu",
                         "mlsp_tpu/ops/pallas/edge_pallas.py:233",
                         max(c["max_abs_err"] for c in edge_checks)),
    }
    entries = []
    for kname, (source, replaces, err) in meta.items():
        per_shape = rows[kname]
        by_ops = sum(r["bound_ms"] for r in per_shape
                     if r["bound_by"] == "operations")
        by_bytes = sum(r["bound_ms"] for r in per_shape
                       if r["bound_by"] == "bytes")
        # Times are summed over the kernel's launches in one B=32 forward.
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": srv["launches"][kname],
            "max_abs_err": err,
            "ms": sum(r["ms"] for r in per_shape),
            "plain_ms": sum(r["plain_ms"] for r in per_shape),
            "bound_ms": by_ops + by_bytes,
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "library_ms": None,
            "per_forward_launches": len(per_shape),
            "check": "passed",  # a failed check exits before this line
        })
    print(json.dumps({"kernels": entries}), flush=True)


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
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)
    run(device, card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
