"""What a CUDA-graph capture of the port's train step meets on the card.

Usage: PYTHONPATH=. python scripts/torch_capture_probe.py [PACKAGE_ROOT]

Each probe runs in its own process (a failed capture can leave the
context unusable) and prints one JSON line:

  kernels     each kernel wrapper (K1, K2-fwd, K2-bwd, K3, K4) launched
              inside `torch.cuda.graph` after an eager launch, the replay
              against the eager output (the launchers call
              `cudaFuncSetAttribute`: is that legal while capturing?)
  rng         torch.rand/randn/randint/randperm/argsort and PCM's
              Beta(a, a) ratios (`steps.draw_mix_ratio` at a = 1e-3, 0.4,
              2.0: `torch._standard_gamma` and `torch.rand`) drawn from a
              `torch.Generator` registered with the graph, a replay
              against the same draws taken eagerly from the same state
  lr          LambdaLR and an optimizer with a tensor LR: is it written in
              place, is `initial_lr` a copy
  step        the paper-recipe PointDA step at B=32, N=1024 (Adam,
              capturable, tensor LR), captured after one warm-up step on a
              side stream: capture, one replay, and the step p50 of
              replays against eager steps; then the same with SGD (fused,
              tensor LR)

PACKAGE_ROOT (default: the repository) is put first on sys.path, so the
probe can run against another tree's `mlsp_tpu_torch` (a parent commit
unpacked with `git archive`).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import torch

PROBES = ("kernels", "rng", "lr", "step")


def emit(probe: str, **fields) -> None:
    print(json.dumps({"probe": probe, **fields}), flush=True)


def capture(fn):
    """(graph, static output) of fn() captured."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    return g, out


def probe_kernels() -> dict:
    from mlsp_tpu_torch.ops.kernels import (
        edge_moments_bwd_cuda,
        edge_moments_cuda,
        fps_cuda,
        knn_cuda,
        knn_moments_cuda,
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(32, 1024, 64, device="cuda", generator=g)
    p = torch.randn(64, 1024, 3, device="cuda", generator=g)
    start = torch.randint(0, 1024, (64,), device="cuda", generator=g)
    idx = knn_cuda(x, 20)
    cots = [torch.randn_like(x) for _ in range(4)]
    outs = edge_moments_cuda(x, idx, True)
    cases = {
        "knn": lambda: knn_cuda(x, 20),
        "knn_moments": lambda: knn_moments_cuda(p[:32], 20),
        "fps": lambda: fps_cuda(p, 1024, start),
        "edge_moments": lambda: edge_moments_cuda(x, idx, True),
        "edge_moments_bwd": lambda: edge_moments_bwd_cuda(
            x, idx, outs[0], outs[1], *cots),
    }
    res = {}
    for name, fn in cases.items():
        try:
            want = fn()
            graph, got = capture(fn)
            graph.replay()
            torch.cuda.synchronize()
            w = want if isinstance(want, (tuple, list)) else [want]
            o = got if isinstance(got, (tuple, list)) else [got]
            res[name] = {"captured": True, "max_abs_err": max(
                float((a.double() - b.double()).abs().max())
                for a, b in zip(o, w))}
        except Exception as e:  # noqa: BLE001 - the probe reports it
            res[name] = {"captured": False, "error": repr(e)[:400]}
    return res


def probe_rng() -> dict:
    from mlsp_tpu_torch.train.steps import draw_mix_ratio

    def draws(gen):
        dev = gen.device
        return [*(draw_mix_ratio(gen, a, (4096,)) for a in (1e-3, 0.4, 2.0)),
                torch.rand(32, generator=gen, device=dev),
                torch.randn(32, 1024, 3, generator=gen, device=dev),
                torch.randint(0, 1024, (64,), generator=gen, device=dev),
                torch.randperm(32, generator=gen, device=dev),
                torch.randperm(1024, generator=gen, device=dev),
                torch.argsort(torch.rand(32, 27, generator=gen, device=dev),
                              -1)]

    gen = torch.Generator(device="cuda").manual_seed(5)
    state = gen.get_state()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = draws(gen)
    after_capture = bool(torch.equal(gen.get_state(), state))
    res = {"register_generator_state": True,
           "state_unchanged_by_capture": after_capture}
    gen.set_state(state)
    graph.replay()
    replay = [t.clone() for t in out]
    replay_state = gen.get_state()
    gen.set_state(state)
    eager = draws(gen)
    res["bit_equal"] = [bool(torch.equal(a, b)) for a, b in zip(replay, eager)]
    res["offset_equal_after"] = bool(torch.equal(gen.get_state(),
                                                 replay_state))
    # a second replay continues the stream as a second eager call does
    gen.set_state(state)
    graph.replay()
    graph.replay()
    gen.set_state(state)
    draws(gen)
    res["second_replay_bit_equal"] = [bool(torch.equal(a, b))
                                      for a, b in zip(out, draws(gen))]
    # reseeding a registered generator in place
    gen.manual_seed(5)
    graph.replay()
    gen.manual_seed(5)
    res["reseed_bit_equal"] = [bool(torch.equal(a, b))
                               for a, b in zip(out, draws(gen))]
    return res


def probe_lr() -> dict:
    w = torch.nn.Parameter(torch.ones(4, device="cuda"))
    lr = torch.tensor(0.5, device="cuda")
    opt = torch.optim.Adam([w], lr=lr, capturable=True)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0 / (s + 1))
    same_before = opt.param_groups[0]["lr"] is lr
    init = opt.param_groups[0]["initial_lr"]
    for _ in range(3):
        w.grad = torch.ones_like(w)
        opt.step()
        sched.step()
    group = opt.param_groups[0]
    sd = opt.state_dict()
    opt2 = torch.optim.Adam([w], lr=torch.tensor(0.1, device="cuda"),
                            capturable=True)
    lr2 = opt2.param_groups[0]["lr"]
    opt2.load_state_dict(sd)
    return {"lr_object_kept": same_before and group["lr"] is lr,
            "lr_value": float(group["lr"]),
            "initial_lr_is_copy": init is not lr, "initial_lr": float(init),
            "load_state_dict_keeps_lr_object":
                opt2.param_groups[0]["lr"] is lr2,
            "loaded_lr_type": type(opt2.param_groups[0]["lr"]).__name__,
            "loaded_step_device": str(opt2.state[w]["step"].device)}


def probe_step() -> dict:
    import chip_smoke as cs
    from mlsp_tpu_torch.train import pointda_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.train_cfg()
    batch = cs.train_batches(cfg, "cuda")[0]
    res = {}
    for name in ("adam", "sgd"):
        model = cs.train_model(cfg, "cuda")
        params = [p for p in model.parameters() if p.requires_grad]
        lr = torch.tensor(cfg.lr, device="cuda")
        opt = (torch.optim.Adam(params, lr=lr, weight_decay=cfg.wd,
                                capturable=True) if name == "adam" else
               torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=cfg.wd, fused=True))
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            return pointda_train_step(model, opt, sched, *batch, gen, cfg)

        r = {}
        try:
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                step()
            torch.cuda.current_stream().wait_stream(s)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                out = step()
            r["capture_s"] = time.perf_counter() - t0
            graph.replay()
            torch.cuda.synchronize()
            r["replay_losses"] = {k: float(v) for k, v in out.items()}
            r["captured"] = True
        except Exception:  # noqa: BLE001 - the probe reports it
            r["captured"] = False
            r["error"] = traceback.format_exc()[-3000:]
            res[name] = r
            continue

        def p50(fn, n=15):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        r["replay_p50_ms"] = p50(graph.replay)
        r["eager_p50_ms"] = p50(step)
        r["replay_p50_ms_again"] = p50(graph.replay)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res[name] = r
    return res


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--probe":
        sys.path.insert(0, sys.argv[2])
        name = sys.argv[3]
        try:
            out = {"kernels": probe_kernels, "rng": probe_rng,
                   "lr": probe_lr, "step": probe_step}[name]()
            emit(name, ok=True, torch=torch.__version__, result=out)
        except Exception:  # noqa: BLE001 - the probe reports it
            emit(name, ok=False, error=traceback.format_exc()[-3000:])
        return 0
    if not torch.cuda.is_available():
        print("torch_capture_probe: no CUDA device", file=sys.stderr)
        return 1
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from mlsp_tpu_torch.ops.kernels import _build

    _build.build_all()
    for name in PROBES:
        subprocess.run([sys.executable, __file__, "--probe", root, name],
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
