"""How far two runs of the same train steps part on a CUDA card: eager
against eager, and replayed step graphs (`scan_steps`) against eager.

For each recipe and optimizer, three runs of `--steps` steps from the same
seeded weights, batches and generator seed: two eager (`pointda_train_step`)
and one chunk of replays (`pointda_train_scan`). Prints one JSON line per
(recipe, optimizer, pair) with the worst relative loss gap at each step and
the largest parameter gap after the last, and one line with the gradient gap
of one step taken twice (DGCNN's K2-bwd adds with atomics in no fixed
order). The recipes: DGCNN's paper recipe, and PointNet under PCM and
DefRec on the target, whose step has no atomic add.

Usage: PYTHONPATH=. python3 scripts/torch_step_repro.py [--batch 32]
       [--points 1024] [--steps 3]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess

import torch

from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.train.graphs import Graphs
from mlsp_tpu_torch.train.state import make_optimizer
from mlsp_tpu_torch.train.steps import (
    pointda_step,
    pointda_train_scan,
    pointda_train_step,
)
from mlsp_tpu_torch.utils.config import PointDAConfig


def recipes(b: int, n: int) -> dict:
    base = PointDAConfig(num_points=n, batch_size=b)
    return {"dgcnn_paper": ("dgcnn", base.paper_recipe),
            "pointnet_pcm_defrec": ("pointnet", dataclasses.replace(
                base.resolved(), DefRec_on_trgt=True))}


def run(name, cfg, opt_name, lr, route, x, y, card) -> tuple:
    model = make_model(name, 10, device=card,
                       generator=torch.Generator().manual_seed(0)).train()
    opt, sched = make_optimizer(model, lr, cfg.wd, 1, 100, opt_name)
    gen = torch.Generator(device=card).manual_seed(3)
    if route == "graph":
        m = pointda_train_scan(model, opt, sched, x, y, x.flip(1), gen, cfg,
                               Graphs())
    else:
        steps = [pointda_train_step(model, opt, sched, x[i], y[i],
                                    x[i].flip(0), gen, cfg)
                 for i in range(len(x))]
        m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    torch.cuda.synchronize()
    params = {k: p.detach().double().cpu()
              for k, p in model.named_parameters()}
    return {k: v.double().cpu() for k, v in m.items()}, params


def gaps(a, b) -> dict:
    (ma, pa), (mb, pb) = a, b
    steps = len(next(iter(mb.values())))
    return {"loss_rel_gap_per_step": [
                max(float(abs(ma[k][i] - mb[k][i])
                          / max(abs(float(mb[k][i])), 1e-12)) for k in mb)
                for i in range(steps)],
            "param_max_abs_gap": max(float((pa[k] - pb[k]).abs().max())
                                     for k in pb),
            "bit_equal": all(torch.equal(ma[k], mb[k]) for k in mb)
            and all(torch.equal(pa[k], pb[k]) for k in pb)}


def grad_gap(name, cfg, x, y, card) -> dict:
    model = make_model(name, 10, device=card,
                       generator=torch.Generator().manual_seed(0)).train()
    grads = []
    for _ in range(2):
        m = copy.deepcopy(model)
        opt, _ = make_optimizer(m, 0.0, cfg.wd, 1, 100, "SGD")
        pointda_step(m, opt, x[0], y[0], x[0].flip(0),
                     torch.Generator(device=card).manual_seed(3), cfg)
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()
                      if p.grad is not None})
    return {"grad_max_abs_gap": max(float((grads[0][k] - grads[1][k]).abs()
                                          .max()) for k in grads[0]),
            "grad_tensors_bit_equal": sum(torch.equal(grads[0][k],
                                                      grads[1][k])
                                          for k in grads[0]),
            "grad_tensors": len(grads[0])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    b, n, s = args.batch, args.points, args.steps
    x, y = make_classification(s * b, n, 10, seed=1)
    x = torch.from_numpy(x).to(card).view(s, b, n, 3)
    y = torch.from_numpy(y).to(card).view(s, b)
    for recipe, (name, cfg) in recipes(b, n).items():
        print(json.dumps({"recipe": recipe, "card": smi,
                          **grad_gap(name, cfg, x, y, card)}), flush=True)
        for opt_name, lr in (("ADAM", 1e-3), ("SGD", 1e-2)):
            runs = [run(name, cfg, opt_name, lr, route, x, y, card)
                    for route in ("eager", "eager", "graph")]
            for pair, (i, j) in (("eager_vs_eager", (1, 0)),
                                 ("graph_vs_eager", (2, 0))):
                print(json.dumps({"recipe": recipe, "optimizer": opt_name,
                                  "lr": lr, "batch": b, "points": n,
                                  "pair": pair, "card": smi,
                                  **gaps(runs[i], runs[j])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
