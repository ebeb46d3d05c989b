"""Whether the port's train steps are bit-reproducible on a CUDA card.

For each step (the DGCNN paper recipe; the all-branch PointDA recipe, whose
target batch is a `Scan_on_trgt` batch; the PointSegDA step; the SPST step;
PointNet, PointNet++, PointTransformer, Hengshuang and Point-ViT with the
`dgcnn` group embedder under their recipes), runs of `--steps` steps from
the same seeded weights, batches and generator seed: two eager runs and two
runs as one chunk of replays of a captured step graph (`*_train_scan`).
Prints one JSON line per step with, for each route, whether the two runs
are bit-equal in their losses, their last gradients, their parameters and
buffers and their optimizer state (and the first tensors that differ),
the largest relative gap of the replays from the eager steps (not required
to be 0: a replayed step is a different program), and, where the eager runs
part, the modules whose backward (or forward) first differs, found with
module hooks on one step taken twice. Exits 1 if a step's two runs part.

Usage: python3 scripts/torch_step_repro.py [--steps 3]
       [--only dgcnn_paper,seg ...]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

import torch

# the repository's chip_smoke.py (the port's), not scripts/chip_smoke.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from mlsp_tpu_torch.data.synthetic import make_classification  # noqa: E402
from mlsp_tpu_torch.train.graphs import Graphs  # noqa: E402
from mlsp_tpu_torch.train.seg_steps import (  # noqa: E402
    pointsegda_train_scan,
    pointsegda_train_step,
)
from mlsp_tpu_torch.train.spst import (  # noqa: E402
    spst_train_scan,
    spst_train_step,
)
from mlsp_tpu_torch.train.state import (  # noqa: E402
    make_epoch_lr_optimizer,
    make_optimizer,
)
from mlsp_tpu_torch.train.steps import (  # noqa: E402
    pointda_train_scan,
    pointda_train_step,
)
from mlsp_tpu_torch.utils.config import SPSTConfig  # noqa: E402

GEN_SEED = 3


@dataclasses.dataclass
class Case:
    """One step: `build()` -> (model, cfg), `optimizer(model, cfg)` ->
    (opt, sched or None), the batches stacked [S, ...], and the eager step
    and the scan of the step's kind."""
    build: object
    optimizer: object
    batches: tuple
    eager: object
    scan: object


def pointda_case(cfg, build, card, steps: int) -> Case:
    x, y = make_classification(2 * steps * cfg.batch_size, cfg.num_points,
                               cfg.num_class, seed=cs.SEED + 3)
    x = torch.from_numpy(x).to(card).view(steps, 2, cfg.batch_size,
                                          cfg.num_points, 3)
    y = torch.from_numpy(y).to(card).view(steps, 2, cfg.batch_size)
    return Case(
        build=lambda: (build(cfg), cfg),
        optimizer=lambda m, c: make_optimizer(m, c.lr, c.wd, c.epochs,
                                              cs.STEPS_PER_EPOCH),
        batches=(x[:, 0], y[:, 0], x[:, 1]),
        eager=lambda m, o, s, b, g, c: pointda_train_step(m, o, s, *b, g, c),
        scan=lambda m, o, s, b, g, c, gr: pointda_train_scan(m, o, s, *b, g,
                                                             c, gr))


def seg_case(card, steps: int) -> Case:
    cfg = cs.seg_cfg()
    batches = cs.seg_batches(cfg, card)
    stack = tuple(torch.stack([batches[i % len(batches)][j]
                               for i in range(steps)]) for j in range(3))
    return Case(
        build=lambda: (cs.seg_model(cfg, card), cfg),
        optimizer=lambda m, c: make_optimizer(m, c.lr, c.wd, c.epochs,
                                              cs.STEPS_PER_EPOCH),
        batches=stack,
        eager=lambda m, o, s, b, g, c: pointsegda_train_step(m, o, s, *b, g,
                                                             c)[0],
        scan=lambda m, o, s, b, g, c, gr: pointsegda_train_scan(
            m, o, s, *b, g, c, gr)[0])


def spst_case(card, steps: int) -> Case:
    cfg = dataclasses.replace(SPSTConfig(), apply_PCM=True)
    x, y = make_classification(2 * steps * cfg.batch_size, cfg.num_points,
                               10, seed=cs.SEED + 5)
    x = torch.from_numpy(x).to(card).view(steps, 2, cfg.batch_size,
                                          cfg.num_points, 3)
    y = torch.from_numpy(y).to(card).view(steps, 2, cfg.batch_size)
    weights = (1.0, 0.5)
    return Case(
        build=lambda: (cs.train_model(cs.train_cfg(), card), cfg),
        optimizer=lambda m, c: (make_epoch_lr_optimizer(
            m, c.optimizer, c.lr, c.wd, c.momentum), None),
        batches=(x[:, 0], y[:, 0], x[:, 1], y[:, 1]),
        eager=lambda m, o, s, b, g, c: spst_train_step(m, o, *b, *weights,
                                                       g, c),
        scan=lambda m, o, s, b, g, c, gr: spst_train_scan(m, o, *b, *weights,
                                                          g, c, gr))


def cases(card, steps: int) -> dict:
    paper = cs.train_cfg()
    build = {"dgcnn": lambda c: cs.train_model(c, card)}
    out = {"dgcnn_paper": pointda_case(paper, build["dgcnn"], card, steps),
           "all_branch": pointda_case(
               dataclasses.replace(paper, **cs.ALL_BRANCHES), build["dgcnn"],
               card, steps),
           "seg": seg_case(card, steps),
           "spst": spst_case(card, steps)}
    for name in ("pointnet", "pointnet2", "point_transformer", "hengshuang"):
        out[name] = pointda_case(cs.fam_cfg(name), lambda c, n=name:
                                 cs.fam_model(n, c, card), card, steps)
    out["vit_dgcnn"] = pointda_case(
        cs.fam_cfg("vit"),
        lambda c: cs.fam_model("vit", c, card, encoder_type="dgcnn"), card,
        steps)
    return out


def state_of(model, opt) -> dict:
    out = {f"model.{k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    out.update({f"grad.{k}": p.grad.detach().clone()
                for k, p in model.named_parameters() if p.grad is not None})
    for i, st in enumerate(opt.state.values()):
        out.update({f"opt.{i}.{k}": v.detach().clone()
                    for k, v in st.items() if torch.is_tensor(v)})
    return out


def run(case: Case, init: dict, route: str) -> tuple[dict, dict]:
    model, cfg = case.build()
    model.load_state_dict(init)
    opt, sched = case.optimizer(model, cfg)
    gen = torch.Generator(device=case.batches[0].device).manual_seed(GEN_SEED)
    S = case.batches[0].shape[0]
    if route == "graph":
        m = case.scan(model, opt, sched, case.batches, gen, cfg, Graphs())
    else:
        steps = [case.eager(model, opt, sched, [t[i] for t in case.batches],
                            gen, cfg) for i in range(S)]
        m = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    torch.cuda.synchronize()
    return ({k: v.detach().clone() for k, v in m.items()},
            state_of(model, opt))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise (NaNs and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(kind), b.view(kind))
    return torch.equal(a, b)


def compare(a: tuple, b: tuple) -> dict:
    (la, sa), (lb, sb) = a, b
    losses = [k for k in la if not same_bits(la[k], lb[k])]
    state = [k for k in sa if not same_bits(sa[k], sb[k])]
    grads = [k for k in state if k.startswith("grad.")]
    return {"bit_equal": not losses and not state and sa.keys() == sb.keys(),
            "losses_differ": losses, "grads_differ": len(grads),
            "grads": sum(k.startswith("grad.") for k in sa),
            "state_differ": len(state), "state": len(sa),
            "first_differ": state[:4]}


def rel_gap(a: tuple, b: tuple) -> dict:
    (la, sa), (lb, sb) = a, b
    loss = max(float(((la[k].double() - lb[k].double()).abs()
                      / lb[k].double().abs().clamp_min(1e-12)).max())
               for k in lb)
    state = max(float((sa[k].double() - sb[k].double()).abs().max()
                      / max(float(sb[k].double().abs().max()), 1e-30))
                for k in sb if k in sa and sb[k].is_floating_point())
    return {"loss_rel_gap_max": loss, "state_rel_gap_max": state}


def locate(case: Case, init: dict) -> list:
    """One eager step taken twice with hooks on every module: the modules
    whose forward output differs first, else those whose backward gives
    different input gradients from equal output gradients."""
    records = []
    for _ in range(2):
        model, cfg = case.build()
        model.load_state_dict(init)
        opt, sched = case.optimizer(model, cfg)
        rec = {"fwd": {}, "bwd": {}}
        hooks = []

        def first(t):
            if isinstance(t, (tuple, list)):
                t = next((x for x in t if torch.is_tensor(x)), None)
            elif isinstance(t, dict):
                t = next((x for x in t.values() if torch.is_tensor(x)), None)
            return None if t is None else t.detach().clone()

        for name, mod in model.named_modules():
            def fwd(m, args, out, name=name):
                rec["fwd"].setdefault(name, []).append(first(out))

            def bwd(m, gin, gout, name=name):
                rec["bwd"].setdefault(name, []).append(
                    (first(gin), first(gout)))
            hooks.append(mod.register_forward_hook(fwd))
            try:
                hooks.append(mod.register_full_backward_hook(bwd))
            except RuntimeError:
                pass
        gen = torch.Generator(device=case.batches[0].device).manual_seed(
            GEN_SEED)
        try:
            case.eager(model, opt, sched, [t[0] for t in case.batches], gen,
                       cfg)
        except RuntimeError as e:  # a hook that autograd refuses
            return [f"hooks refused: {e}"[:200]]
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        records.append(rec)
    a, b = records

    def differ(x, y):
        return (x is None) != (y is None) or (x is not None
                                              and not same_bits(x, y))

    fwd = [n for n in a["fwd"] if any(differ(x, y) for x, y in
                                      zip(a["fwd"][n], b["fwd"][n]))]
    if fwd:
        return [f"forward: {n or '<model>'}" for n in fwd[:4]]
    bwd = []
    for n in a["bwd"]:
        for (gi, go), (hi, ho) in zip(a["bwd"][n], b["bwd"][n]):
            if not differ(go, ho) and differ(gi, hi):
                bwd.append(f"backward: {n or '<model>'}")
                break
    return bwd[:6] or ["no module boundary shows it"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="comma-separated step names (default: all)")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    smi = cs.nvidia_smi()
    todo = cases(card, args.steps)
    if args.only:
        todo = {k: todo[k] for k in args.only.split(",")}
    table = {}
    for name, case in todo.items():
        model, _ = case.build()
        init = copy.deepcopy(model.state_dict())
        del model
        runs = {r: [run(case, init, r) for _ in range(2)]
                for r in ("eager", "graph")}
        res = {"step": name, "steps": args.steps, "card": smi,
               "eager": compare(*runs["eager"]),
               "graph": compare(*runs["graph"]),
               "graph_vs_eager": rel_gap(runs["graph"][0],
                                         runs["eager"][0])}
        if not res["eager"]["bit_equal"]:
            res["parts_at"] = locate(case, init)
        table[name] = res["eager"]["bit_equal"] and res["graph"]["bit_equal"]
        print(json.dumps(res), flush=True)
        del runs
        torch.cuda.empty_cache()
    print(json.dumps({"bit_reproducible": table, "card": smi}), flush=True)
    return 0 if all(table.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
