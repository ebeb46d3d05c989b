"""Replayed and eager train-step p50 of two trees of the port on one card.

Runs `chip_smoke.graph_step_times` (chunks of 8 replays of the captured
paper, all-branch and seg steps against eager steps, interleaved) of each
tree in a process of its own, in the order A, B, B, A, so that both meet
the card in the same states. Each process builds the kernels of its own
tree. Prints one JSON line per run and a summary with each recipe's
replayed p50 by tree (the median of its two runs) and B's ratio to A.

Usage: python3 scripts/torch_step_p50.py --a PARENT_TREE --b . \
           [--out step_p50.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
res = chip_smoke.graph_step_times(torch.device('cuda'), chip_smoke.nvidia_smi())
print('RESULT ' + json.dumps(res))
"""


def run_tree(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree, text=True,
                         capture_output=True, timeout=1200)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode or not line:
        raise RuntimeError(f"{tree}: rc {out.returncode}\n{out.stdout[-3000:]}"
                           f"\n{out.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="tree A (the parent)")
    ap.add_argument("--b", default=".", help="tree B (this change)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    runs = {"a": [], "b": []}
    for which in ("a", "b", "b", "a"):
        res = run_tree(trees[which])
        runs[which].append(res)
        print(json.dumps({"tree": which, "path": trees[which],
                          **{name: {k: r[k] for k in (
                              "graph_step_p50_ms", "eager_step_p50_ms",
                              "card")} for name, r in res.items()}}),
              flush=True)
    summary = {}
    for name in runs["a"][0]:
        p50 = {w: statistics.median(r[name]["graph_step_p50_ms"]
                                    for r in runs[w]) for w in runs}
        eager = {w: statistics.median(r[name]["eager_step_p50_ms"]
                                      for r in runs[w]) for w in runs}
        summary[name] = {"replayed_p50_ms": p50, "eager_p50_ms": eager,
                         "replayed_b_over_a": p50["b"] / p50["a"],
                         "runs_replayed_ms": {
                             w: [r[name]["graph_step_p50_ms"]
                                 for r in runs[w]] for w in runs}}
    line = {"summary": summary, "trees": trees,
            "card": runs["a"][0]["paper"]["card"]}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, **line}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
