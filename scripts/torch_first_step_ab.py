"""How far `chip_smoke.py`'s train-mode first-step check (the paper step
through the kernels against the plain route on its kNN graphs, B=32,
N=1024) moves with the rounding of the dense layers, at three seeds.

Usage: PYTHONPATH=ROOT python scripts/torch_first_step_ab.py ROOT VARIANT

ROOT is the tree to import (this one, or a parent commit unpacked with
`git archive`); VARIANT patches the tree's `models.layers`:
  as_is        the tree as it is
  bias_after   every bias added after the rounded product, float32 too
  parent_like  the bias fused into the product and LeakyReLU's slope 0.2
               at every dtype (the port before `compute_dtype`)
Prints one JSON line: per seed, the plain route's gradient gaps (max,
median), the largest loss gap and how many tensors leave the bounds.
Run one process per variant, all in one call, to compare them.
"""

import json
import sys

import torch
import torch.nn.functional as F


def patch(variant: str) -> None:
    from mlsp_tpu_torch.models import dgcnn, layers

    def dense(x, weight, bias=None, dtype=None):
        dt = dtype or torch.promote_types(x.dtype, weight.dtype)
        b = None if bias is None else bias.to(dt)
        if variant == "parent_like" or b is None:
            return F.linear(x.to(dt), weight.to(dt), b)
        return F.linear(x.to(dt), weight.to(dt)) + b

    def leaky(x):
        return F.leaky_relu(x, 0.2)

    layers.dense = dgcnn.dense = dense
    if variant == "parent_like":
        layers.leaky_relu = dgcnn.leaky_relu = leaky
        layers.act_fn = lambda name: F.relu if name == "relu" else leaky


def main() -> int:
    root, variant = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import chip_smoke as cs

    if variant != "as_is":
        patch(variant)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs._build.build_all()
    out = {"variant": variant, "card": cs.nvidia_smi()}
    for seed in (0, 100, 200):
        cs.SEED = seed
        cfg = cs.train_cfg()
        batch = cs.train_batches(cfg, device)[0]
        model = cs.train_model(cfg, device)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        c = cs.compare_first_step(cfg, batch, init, device)
        out[seed] = {"grad_gap_plain": c["grad_gap_plain"],
                     "loss_gap_max": max(v["rel_gap_plain"]
                                         for v in c["losses"].values()),
                     "outside": len(c["outside"])}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
