"""Plain reference of the `pointda_hengshuang` configuration: the Point
Transformer (Zhao, Jiang, Jia, Torr and Koltun, ICCV 2021) in the form of
Point-Transformers' `models/Hengshuang/` (`PointTransformerCls` with the
MLSP `PointTransformerDef` DefRec decoder), its PointDA train step under
PCM on the source and DefRec on the target, and its eval forward.

Functional: the weights are a dict {state_dict name: tensor} in the
reference's layout (`backbone.transformer1.fc_gamma.0.weight`, ...).

  vector attention  per point i over its k = min(k, N) nearest points j
                    (itself included): q, k, v = linear(fc1(x));
                    delta_ij = mlp(p_i - p_j); w_ij = softmax_j(
                    mlp_gamma(q_i - k_j + delta_ij) / sqrt(d_model)), one
                    weight per channel; y_i = fc2(sum_j w_ij (v_j +
                    delta_ij)) + x_i
  transition down   FPS to N / 4 points, each centre's k nearest points
                    of the finer level (a cross-set kNN), [p_j - c | f_j]
                    through two [linear, BatchNorm, ReLU], the max over k
  transition up     both levels through [linear, BatchNorm, ReLU], the
                    coarse one interpolated onto the fine points from its
                    3 nearest (inverse squared distance), summed

Five levels (N, N/4, ..., N/4^nblocks, at least 1 point); channels
base_dim 2^i at level i; the classifier on the mean of the coarsest
features; the decoder back up to every point for the DefRec head on
[decoded | pooled].

Departures from the published description, as the system under test
runs the model (and as `PointDA/hengshuang_transformer/` does):

  * FPS starts at point 0 of every cloud (the published code starts at a
    random point), ties to the lower index;
  * each point's neighbours include itself, ties to the lower index;
  * the classifier pools by the mean of the coarsest level and has no
    dropout, and the decoder's first stage (`fc2`) is 512 wide whatever
    `transformer_dim` is, as the published code has them;
  * the DefRec head (MLSP's, not in Point-Transformers) is the per-point
    [256, 256, 128, 3] head of BatchNorm, ReLU and dropout.

The self-kNN takes the system's kNN kernel's documented distances
(`plain.knn`); the cross-set kNN and the interpolation take the matmul
form of the squared distances (`plain.pairwise_sqdist`). Float32
throughout, TF32 off from import (the configuration states it;
`benchmark/control.py` switches it on around its own calls).

Nothing here imports the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import plain as P

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _levels(cfg) -> list[tuple[int, int]]:
    """(points, channels) of each level, the whole cloud first."""
    N, base = cfg["num_points"], cfg["base_dim"]
    return [(N if i == 0 else max(N // 4 ** i, 1), base * 2 ** i)
            for i in range(cfg["nblocks"] + 1)]


def spec(cfg) -> list[tuple[str, tuple, str]]:
    """Every state_dict entry: (name, shape, kind), kind one of "w" (a
    matmul weight, fan-in its trailing dims), "b" (a bias) and "bn" (a
    BatchNorm: weight, bias, running_mean, running_var,
    num_batches_tracked)."""
    d, nc = cfg["d_model"], cfg["num_class"]
    levels = _levels(cfg)
    base, top = levels[0][1], levels[-1][1]
    out = []

    def lin(name, cin, cout, bias=True, rank=0):
        out.append((f"{name}.weight", (cout, cin) + (1,) * rank, "w"))
        if bias:
            out.append((f"{name}.bias", (cout,), "b"))

    def attention(name, c):
        lin(f"{name}.fc1", c, d)
        for w in ("w_qs", "w_ks", "w_vs"):
            lin(f"{name}.{w}", d, d, False)
        lin(f"{name}.fc_delta.0", 3, d)
        lin(f"{name}.fc_delta.2", d, d)
        lin(f"{name}.fc_gamma.0", d, d)
        lin(f"{name}.fc_gamma.2", d, d)
        lin(f"{name}.fc2", d, c)

    lin("backbone.fc1.0", 3, base)
    lin("backbone.fc1.2", base, base)
    attention("backbone.transformer1", base)
    for i, ((_, cin), (_, c)) in enumerate(zip(levels, levels[1:])):
        t = f"backbone.transition_downs.{i}.sa"
        lin(f"{t}.mlp_convs.0", cin + 3, c, rank=2)
        lin(f"{t}.mlp_convs.1", c, c, rank=2)
        out += [(f"{t}.mlp_bns.0", (c,), "bn"), (f"{t}.mlp_bns.1", (c,), "bn")]
    for i, (_, c) in enumerate(levels[1:]):
        attention(f"backbone.transformers.{i}", c)
    lin("fc2.0", top, 512)
    lin("fc2.2", 512, 512)
    lin("fc2.4", 512, top)
    attention("transformer2", top)
    for j, ((_, c), (_, cc)) in enumerate(reversed(list(zip(levels,
                                                            levels[1:])))):
        for fc, cin in (("fc1", cc), ("fc2", c)):
            lin(f"transition_ups.{j}.{fc}.0", cin, c)
            out.append((f"transition_ups.{j}.{fc}.2", (c,), "bn"))
    for j, (_, c) in enumerate(reversed(levels[:-1])):
        attention(f"transformers.{j}", c)
    lin("cls_head_finetune.0", top, 256)
    lin("cls_head_finetune.2", 256, 64)
    lin("cls_head_finetune.4", 64, nc)
    for j, (a, b) in enumerate(((base + top, 256), (256, 256), (256, 128)),
                               1):
        lin(f"DefRec.conv{j}", a, b, False, rank=1)
        out.append((f"DefRec.bn{j}", (b,), "bn"))
    lin("DefRec.conv4", 128, 3, False, rank=1)
    return out


# ---------------------------------------------------------------- forward

def _lin(W, name, x):
    return F.linear(x, W[f"{name}.weight"].flatten(1), W.get(f"{name}.bias"))


def _mlp(W, name, x, layers: int):
    """[linear, ReLU] x (layers - 1), then a linear: the reference's
    Sequential at indices 0, 2, 4."""
    for j in range(layers - 1):
        x = F.relu(_lin(W, f"{name}.{2 * j}", x))
    return _lin(W, f"{name}.{2 * (layers - 1)}", x)


def _take(x, idx):
    """x [B, N, C] at idx [B, S] -> [B, S, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _nearest(x, y, k: int):
    """(squared distances, indices) of the k nearest points of y [B, M, 3]
    to each point of x [B, N, 3], nearest first, ties to the lower index."""
    d, idx = torch.sort(P.pairwise_sqdist(x, y), dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def vector_attention(W, name, xyz, feats, cfg):
    d = cfg["d_model"]
    x = _lin(W, f"{name}.fc1", feats)
    q, kf, vf = (_lin(W, f"{name}.{w}", x) for w in ("w_qs", "w_ks", "w_vs"))
    idx = P.knn(xyz, min(cfg["k"], xyz.shape[1]))
    delta = _mlp(W, f"{name}.fc_delta", xyz[:, :, None, :]
                 - P.gather(xyz, idx), 2)
    gamma = _mlp(W, f"{name}.fc_gamma", q[:, :, None, :]
                 - P.gather(kf, idx) + delta, 2)
    attn = torch.softmax(gamma / math.sqrt(d), dim=-2)
    y = (attn * (P.gather(vf, idx) + delta)).sum(-2)
    return _lin(W, f"{name}.fc2", y) + feats


def transition_down(W, name, xyz, feats, npoint: int, train: bool, cfg):
    start = torch.zeros(xyz.shape[0], dtype=torch.int64, device=xyz.device)
    centers = _take(xyz, P.fps(xyz, npoint, start))
    _, idx = _nearest(centers, xyz, min(cfg["k"], xyz.shape[1]))
    g = torch.cat([P.gather(xyz, idx) - centers[:, :, None, :],
                   P.gather(feats, idx)], -1)
    for j in (0, 1):
        g = F.relu(P.batch_norm(W, f"{name}.mlp_bns.{j}",
                                _lin(W, f"{name}.mlp_convs.{j}", g), train))
    return centers, g.amax(-2)


def interpolate(xyz_f, xyz_c, f_c):
    """f_c [B, S, C] at xyz_c onto xyz_f [B, N, 3]: its 3 nearest (fewer
    where S < 3), weights 1 / (d^2 + 1e-8) normalised."""
    dk, idx = _nearest(xyz_f, xyz_c, min(3, xyz_c.shape[1]))
    w = 1.0 / (dk + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (P.gather(f_c, idx) * w[..., None]).sum(2)


def transition_up(W, name, xyz_c, f_c, xyz_f, f_f, train: bool):
    def proj(fc, x):
        return F.relu(P.batch_norm(W, f"{name}.{fc}.2",
                                   _lin(W, f"{name}.{fc}.0", x), train))

    return interpolate(xyz_f, xyz_c, proj("fc1", f_c)) + proj("fc2", f_f)


def backbone(W, x, train: bool, cfg) -> list:
    """(xyz, feats) of every level, the whole cloud first."""
    feats = vector_attention(W, "backbone.transformer1", x,
                             _mlp(W, "backbone.fc1", x, 2), cfg)
    taps = [(x, feats)]
    for i, (n, _) in enumerate(_levels(cfg)[1:]):
        xyz, feats = transition_down(W, f"backbone.transition_downs.{i}.sa",
                                     *taps[-1], n, train, cfg)
        taps.append((xyz, vector_attention(
            W, f"backbone.transformers.{i}", xyz, feats, cfg)))
    return taps


def decode(W, taps: list, train: bool, cfg):
    """The decoder back up to every point: [B, N, base_dim]."""
    xyz, feats = taps[-1]
    feats = vector_attention(W, "transformer2", xyz,
                             _mlp(W, "fc2", feats, 3), cfg)
    for j, (xyz_f, f_f) in enumerate(reversed(taps[:-1])):
        feats = vector_attention(W, f"transformers.{j}", xyz_f, transition_up(
            W, f"transition_ups.{j}", xyz, feats, xyz_f, f_f, train), cfg)
        xyz = xyz_f
    return feats


def _defrec_head(W, per_point, pooled, g, train, p):
    drop = lambda t: P.dropout(t, p, train, g)  # noqa: E731
    x = drop(F.relu(P.batch_norm(W, "DefRec.bn1", P.split_dense(
        per_point, pooled, W["DefRec.conv1.weight"]), train)))
    x = drop(F.relu(P.batch_norm(W, "DefRec.bn2", P.dense(
        x, W["DefRec.conv2.weight"]), train)))
    x = F.relu(P.batch_norm(W, "DefRec.bn3", P.dense(
        x, W["DefRec.conv3.weight"]), train))
    return P.dense(x, W["DefRec.conv4.weight"])


def forward(W, x, heads, g, train: bool, cfg) -> dict:
    """x [B, N, 3] -> {"cls" [B, num_class]} and with "defrec" in heads
    {"defrec" [B, N, 3]}; the DefRec head's dropout masks from `g` in
    train mode."""
    taps = backbone(W, x, train, cfg)
    pooled = taps[-1][1].mean(1)
    out = {"cls": _mlp(W, "cls_head_finetune", pooled, 3)}
    if "defrec" in heads:
        out["defrec"] = _defrec_head(W, decode(W, taps, train, cfg), pooled,
                                     g, train, cfg["dropout"])
    return out


def eval_logits(W, x, cfg) -> torch.Tensor:
    """Class logits of clouds x [B, N, 3] in eval mode."""
    with torch.no_grad():
        return forward(W, x, (), None, False, cfg)["cls"]


# ---------------------------------------------------------------- train

def train_loss(W, src_x, src_y, trgt_x, g, cfg) -> torch.Tensor:
    """The recipe's loss for one step, every random number drawn from `g`
    in the recipe's order: the augmentations (source, target), PCM's
    draws (mixup_params 1: a uniform ratio), the target's voxel
    deformation, then the DefRec head's dropout. PCM's mixup
    cross-entropy on the source, DefRec's Chamfer on the deformed
    target."""
    B, N = src_x.shape[:2]
    src = P.augment(src_x, *P.draw_augment(g, src_x))
    trgt = P.augment(trgt_x, *P.draw_augment(g, trgt_x))
    mixed, (ya, yb, lam) = P.pcm_mix(src, src_y, P.draw_pcm(g, B, N))
    dx, mask = P.deform(trgt, *P.draw_deform(g, trgt))
    logits = forward(W, mixed, (), g, True, cfg)["cls"]
    total = (lam * F.cross_entropy(logits, ya)
             + (1.0 - lam) * F.cross_entropy(logits, yb)) * (
        1.0 - cfg["DefRec_weight"])
    out = forward(W, dx, ("defrec",), g, True, cfg)
    return total + P.defrec_loss(out["defrec"], trgt, mask,
                                 cfg["DefRec_weight"])


# ---------------------------------------------------------------- work

def _attention_list(cfg, B) -> list[tuple[int, int, int, int, int]]:
    """(B, N, k, C, d_model) of the backbone's vector attentions."""
    return [(B, n, min(cfg["k"], n), c, cfg["d_model"])
            for n, c in _levels(cfg)]


def train_vector_attentions(cfg) -> list[tuple[int, int, int, int, int]]:
    """(B, N, k, C, d_model) of every vector attention of one step: the
    PCM-mixed source's backbone, the deformed target's backbone, then its
    decoder's, coarsest first."""
    one = _attention_list(cfg, cfg["batch_size"])
    return one + one + one[::-1]


def _attention_ops(b, n, k, c, d) -> float:
    """fc1 and fc2 (C <-> d) and q, k, v per point; the two layers of
    each edge MLP (delta from 3, gamma from d) per edge."""
    return 2.0 * (b * n * (2 * c * d + 3 * d * d)
                  + b * n * k * (3 * d + 3 * d * d))


def _forward_ops(cfg, B, decoded: bool) -> float:
    """Multiply-adds x 2 of one forward's matmuls: the backbone and the
    classifier, with `decoded` the decoder and the DefRec head too."""
    levels = _levels(cfg)
    (N, base), (nt, top) = levels[0], levels[-1]
    k, nc = cfg["k"], cfg["num_class"]
    ops = 2.0 * B * N * (3 * base + base * base)
    for (n0, c0), (n, c) in zip(levels, levels[1:]):
        ops += 2.0 * B * n * min(k, n0) * ((c0 + 3) * c + c * c)
    ops += 2.0 * B * (top * 256 + 256 * 64 + 64 * nc)
    atts = _attention_list(cfg, B)
    if decoded:
        ops += 2.0 * B * nt * (top * 512 + 512 * 512 + 512 * top)
        for (n, c), (nc_, cc) in zip(levels, levels[1:]):
            ops += 2.0 * B * (nc_ * cc * c + n * c * c)
        ops += 2.0 * B * (N * (base * 256 + 256 * 256 + 256 * 128 + 128 * 3)
                          + top * 256)
        atts = atts + atts
    return ops + sum(_attention_ops(*a) for a in atts)


def train_step_ops(cfg) -> dict:
    """Operations of one step's matmuls, float32: the source's forward
    (backbone, classifier) and the target's (backbone, classifier,
    decoder, DefRec head), each backward counted as twice its forward."""
    B = cfg["batch_size"]
    return {"f32": 3 * (_forward_ops(cfg, B, False)
                        + _forward_ops(cfg, B, True)), "bf16": 0.0}
