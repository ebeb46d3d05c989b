"""Plain reference of the `pointsegda_dgcnnseg` configuration: the PointSegDA
segmentation DGCNN (`PointSegDA/Models.py`: a transform net without
BatchNorm, three linear edge blocks, a 1024-wide global feature, the seg,
DefRec, normal and density heads), its train step under the MLSP recipe
with PCM, and its eval forward. All float32.

The linear edge blocks take the parameterisation of the JAX package's
`LinearEdgeBlock` (a `w_diff` chain and a biased `w_center` chain), in
which the reference's double conv over the edge input is the edge value
u_j - u_i + w_i, whose max over the k neighbours is max_j u_j - u_i + w_i.
The kNN graphs take the port's kernel's documented distances
(`plain.knn`).

Nothing here imports the system under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import plain as P

BLOCKS = {"edge1": (3, (64, 64)), "edge2": (64, (64, 64)), "edge3": (64, (64,))}


def spec(cfg) -> list[tuple[str, tuple, str]]:
    """Every state_dict entry as `pointda_dgcnn.spec` names them."""
    nc, dc = cfg["num_class"], cfg["density_num_class"]
    out = []
    t = "input_transform_net"
    for j, (a, b) in enumerate(((6, 64), (64, 128), (128, 1024)), 1):
        out.append((f"{t}.conv2d{j}.conv.0.weight", (b, a, 1, 1), "w"))
    for name, a, b in (("fc1", 1024, 512), ("fc2", 512, 256)):
        out += [(f"{t}.{name}.fc.0.weight", (b, a), "w"),
                (f"{t}.{name}.fc.0.bias", (b,), "b")]
    out += [(f"{t}.fc3.weight", (9, 256), "w"), (f"{t}.fc3.bias", (9,), "b")]
    for blk, (cin, widths) in BLOCKS.items():
        dims = (cin, *widths)
        for j, (a, b) in enumerate(zip(dims, dims[1:])):
            s = f"shared_layers.{blk}"
            out += [(f"{s}.w_diff{j}.weight", (b, a), "w"),
                    (f"{s}.w_center{j}.weight", (b, a), "w"),
                    (f"{s}.w_center{j}.bias", (b,), "b")]
    cat = sum(w[-1] for _, w in BLOCKS.values())
    emb = cfg["emb_dims"]
    out += [("shared_layers.conv6.weight", (emb, cat, 1), "w"),
            ("shared_layers.conv6.bias", (emb,), "b")]
    hin = cat + emb
    for h, width, bias in (("seg", nc, True), ("DefRec", 3, True),
                           ("Norm_pred", 3, False)):
        for j, (a, b) in enumerate(((hin, 256), (256, 256), (256, 128),
                                    (128, width)), 1):
            out.append((f"{h}.conv{j}.weight", (b, a, 1), "w"))
            if bias:
                out.append((f"{h}.conv{j}.bias", (b,), "b"))
            if j < 4:
                out.append((f"{h}.bn{j}", (b,), "bn"))
    out.append(("Density_cls.conv1.weight", (512, hin, 1), "w"))
    out.append(("Density_cls.bn1", (512,), "bn"))
    for name, a, b in (("mlp1", 512, 256), ("mlp2", 256, 256)):
        out += [(f"Density_cls.{name}.fc.0.weight", (b, a), "w"),
                (f"Density_cls.{name}.fc.0.bias", (b,), "b"),
                (f"Density_cls.{name}.fc.1", (b,), "bn")]
    out += [("Density_cls.mlp3.weight", (dc, 256), "w"),
            ("Density_cls.mlp3.bias", (dc,), "b"),
            ("Density_cls.fc2.weight", (1, dc), "bins")]
    return out


# ---------------------------------------------------------------- forward

def _transform(W, e):
    t = "input_transform_net"
    for j in (1, 2):
        e = P.leaky_relu(P.dense(e, W[f"{t}.conv2d{j}.conv.0.weight"]))
    x = P.leaky_relu(P.dense(e.amax(-2), W[f"{t}.conv2d3.conv.0.weight"]))
    x = x.amax(-2)
    for name in ("fc1", "fc2"):
        x = P.leaky_relu(P.dense(x, W[f"{t}.{name}.fc.0.weight"],
                                 W[f"{t}.{name}.fc.0.bias"]))
    x = P.dense(x, W[f"{t}.fc3.weight"], W[f"{t}.fc3.bias"])
    eye = torch.eye(3, device=x.device).reshape(-1)
    return (x + eye).reshape(-1, 3, 3)


def _edge_block(W, blk, x, k):
    """The block's edge value u_j - u_i + w_i, max over the neighbours of
    the kNN graph of x: max_j u_j - u_i + w_i."""
    depth = len(BLOCKS[blk][1])
    u = w = x
    for j in range(depth):
        s = f"shared_layers.{blk}"
        u = P.dense(u, W[f"{s}.w_diff{j}.weight"])
        w = P.dense(w, W[f"{s}.w_center{j}.weight"], W[f"{s}.w_center{j}.bias"])
    return P.gather(u, P.knn(x, k)).amax(-2) - u + w


def _head(W, h, pp, g, train, p):
    drop = lambda t: P.dropout(t, p, train, g)  # noqa: E731
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn1", P.split_dense(
        *pp, W[f"{h}.conv1.weight"], W.get(f"{h}.conv1.bias")), train)))
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn2", P.dense(
        x, W[f"{h}.conv2.weight"], W.get(f"{h}.conv2.bias")), train)))
    x = F.relu(P.batch_norm(W, f"{h}.bn3", P.dense(
        x, W[f"{h}.conv3.weight"], W.get(f"{h}.conv3.bias")), train))
    return P.dense(x, W[f"{h}.conv4.weight"], W.get(f"{h}.conv4.bias"))


def _density_head(W, pp, g, train, p):
    h = "Density_cls"
    drop = lambda t: P.dropout(t, p, train, g)  # noqa: E731
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn1", P.split_dense(
        *pp, W[f"{h}.conv1.weight"]), train)))
    for name in ("mlp1", "mlp2"):
        x = drop(P.leaky_relu(P.batch_norm(W, f"{h}.{name}.fc.1", P.dense(
            x, W[f"{h}.{name}.fc.0.weight"], W[f"{h}.{name}.fc.0.bias"]),
            train)))
    pv = torch.softmax(P.dense(x, W[f"{h}.mlp3.weight"], W[f"{h}.mlp3.bias"]),
                       -1)
    return pv, (pv * W[f"{h}.fc2.weight"][0]).sum(-1)


def forward(W, x, heads, g, train: bool, cfg) -> dict:
    """x [B, N, 3] -> the heads asked for: "seg" [B, N, num_class],
    "defrec", "normal" [B, N, 3], "density" with "density_mse"."""
    k, p = cfg["k"], cfg["dropout"]
    T = _transform(W, P.edge_features(x, P.knn(x, k)))
    h = torch.einsum("bnc,bdc->bnd", x, T)
    feats = []
    for blk in BLOCKS:
        h = _edge_block(W, blk, h, k)
        feats.append(h)
    x123 = torch.cat(feats, -1)
    x5 = P.dense(x123, W["shared_layers.conv6.weight"],
                 W["shared_layers.conv6.bias"]).amax(1)
    pp, out = (x123, x5), {}
    for name, h in (("seg", "seg"), ("defrec", "DefRec"),
                    ("normal", "Norm_pred")):
        if name in heads:
            out[name] = _head(W, h, pp, g, train, p)
    if "density" in heads:
        out["density"], out["density_mse"] = _density_head(W, pp, g, train, p)
    return out


def eval_logits(W, x, cfg) -> torch.Tensor:
    """Per-point seg logits [B, N, num_class] in eval mode."""
    with torch.no_grad():
        return forward(W, x, ("seg",), None, False, cfg)["seg"]


# ---------------------------------------------------------------- train

def train_loss(W, src_x, src_y, trgt_x, g, cfg) -> torch.Tensor:
    """The MLSP recipe with PCM for one step: augmentations, PCM on the
    source clouds and their point labels, the target's deformation, the
    seg cross-entropy on the mixed clouds, then DefRec, normals and
    density on the deformed target (deformed points weigh 2)."""
    B, N = src_x.shape[:2]
    src = P.augment(src_x, *P.draw_augment(g, src_x))
    trgt = P.augment(trgt_x, *P.draw_augment(g, trgt_x))
    mixed, mixed_y = P.pcm_mix(src, src_y, P.draw_pcm(g, B, N), True)
    dx, mask = P.deform(trgt, *P.draw_deform(g, trgt))
    logits = forward(W, mixed, ("seg",), g, True, cfg)["seg"]
    total = (1.0 - cfg["DefRec_weight"]) * F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), mixed_y.reshape(-1))
    n_gt = P.normals(trgt, cfg["near"])
    C = cfg["density_num_class"]
    dvec, dval = P.density_labels(trgt, cfg["density_radius"], C,
                                  cfg["pergroup"], cfg["shift"])
    out = forward(W, dx, ("defrec", "normal", "density"), g, True, cfg)
    total = total + P.defrec_loss(out["defrec"], trgt, mask,
                                  cfg["DefRec_weight"])
    w = mask + 1.0
    total = total + P.masked_normal_loss(out["normal"], n_gt, w,
                                         cfg["normal_pred_weight"])
    kl, mae = P.density_loss(out["density"].reshape(-1, C),
                             out["density_mse"].reshape(-1),
                             dvec.reshape(-1, C), dval.reshape(-1),
                             cfg["Density_weight"], w.reshape(-1))
    return total + kl + mae


# ---------------------------------------------------------------- operations

def _trunk_ops(cfg, B, N) -> float:
    """One trunk forward: the transform net (its first conv per point,
    its second per edge), the edge blocks per point (both chains), conv6."""
    k, emb = cfg["k"], cfg["emb_dims"]
    P_ = B * N
    ops = 2 * P_ * 3 * 64 * 2 + 2 * P_ * k * 64 * 128 + 2 * P_ * 128 * 1024
    ops += 2 * B * (1024 * 512 + 512 * 256 + 256 * 9)
    for cin, widths in BLOCKS.values():
        dims = (cin, *widths)
        ops += sum(2 * P_ * a * b * 2 for a, b in zip(dims, dims[1:]))
    ops += 2 * P_ * sum(w[-1] for _, w in BLOCKS.values()) * emb
    return float(ops)


def _head_ops(cfg, B, N, heads) -> float:
    cat = sum(w[-1] for _, w in BLOCKS.values())
    emb, P_ = cfg["emb_dims"], B * N
    ops = 0
    for h in heads:
        if h == "density":
            dc = cfg["density_num_class"]
            ops += 2 * P_ * (cat * 512 + 512 * 256 + 256 * 256 + 256 * dc
                             + dc) + 2 * B * emb * 512
        else:
            out = cfg["num_class"] if h == "seg" else 3
            ops += 2 * P_ * (cat * 256 + 256 * 256 + 256 * 128 + 128 * out) \
                + 2 * B * emb * 256
    return float(ops)


def train_step_ops(cfg) -> dict:
    """One MLSP+PCM step: the seg forward of the mixed source, the
    deformed target's forward with its defrec, normal and density heads,
    each backward twice its forward. All float32."""
    B, N = cfg["batch_size"], cfg["num_points"]
    fwd = (2 * _trunk_ops(cfg, B, N) + _head_ops(cfg, B, N, ("seg",))
           + _head_ops(cfg, B, N, ("defrec", "normal", "density")))
    return {"f32": 3 * fwd, "bf16": 0.0}


def eval_cloud_ops(cfg) -> dict:
    """The seg eval forward of one cloud."""
    N = cfg["num_points"]
    return {"f32": _trunk_ops(cfg, 1, N) + _head_ops(cfg, 1, N, ("seg",)),
            "bf16": 0.0}


def knn_graphs(cfg, B) -> list[tuple[int, int, int]]:
    """(B, N, C) of each kNN graph of one forward: the transform net's and
    each edge block's, on its input."""
    N = cfg["num_points"]
    return [(B, N, 3), (B, N, 3)] + [(B, N, w[-1]) for _, w in
                                     list(BLOCKS.values())[:-1]]


def train_knn_graphs(cfg) -> list[tuple[int, int, int]]:
    return 2 * knn_graphs(cfg, cfg["batch_size"])


def train_edge_backwards(cfg) -> list[tuple[int, int, int]]:
    return []
