"""Plain reference of the `pointda_dgcnn` configuration: DGCNN (Wang et al.,
2019) with the MLSP heads, its PointDA train step under the paper recipe
(PCM on the source; DefRec, normals and density on the deformed target)
and its eval forward.

Functional: the weights are a dict {state_dict name: tensor} in the
layout of the reference PyTorch DGCNN (`conv1.conv.0.weight` = [W_d | W_c]
over the edge input [x_j - x_i | x_i], BatchNorm `conv1.conv.1.*`, ...).
Each EdgeConv layer is the published one (BatchNorm over the edges
[x_j - x_i | x_i], LeakyReLU 0.2, the max over k) in the form that never
builds the edge tensor (`_edgeconv`); the kNN graphs take the port's
kernel's documented distances (`plain.knn`). The per-point heads run in bf16 where the configuration says so, as flax's
bf16 `Dense` computes (`plain.dense`); the rest is float32.

Nothing here imports the system under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import plain as P

HEADS = ("DefRec", "Norm_pred", "Rec_scan")  # the 3-wide per-point heads


def _dt(cfg):
    return torch.bfloat16 if cfg["head_dtype"] == "bf16" else None


def spec(cfg) -> list[tuple[str, tuple, str]]:
    """Every state_dict entry: (name, shape, kind), kind one of "w" (a
    matmul weight, fan-in its trailing dims), "b" (a bias), "bn" (a
    BatchNorm: weight, bias, running_mean, running_var,
    num_batches_tracked) and "bins" (the density head's frozen bins)."""
    nc, dc = cfg["num_class"], cfg["density_num_class"]
    out = []

    def bn(name, c):
        out.append((name, (c,), "bn"))

    def conv_bn(name, cin, cout, rank=2):
        out.append((f"{name}.conv.0.weight", (cout, cin) + (1,) * rank, "w"))
        bn(f"{name}.conv.1", cout)

    def fc_bn(name, cin, cout, bias):
        out.append((f"{name}.fc.0.weight", (cout, cin), "w"))
        if bias:
            out.append((f"{name}.fc.0.bias", (cout,), "b"))
        bn(f"{name}.fc.1", cout)

    t = "input_transform_net"
    conv_bn(f"{t}.conv2d1", 6, 64)
    conv_bn(f"{t}.conv2d2", 64, 128)
    conv_bn(f"{t}.conv2d3", 128, 1024)
    fc_bn(f"{t}.fc1", 1024, 512, False)
    fc_bn(f"{t}.fc2", 512, 256, True)
    out += [(f"{t}.fc3.weight", (9, 256), "w"), (f"{t}.fc3.bias", (9,), "b")]
    widths = cfg["edgeconv_widths"]
    cin = 3
    for i, c in enumerate(widths, 1):
        conv_bn(f"conv{i}", 2 * cin, c)
        cin = c
    emb = cfg["emb_dims"]
    out.append(("conv5.weight", (emb, sum(widths), 1), "w"))
    bn("bn5", emb)
    fc_bn("C.mlp1", emb, 512, True)
    fc_bn("C.mlp2", 512, 256, True)
    out += [("C.mlp3.weight", (nc, 256), "w"), ("C.mlp3.bias", (nc,), "b")]
    hin = sum(widths) + emb
    for h in HEADS:
        for j, (a, b) in enumerate(((hin, 256), (256, 256), (256, 128)), 1):
            out.append((f"{h}.conv{j}.weight", (b, a, 1), "w"))
            bn(f"{h}.bn{j}", b)
        out.append((f"{h}.conv4.weight", (3, 128, 1), "w"))
    out.append(("Density_cls.conv1.weight", (512, hin, 1), "w"))
    bn("Density_cls.bn1", 512)
    fc_bn("Density_cls.mlp1", 512, 256, True)
    fc_bn("Density_cls.mlp2", 256, 256, True)
    out += [("Density_cls.mlp3.weight", (dc, 256), "w"),
            ("Density_cls.mlp3.bias", (dc,), "b"),
            ("Density_cls.fc2.weight", (1, dc), "bins")]
    return out


# ---------------------------------------------------------------- forward

def _transform(W, e, train):
    t = "input_transform_net"
    for j in (1, 2):
        e = P.leaky_relu(P.batch_norm(
            W, f"{t}.conv2d{j}.conv.1",
            P.dense(e, W[f"{t}.conv2d{j}.conv.0.weight"]), train))
    x = e.amax(-2)
    x = P.leaky_relu(P.batch_norm(W, f"{t}.conv2d3.conv.1", P.dense(
        x, W[f"{t}.conv2d3.conv.0.weight"]), train)).amax(-2)
    x = P.leaky_relu(P.batch_norm(W, f"{t}.fc1.fc.1", P.dense(
        x, W[f"{t}.fc1.fc.0.weight"]), train))
    x = P.leaky_relu(P.batch_norm(W, f"{t}.fc2.fc.1", P.dense(
        x, W[f"{t}.fc2.fc.0.weight"], W[f"{t}.fc2.fc.0.bias"]), train))
    x = P.dense(x, W[f"{t}.fc3.weight"], W[f"{t}.fc3.bias"]).float()
    eye = torch.eye(3, device=x.device).reshape(-1)
    return (x + eye).reshape(-1, 3, 3)


def _edgeconv(W, name, x, k, train):
    """EdgeConv + BatchNorm + LeakyReLU + max over the k neighbours, with
    the edge value z_ij = W [x_j - x_i | x_i] = u_j + c_i (u = W_d x, c =
    W_c x - u) never built: BatchNorm is affine and LeakyReLU monotone,
    so the max over j is taken of u_j (of -u_j where gamma < 0), and in
    train mode the statistics of the B N k edges come from the
    neighbourhood sums of u (the JAX package's `EdgeConvM` form; the sums
    as the port's kernel documents them, `plain.neighbour_sums`)."""
    w = W[f"{name}.conv.0.weight"].flatten(1)
    cin = x.shape[-1]
    u, v = P.dense(x, w[:, :cin]), P.dense(x, w[:, cin:])
    c = v - u
    g = P.gather(u, P.knn(x, k))
    mx, mn = g.amax(-2), g.amin(-2)
    bn = f"{name}.conv.1"
    if train:
        s1, s2 = (t / k for t in P.neighbour_sums(g))
        mu = (s1 + c).mean((0, 1))
        var = torch.clamp_min((s2 + 2.0 * c * s1 + c * c).mean((0, 1))
                              - mu * mu, 0.0)
        with torch.no_grad():
            n = x.shape[0] * x.shape[1] * k
            rm, rv = W[f"{bn}.running_mean"], W[f"{bn}.running_var"]
            rm.mul_(0.9).add_(0.1 * mu)
            rv.mul_(0.9).add_(0.1 * var * (n / max(n - 1, 1)))
            W[f"{bn}.num_batches_tracked"].add_(1)
    else:
        mu, var = W[f"{bn}.running_mean"], W[f"{bn}.running_var"]
    s = W[f"{bn}.weight"] * torch.rsqrt(var + 1e-5)
    y = s * (torch.where(s >= 0, mx, mn) + c - mu) + W[f"{bn}.bias"]
    return torch.nn.functional.leaky_relu(y, negative_slope=0.2)


def _fc_bn(W, name, x, train, dt=None):
    y = P.dense(x, W[f"{name}.fc.0.weight"], W.get(f"{name}.fc.0.bias"), dt)
    return P.leaky_relu(P.batch_norm(W, f"{name}.fc.1", y, train))


def _point_head(W, h, pp, g, train, p, dt):
    drop = lambda t: P.dropout(t, p, train, g)  # noqa: E731
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn1", P.split_dense(
        *pp, W[f"{h}.conv1.weight"], None, dt), train)))
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn2", P.dense(
        x, W[f"{h}.conv2.weight"], None, dt), train)))
    x = F.relu(P.batch_norm(W, f"{h}.bn3", P.dense(
        x, W[f"{h}.conv3.weight"], None, dt), train))
    return P.dense(x, W[f"{h}.conv4.weight"], None, dt).float()


def _density_head(W, pp, g, train, p, dt):
    h = "Density_cls"
    drop = lambda t: P.dropout(t, p, train, g)  # noqa: E731
    x = drop(F.relu(P.batch_norm(W, f"{h}.bn1", P.split_dense(
        *pp, W[f"{h}.conv1.weight"], None, dt), train)))
    x = drop(_fc_bn(W, f"{h}.mlp1", x, train, dt))
    x = drop(_fc_bn(W, f"{h}.mlp2", x, train, dt))
    pv = torch.softmax(P.dense(x, W[f"{h}.mlp3.weight"], W[f"{h}.mlp3.bias"],
                               dt).float(), -1)
    return pv, (pv * W[f"{h}.fc2.weight"][0]).sum(-1)


def forward(W, x, heads, g, train: bool, cfg) -> dict:
    """x [B, N, 3] -> {"cls" [B, num_class]} and the heads asked for
    ("defrec", "normal", "scan", "density" with "density_mse"); dropout
    masks from `g` in train mode, in the order the layers run."""
    k, p, dt = cfg["k"], cfg["dropout"], _dt(cfg)
    T = _transform(W, P.edge_features(x, P.knn(x, k)), train)
    h = torch.einsum("bnc,bdc->bnd", x, T)
    feats = []
    for i in range(1, len(cfg["edgeconv_widths"]) + 1):
        h = _edgeconv(W, f"conv{i}", h, k, train)
        feats.append(h)
    xcat = torch.cat(feats, -1)
    x5 = P.leaky_relu(P.batch_norm(W, "bn5", P.dense(xcat, W["conv5.weight"]),
                                   train)).amax(1)
    c = P.dropout(_fc_bn(W, "C.mlp1", x5, train), p, train, g)
    c = P.dropout(_fc_bn(W, "C.mlp2", c, train), p, train, g)
    out = {"cls": P.dense(c, W["C.mlp3.weight"], W["C.mlp3.bias"]).float()}
    pp = (xcat, x5) if dt is None else (xcat.to(dt), x5.to(dt))
    for name, h in (("defrec", "DefRec"), ("normal", "Norm_pred"),
                    ("scan", "Rec_scan")):
        if name in heads:
            out[name] = _point_head(W, h, pp, g, train, p, dt)
    if "density" in heads:
        out["density"], out["density_mse"] = _density_head(W, pp, g, train, p,
                                                           dt)
    return out


def eval_logits(W, x, cfg) -> torch.Tensor:
    """Class logits of clouds x [B, N, 3] in eval mode."""
    with torch.no_grad():
        return forward(W, x, (), None, False, cfg)["cls"]


# ---------------------------------------------------------------- train

def train_loss(W, src_x, src_y, trgt_x, g, cfg) -> torch.Tensor:
    """The paper recipe's loss for one step, every random number drawn
    from `g` in the recipe's order: the augmentations (source, target),
    PCM's draws, the target's deformation, then the forwards' dropout."""
    B, N = src_x.shape[:2]
    src = P.augment(src_x, *P.draw_augment(g, src_x))
    trgt = P.augment(trgt_x, *P.draw_augment(g, trgt_x))
    mixed, (ya, yb, lam) = P.pcm_mix(src, src_y, P.draw_pcm(g, B, N))
    dx, mask = P.deform(trgt, *P.draw_deform(g, trgt))
    logits = forward(W, mixed, (), g, True, cfg)["cls"]
    total = (lam * F.cross_entropy(logits, ya)
             + (1.0 - lam) * F.cross_entropy(logits, yb)) * (
        1.0 - cfg["DefRec_weight"])
    n_gt = P.normals(trgt, cfg["near"])
    C = cfg["density_num_class"]
    dvec, dval = P.density_labels(trgt, cfg["radius"], C, cfg["pergroup"])
    out = forward(W, dx, ("defrec", "normal", "density"), g, True, cfg)
    w = mask * 26.0 + 1.0
    ssl = P.defrec_loss(out["defrec"], trgt, mask, cfg["DefRec_weight"])
    ssl = ssl + P.masked_normal_loss(out["normal"], n_gt, w,
                                     cfg["normal_pred_weight"])
    kl, mae = P.density_loss(out["density"].reshape(-1, C),
                             out["density_mse"].reshape(-1),
                             dvec.reshape(-1, C), dval.reshape(-1),
                             cfg["Density_weight"], w.reshape(-1))
    return total + (ssl + kl + mae)


# ---------------------------------------------------------------- operations

def _trunk_ops(cfg, B, N) -> float:
    """Multiply-adds x 2 of one trunk forward: the transform net (its
    first conv in the per-point form, its second per edge, as nothing
    computes it with fewer), each EdgeConv in the per-point form (u = W_d
    x and W_c x per point), conv5 and the classifier."""
    k, emb, widths = cfg["k"], cfg["emb_dims"], cfg["edgeconv_widths"]
    P_, E = B * N, B * N * k
    ops = 2 * P_ * 3 * 64 * 2 + 2 * E * 64 * 128 + 2 * P_ * 128 * 1024
    ops += 2 * B * (1024 * 512 + 512 * 256 + 256 * 9)
    cin = 3
    for c in widths:
        ops += 2 * P_ * cin * c * 2
        cin = c
    ops += 2 * P_ * sum(widths) * emb
    ops += 2 * B * (emb * 512 + 512 * 256 + 256 * cfg["num_class"])
    return float(ops)


def _head_ops(cfg, B, N, heads) -> float:
    """One forward of the per-point heads asked for: the first layer
    split, per point over the concatenated features and per cloud over the
    global feature."""
    cat, emb = sum(cfg["edgeconv_widths"]), cfg["emb_dims"]
    P_ = B * N
    ops = 0
    for h in heads:
        if h == "density":
            ops += (2 * P_ * (cat * 512 + 512 * 256 + 256 * 256
                              + 256 * cfg["density_num_class"]
                              + cfg["density_num_class"])
                    + 2 * B * emb * 512)
        else:
            ops += 2 * P_ * (cat * 256 + 256 * 256 + 256 * 128 + 128 * 3) \
                + 2 * B * emb * 256
    return float(ops)


def train_step_ops(cfg) -> dict:
    """Operations of one paper-recipe step, by precision: two trunk
    forwards (the PCM-mixed source, the deformed target) and the
    target's defrec, normal and density heads, each backward counted as
    twice its forward."""
    B, N = cfg["batch_size"], cfg["num_points"]
    f32 = 2 * _trunk_ops(cfg, B, N)
    heads = _head_ops(cfg, B, N, ("defrec", "normal", "density"))
    if cfg["head_dtype"] == "bf16":
        return {"f32": 3 * f32, "bf16": 3 * heads}
    return {"f32": 3 * (f32 + heads), "bf16": 0.0}


def eval_cloud_ops(cfg) -> dict:
    """Operations of the eval forward of one cloud (the classifier)."""
    return {"f32": _trunk_ops(cfg, 1, cfg["num_points"]), "bf16": 0.0}


def knn_graphs(cfg, B) -> list[tuple[int, int, int]]:
    """The (B, N, C) of each kNN graph of one trunk forward: the input
    transform's and each EdgeConv layer's, on its input."""
    N, widths = cfg["num_points"], cfg["edgeconv_widths"]
    return [(B, N, c) for c in (3, 3, *widths[:-1])]


def train_knn_graphs(cfg) -> list[tuple[int, int, int]]:
    return 2 * knn_graphs(cfg, cfg["batch_size"])


def train_edge_backwards(cfg) -> list[tuple[int, int, int]]:
    """The (B, N, C) of each EdgeConv layer's backward of a step: the
    four layers' outputs, in both forwards."""
    B, N = cfg["batch_size"], cfg["num_points"]
    return 2 * [(B, N, c) for c in cfg["edgeconv_widths"]]
