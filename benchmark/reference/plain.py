"""Plain PyTorch operations of the reference: the kNN graph, farthest-point
sampling, normals, density labels, deformations, augmentation, PCM, the
losses, dropout, flax-style dense layers, BatchNorm and Adam.

Written from the published MLSP recipes (DGCNN, PCM, DefRec, the normal
and density tasks) in the arithmetic the configurations state: float32
matmuls with TF32 off unless a caller switches it on, and where a
configuration runs a head in bf16, flax's bf16 `Dense` (the product
rounded, then the bias added). Every random number is drawn from the
caller's `torch.Generator`, in the order the recipe takes them, so that
the reference draws what a step of the system under test draws from the
same generator state.

Nothing here imports the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# flax computes 0.2 * x on a bf16 x with bf16's 0.2
SLOPE_BF16 = float(torch.tensor(0.2, dtype=torch.bfloat16))


# ---------------------------------------------------------------- layers

def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE_BF16 if x.dtype == torch.bfloat16 else 0.2)


def dense(x, w, b=None, dtype=None):
    """x @ w^T (+ b) as flax's `Dense(dtype)`: in float32 one product with
    its bias; below float32 the product rounded, then the bias added."""
    dt = dtype or torch.float32
    w = w.flatten(1)
    if dt == torch.float32 or b is None:
        return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
    return F.linear(x.to(dt), w.to(dt)) + b.to(dt)


def split_dense(a, g, w, b=None, dtype=None):
    """dense of the implicit concat [a | broadcast(g)] (per-point a [B, N,
    Ca], global g [B, Cg]): the global half multiplied once per cloud."""
    dt = dtype or torch.float32
    w = w.flatten(1)
    ca = a.shape[-1]
    y = dense(a, w[:, :ca], None, dt) + dense(g, w[:, ca:], None, dt)[
        ..., None, :]
    return y if b is None else y + b.to(dt)


def batch_norm(W: dict, name: str, x: torch.Tensor, train: bool,
               momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over every axis but the last, in float32, the result in
    x's dtype; train mode takes the batch statistics and moves the running
    ones (unbiased variance), eval mode reads them."""
    rows = x.reshape(-1, x.shape[-1]).float()
    y = F.batch_norm(rows, W[f"{name}.running_mean"], W[f"{name}.running_var"],
                     W[f"{name}.weight"], W[f"{name}.bias"], train, momentum,
                     eps)
    return y.reshape(x.shape).to(x.dtype)


def dropout(x, p: float, train: bool, generator):
    """Inverted dropout, the mask drawn from `generator` as float32
    uniforms of x's shape."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


# ---------------------------------------------------------------- geometry

def pairwise_sqdist(x, y):
    """||x_i - y_j||^2 [..., N, M] in the matmul form, clamped at 0."""
    x, y = x.float(), y.float()
    d = (x.square().sum(-1, keepdim=True)
         - 2.0 * torch.matmul(x, y.transpose(-1, -2))
         + y.square().sum(-1, keepdim=True).transpose(-1, -2))
    return d.clamp_min(0.0)


def chain_sqdist(x, clouds: int = 16):
    """Squared distances [B, N, N] of each cloud's points as the port's kNN
    kernel documents them (`csrc/knn_topk.cuh`): ||q||^2, ||x||^2 and q.x
    each one float32 fused multiply-add chain over the channels in
    ascending order (each step a float64 product and sum rounded to
    float32: the fused step's single rounding), then (||q||^2 - 2 q.x) +
    ||x||^2 in float32, clamped at 0. A few clouds at a time."""
    out = []
    for b in range(0, x.shape[0], clouds):
        xd = x[b:b + clouds].double()
        B, N, C = xd.shape
        dot = torch.zeros(B, N, N, device=x.device)
        nrm = torch.zeros(B, N, device=x.device)
        for c in range(C):
            col = xd[..., c]
            dot = (col[:, :, None] * col[:, None, :] + dot.double()).float()
            nrm = (col * col + nrm.double()).float()
        out.append(((nrm[:, :, None] - 2.0 * dot) + nrm[:, None, :])
                   .clamp_min(0.0))
    return torch.cat(out)


def knn(x, k: int):
    """The k nearest points of each point (itself included) by
    `chain_sqdist`, ties to the lower index: int64 [B, N, k]."""
    d = chain_sqdist(x.float())
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def neighbour_sums(g):
    """(sum_j g_j, sum_j g_j^2) over the neighbour axis of g [..., k, C]
    as the port's kernels document their sums (`csrc/edge_moments.cu`,
    `csrc/knn_moments.cu`): one float32 addition, and one fused
    multiply-add, a neighbour, nearest first."""
    s1 = torch.zeros_like(g[..., 0, :])
    s2 = torch.zeros_like(s1)
    for j in range(g.shape[-2]):
        v = g[..., j, :]
        s1 = s1 + v
        s2 = (v.double() * v.double() + s2.double()).float()
    return s1, s2


def gather(feats, idx):
    """feats [B, M, C], idx [B, N, k] -> [B, N, k, C]."""
    b = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[b, idx]


def edge_features(x, idx):
    """DGCNN's edge input [x_j - x_i | x_i]: [B, N, k, 2C]."""
    nb = gather(x, idx)
    c = x[:, :, None, :].expand_as(nb)
    return torch.cat([nb - c, c], -1)


def fps(xyz, npoint: int, start):
    """Greedy farthest-point sampling from `start` [B]; ties to the lower
    index. int64 [B, npoint]."""
    B, N, _ = xyz.shape
    x = xyz.float()
    rows = torch.arange(B, device=x.device)
    mind = torch.full((B, N), float("inf"), device=x.device)
    far = start.long()
    out = torch.empty((B, npoint), dtype=torch.int64, device=x.device)
    for i in range(npoint):
        out[:, i] = far
        dx, dy, dz = (x - x[rows, far][:, None, :]).unbind(-1)
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(mind, dim=-1)
    return out


def _smallest_eigvec(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric A [..., 3,
    3]: trigonometric eigenvalues, then the null space of A - lam I from
    cross products of its rows; a degenerate neighbourhood gives z."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, 1e-12) / 6.0)
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    det = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    r0 = torch.stack([a00 - lam, a01, a02], -1)
    r1 = torch.stack([a01, a11 - lam, a12], -1)
    r2 = torch.stack([a02, a12, a22 - lam], -1)
    c01, c02, c12 = (torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                     torch.linalg.cross(r1, r2))
    n01, n02, n12 = ((c * c).sum(-1, keepdim=True) for c in (c01, c02, c12))
    v = torch.where(n01 >= n02, c01, c02)
    best = torch.maximum(n01, n02)
    v = torch.where(best >= n12, v, c12)
    best = torch.maximum(best, n12)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    v = torch.where((p2[..., None] < 1e-10) | (best < 1e-12), z, v)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-12)


def knn_moments(x, k: int):
    """(s1 [B, N, 3], s2 [B, N, 3, 3]): the sums over each point's k
    nearest points of their coordinates and outer products, taken as the
    port's normal kernel documents them (`neighbour_sums`; each outer
    product one fused multiply-add a neighbour, nearest first)."""
    nb = gather(x, knn(x, k))
    s2 = torch.zeros(*nb.shape[:-2], 3, 3, device=x.device)
    for j in range(k):
        p = nb[..., j, :].double()
        s2 = (p[..., :, None] * p[..., None, :] + s2.double()).float()
    return neighbour_sums(nb)[0], s2


def normals(xyz, k: int):
    """kNN-PCA normals [B, N, 3], flipped toward the origin: the smallest
    eigenvector of the covariance s2/k - mu mu^T (`knn_moments`)."""
    x = xyz.float()
    s1, s2 = knn_moments(x, k)
    mu = s1 / float(k)
    n = _smallest_eigvec(s2 / float(k) - mu[..., :, None] * mu[..., None, :])
    return torch.where((n * x).sum(-1, keepdim=True) > 0.0, -n, n)


def density_labels(xyz, radius: float, num_cls: int, pergroup: float,
                   shift: float = 0.0, cap: int = 100):
    """The reference's point-cardinality labels: neighbours within
    `radius` (self included) as a PCL radius search capped at `cap`
    returns them, point 0 excluded when returned; the soft two-hot class
    vector [B, N, num_cls] and the clipped shifted count [B, N]."""
    d = pairwise_sqdist(xyz, xyz)
    r2 = torch.full((), radius, dtype=torch.float32, device=d.device) ** 2
    within = d <= r2
    total = within.sum(-1, dtype=torch.float32)
    closer = (within & (d < d[..., 0:1])).sum(-1, dtype=torch.float32)
    zero_returned = within[..., 0] & (closer < float(cap))
    count = (torch.clamp_max(total, float(cap)) - zero_returned.float()
             ).clamp_min(0.0)
    row = torch.clamp(count - shift, 0.0, float((num_cls - 1) * pergroup))
    lo = torch.floor(row / pergroup).long()
    hi = torch.ceil(row / pergroup).long()
    return 0.5 * (F.one_hot(lo, num_cls).float()
                  + F.one_hot(hi, num_cls).float()), row


# ---------------------------------------------------------------- draws

def draw_augment(g, x):
    """(rotation matrices about z [B, 3, 3], jitter noise [B, N, 3])."""
    a = torch.rand(x.shape[0], generator=g, device=g.device) * (2.0 * math.pi)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    R = torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(-1, 3, 3)
    return R, torch.randn(x.shape, generator=g, device=g.device)


def augment(x, R, noise):
    """x @ R, written out one rounding per operation, then the clipped
    jitter."""
    R = R[:, None]
    x = (x[..., 0:1] * R[..., 0, :] + x[..., 1:2] * R[..., 1, :]
         + x[..., 2:3] * R[..., 2, :])
    return x + torch.clamp(0.01 * noise, -0.02, 0.02)


def draw_pcm(g, B: int, N: int):
    """PCM's draws at mixup_params 1: the partner permutation, the ratio
    (uniform), both FPS starts, the point permutation."""
    d = {"perm": torch.randperm(B, generator=g, device=g.device),
         "lam": torch.rand((), generator=g, device=g.device)}
    for name in ("start_a", "start_b"):
        d[name] = torch.randint(0, N, (B,), generator=g, device=g.device)
    d["points"] = torch.randperm(N, generator=g, device=g.device)
    return d


def pcm_mix(x, y, d, per_point_labels: bool = False):
    """PCM: round(lam N) farthest points of each cloud, the rest from its
    partner's farthest points, the points permuted. Returns the mixed
    clouds with (y, y[perm], lam), or with per-point labels the mixed
    labels."""
    B, N, _ = x.shape
    perm, lam = d["perm"], d["lam"]
    num_a = torch.round(lam * N).long()
    xb, yb = x[perm], y[perm]
    order = fps(torch.cat([x, xb]), N, torch.cat([d["start_a"],
                                                  d["start_b"]]))
    oa, ob = order[:B], order[B:]
    va = torch.gather(x, 1, oa[..., None].expand(-1, -1, 3))
    vb = torch.gather(xb, 1, ob[..., None].expand(-1, -1, 3))
    i = torch.arange(N, device=x.device)
    idx_b = torch.clamp(i - num_a, 0, N - 1)
    take_a = i < num_a
    mixed = torch.where(take_a[None, :, None], va, vb[:, idx_b])
    mixed = mixed[:, d["points"]]
    if not per_point_labels:
        return mixed, (y, yb, lam)
    la, lb = torch.gather(y, 1, oa), torch.gather(yb, 1, ob)
    return mixed, torch.where(take_a[None, :], la, lb[:, idx_b])[
        :, d["points"]]


NREGIONS = 3
MIN_PTS = 40
GAUSS_STD = 0.001 ** 0.5


def draw_deform(g, x):
    """(a random order of the 27 voxels per cloud, gaussian noise)."""
    perm = torch.argsort(torch.rand(x.shape[0], NREGIONS ** 3, generator=g,
                                    device=g.device), dim=-1)
    return perm, torch.randn(x.shape, generator=g, device=g.device)


def deform(x, perm, noise):
    """DefRec's voxel deformation: the first voxel in `perm` order that
    holds >= 40 points collapsed to gaussian noise around its centre.
    Returns (deformed, mask)."""
    n, R = NREGIONS, NREGIONS ** 3
    cell = torch.clamp(torch.floor(
        (torch.clamp(x, -0.99999999, 0.99999999) + 1.0) / (2.0 / n)),
        0, n - 1).long()
    rid = cell[..., 0] * n * n + cell[..., 1] * n + cell[..., 2]
    counts = F.one_hot(rid, R).sum(1)
    eligible = torch.gather(counts, 1, perm) >= MIN_PTS
    picked = eligible & (torch.cumsum(eligible.long(), 1) <= 1)
    mask = torch.gather(torch.zeros_like(picked).scatter(1, perm, picked), 1,
                        rid)
    ax = -1.0 + (2.0 / n) * (torch.arange(n, dtype=torch.float32,
                                          device=x.device) + 0.5)
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    centers = torch.stack([gx, gy, gz], -1).reshape(-1, 3)[rid]
    out = torch.where(mask[..., None], centers + GAUSS_STD * noise, x)
    return out, mask.to(x.dtype)


# ---------------------------------------------------------------- losses

def masked_chamfer(p1, p2, mask):
    d = pairwise_sqdist(p1, p2) + (1.0 - mask)[:, None, :] * 100.0
    mind = d.amin(-1)
    return ((mind * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1.0)).sum()


def defrec_loss(pred, gold, mask, weight: float):
    rec = (masked_chamfer(gold, pred, mask)
           + masked_chamfer(pred, gold, mask)) / pred.shape[0]
    return weight * rec * 20.0


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-12)


def masked_normal_loss(pred, gt, w, weight: float):
    cos = (_unit(pred) * _unit(gt)).sum(-1).abs()
    return -weight * (cos * w).sum() / w.sum().clamp_min(1e-12)


def density_loss(p_vec, p_val, t_vec, t_val, weight: float, mask=None):
    ll = (t_vec * torch.log(p_vec + 1e-10)).sum(-1)
    ae = (p_val - t_val).abs()
    if mask is None:
        return -weight * ll.mean(), weight * ae.mean() * 0.05
    den = mask.sum().clamp_min(1e-12)
    return (-weight * (ll * mask).sum() / den,
            weight * (ae * mask).sum() / den * 0.05)


# ---------------------------------------------------------------- Adam

def cosine_factor(epoch: int, epochs: int) -> float:
    """The recipes' per-epoch cosine LR factor: (1 + cos(pi e / E)) / 2."""
    return 0.5 * (1.0 + math.cos(math.pi * min(epoch, epochs) / epochs))


class Adam:
    """Adam with coupled L2 decay (the decay added to the gradient before
    the moments): the update of `torch.optim.Adam(weight_decay=wd)`,
    written out. A parameter whose gradient is None is left alone."""

    def __init__(self, params: dict, lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, wd
        self.b1, self.b2 = betas
        self.eps, self.t = eps, 0
        self.m, self.v, self.seen = {}, {}, {}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update with `grads` {name: tensor or None}; returns the
        gradients as the update took them (decay added)."""
        self.t += 1
        taken = {}
        for name, p in self.params.items():
            g = grads.get(name)
            if g is None:
                continue
            g = g + self.wd * p
            taken[name] = g
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            t = self.seen[name] = self.seen.get(name, 0) + 1
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(1.0 - self.b2 ** t)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1.0 - self.b1 ** t))
        return taken
