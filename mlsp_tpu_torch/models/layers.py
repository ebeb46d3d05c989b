"""Shared building blocks (counterpart of `mlsp_tpu/models/layers.py`).

Layout: channels-last ([B, N, C] or [B, N, k, C]). The reference's 1x1
convs are matmuls over the last axis (`F.linear`), as the JAX package uses
`nn.Dense`; that also keeps them off cuDNN, whose float32 convolutions
round through TF32 by default.

Names: modules and parameters follow the state_dict layout of the reference
PyTorch models (what `mlsp_tpu.utils.torch_export` emits), so one strict
`load_state_dict` takes a reference `model.pt` or a converted JAX
checkpoint. BatchNorm is torch's own, which updates its running variance
with the unbiased variance: the semantics that the JAX package's
`TorchBatchNorm` emulates. It always runs in float32, also inside a bf16
head, as the JAX package's does.

Precision follows flax's `dtype` (not autocast): each `Linear` and
`PointwiseConv` computes in its `compute_dtype` (`set_compute_dtype`;
None: the promoted type of its input and weight) with float32 parameters
cast at the call, so its output is in that dtype; BatchNorm computes in
float32 and returns its input's dtype; the activations, dropout and
maxima keep their input's dtype; the heads and the transform net return
float32.

Dropout draws its masks from the `torch.Generator` the caller passes to
`forward` (`dropout` below), never from the global RNG; in train mode a
layer with dropout > 0 needs one.

Inside `parallel.data_parallel` (a rank of a data-parallel run) both take
the global batch's view: BatchNorm's statistics are over every rank's
rows, and dropout keeps the rank's rows of the global batch's mask, so R
ranks compute what one process computes on the whole batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mlsp_tpu_torch.parallel.mesh import active_mesh, shard_batch


# jnp's 0.2 * x on a bf16 x takes the slope rounded to bf16
_SLOPE_BF16 = float(torch.tensor(0.2, dtype=torch.bfloat16))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU 0.2 as flax computes it in x's dtype: in bf16 the slope is
    bf16's 0.2 (0.2001953125), the product rounded once."""
    return F.leaky_relu(x, _SLOPE_BF16 if x.dtype == torch.bfloat16 else 0.2)


def act_fn(name: str):
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return leaky_relu
    raise ValueError(f"unknown activation {name!r}")


def check_heads(heads, known: tuple[str, ...], model: str) -> None:
    """Raise ValueError naming the heads `model` does not have."""
    unknown = set(heads) - set(known)
    if unknown:
        raise ValueError(f"{model}: unknown heads {sorted(unknown)}; know "
                         f"{known}")


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor | None = None,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ weight^T (+ bias) as flax's `nn.Dense(dtype=dtype)` computes it:
    x and the parameters cast to `dtype` (None: their promoted type). Below
    float32 the product is rounded to it, then the bias added, as flax
    rounds twice (a bias fused into the product would round once); in
    float32 the product's own epilogue adds the bias, the same sum."""
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    b = None if bias is None else bias.to(dt)
    if dt == torch.float32 or b is None:
        return F.linear(x.to(dt), weight.to(dt), b)
    return F.linear(x.to(dt), weight.to(dt)) + b


class Linear(nn.Linear):
    """`nn.Linear` that computes in `compute_dtype` (see `dense`)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class PointwiseConv(nn.Module):
    """A 1x1 Conv1d (rank 1) or Conv2d (rank 2) of the reference, run
    channels-last as a matmul in `compute_dtype` (see `dense`). The weight
    keeps the conv's shape, [out, in, 1] or [out, in, 1, 1], so the
    state_dict matches."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, cin: int, cout: int, rank: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(1,) * rank))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.flatten(1), self.bias, self.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None
                      ) -> nn.Module:
    """Make every `Linear` and `PointwiseConv` of `module` compute in
    `dtype` (flax's `dtype` of the JAX module); returns `module`."""
    for m in module.modules():
        if isinstance(m, (Linear, PointwiseConv)):
            m.compute_dtype = dtype
    return module


DTYPES = {"f32": None, "bf16": torch.bfloat16}


def parse_dtype(name: str, what: str, allow_empty: bool = False
                ) -> torch.dtype | None:
    """A config's dtype string as a compute dtype: "f32" -> None (float32
    throughout), "bf16" -> torch.bfloat16, "" -> None where `allow_empty`.
    Raises ValueError for anything else (JAX reads it as float32)."""
    if name in DTYPES:
        return DTYPES[name]
    if allow_empty and name == "":
        return None
    raise ValueError(f"{what} must be one of {sorted(DTYPES)}"
                     + (' or ""' if allow_empty else "") + f", got {name!r}")


def linear_in(layer: nn.Module, x) -> torch.Tensor:
    """Apply `layer` (PointwiseConv or Linear) to x, or to the implicit
    concat [a | broadcast(b)] when x is a (per-point a [B, N, Ca], global
    b [B, Cb]) pair, as the JAX package's `SplitDense` does: the global half
    is multiplied once per cloud and the concat is never built."""
    if not isinstance(x, tuple):
        return layer(x)
    a, b = x
    w = layer.weight.flatten(1)
    dt = layer.compute_dtype or torch.promote_types(
        torch.promote_types(a.dtype, b.dtype), w.dtype)
    ca = a.shape[-1]
    y = dense(a, w[:, :ca], None, dt) + dense(b, w[:, ca:], None, dt)[
        ..., None, :]
    return y if layer.bias is None else y + layer.bias.to(dt)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over every axis but the last (channels-last), in at least
    float32; the result keeps x's dtype. In train mode inside
    `data_parallel`, over the rows of every data rank
    (`global_batch_norm`)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    rows = x.reshape(-1, x.shape[-1]).to(wide)
    if bn.training and active_mesh() is not None:
        y = global_batch_norm(bn, rows)
    else:
        y = bn(rows)
    return y.reshape(x.shape).to(x.dtype)


def global_batch_norm(bn: nn.BatchNorm1d, rows: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm of rows [M, C] with the statistics of every
    rank's rows (`_GlobalBatchNorm`: one all-reduce forward, one
    backward). The running statistics move as `nn.BatchNorm1d` moves them:
    momentum, the unbiased variance over the global count."""
    mesh = active_mesh()
    y, mean, var = _GlobalBatchNorm.apply(rows, bn.weight, bn.bias, bn.eps,
                                          mesh)
    n = mesh.size * rows.shape[0]  # the ranks hold equal rows
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var * (n / max(n - 1.0, 1.0)), bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm over the rows of every data rank of `mesh` (its data
    group), differentiated by hand so that each direction takes one
    all-reduce and the large tensors go through fused kernels.

    Forward: each rank's count, mean and sum of squared deviations from
    its own mean (`torch.var_mean`, which sums no squares of raw values,
    as `nn.BatchNorm1d` does not), summed into rank slots by one
    all-reduce and combined
    by the parallel-variance rule, M2 = sum_r M2_r + sum_r n_r (mean_r -
    mean)^2 (Chan, Golub and LeVeque), so no sum of squares cancels; then
    the eval-mode `F.batch_norm` with the global mean and variance.
    Backward: the eval-mode BatchNorm backward gives dy * weight * invstd
    and this rank's sums of dy and dy * xhat (the parameters' gradients,
    averaged over the ranks later as every gradient is); one all-reduce
    of those sums gives the global ones, and dx subtracts the terms of
    the global mean and variance, (weight * invstd / n) (sum dy + xhat sum
    dy xhat). Returns (y, mean, var); only y has a gradient."""

    @staticmethod
    def forward(ctx, rows, weight, bias, eps, mesh):
        c = rows.shape[1]
        var_r, mean_r = torch.var_mean(rows, 0, correction=0)
        slots = rows.new_zeros(mesh.size, 2 * c + 1)
        slots[mesh.rank] = torch.cat([mean_r, var_r * rows.shape[0],
                                      rows.new_full((1,), rows.shape[0])])
        dist.all_reduce(slots, group=mesh.group)
        means, m2s, counts = slots[:, :c], slots[:, c:2 * c], slots[:, -1:]
        n = float(mesh.size * rows.shape[0])
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * (means - mean).square()).sum(0)) / n
        y = F.batch_norm(rows, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(rows, weight, mean, var)
        ctx.eps, ctx.n, ctx.group = eps, n, mesh.group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        rows, weight, mean, var = ctx.saved_tensors
        invstd = torch.rsqrt(var + ctx.eps)
        # eval mode (train=False): the statistics are constants here, and
        # the CUDA kernel reads them from save_mean/save_invstd
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(), rows, weight, mean, var, mean, invstd, False,
            ctx.eps, [True, True, True])
        sums = torch.cat([db, dw])
        dist.all_reduce(sums, group=ctx.group)
        c = rows.shape[1]
        scale = weight * invstd / ctx.n
        dx = dx.sub_(scale * sums[:c]).addcmul_(
            rows - mean, scale * invstd * sums[c:], value=-1.0)
        return dx, dw, db, None, None


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`: keep with probability 1 - p,
    scale kept values by 1 / (1 - p)) with the mask drawn from `generator`,
    which must live on x's device. Inside `data_parallel` the mask is the
    global batch's ([rows x ranks, ...]) and x takes its rank's rows."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(pass generator= to the model's forward)")
    mesh = active_mesh()
    shape = x.shape if mesh is None else (x.shape[0] * mesh.size,
                                          *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    keep = shard_batch(mesh, keep)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class DenseBN(nn.Module):
    """Dense -> BatchNorm -> activation: the reference's `conv_2d`
    (`conv=True`: parameters `conv.0`, `conv.1`, a rank-2 1x1 conv) or
    `fc_layer` (`conv=False`: `fc.0`, `fc.1`, a `Linear`). With
    `use_bn=False` (the PointSegDA transform net) there is no `.1`."""

    def __init__(self, cin: int, cout: int, activation: str, bias: bool,
                 conv: bool, use_bn: bool = True):
        super().__init__()
        lin = PointwiseConv(cin, cout, 2, bias) if conv else Linear(
            cin, cout, bias=bias)
        layers = nn.ModuleList([lin, nn.BatchNorm1d(cout)] if use_bn
                               else [lin])
        if conv:
            self.conv = layers
        else:
            self.fc = layers
        self.act = act_fn(activation)

    def forward(self, x):
        layers = self.conv if hasattr(self, "conv") else self.fc
        y = linear_in(layers[0], x)
        if len(layers) > 1:
            y = batch_norm(layers[1], y)
        return self.act(y)


class TransformNet(nn.Module):
    """Spatial/feature transform net (reference `transform_net`) ->
    [B, out, out], the identity plus a learned term.

    `mode="dgcnn"` takes edge features [B, N, k, 2·out], max-reduces over
    k after the second conv and uses LeakyReLU and bias-free convs;
    `mode="pointnet"` takes per-point features [B, N, out] and uses ReLU
    with biases (the JAX `TransformNet`'s two modes)."""

    def __init__(self, out: int = 3, mode: str = "dgcnn"):
        super().__init__()
        if mode not in ("dgcnn", "pointnet"):
            raise ValueError(f"unknown TransformNet mode {mode!r}")
        self.out, self.mode = out, mode
        leaky = mode == "dgcnn"
        act, bias = ("leakyrelu", False) if leaky else ("relu", True)
        cin = 2 * out if leaky else out
        self.conv2d1 = DenseBN(cin, 64, act, bias, conv=True)
        self.conv2d2 = DenseBN(64, 128, act, bias, conv=True)
        self.conv2d3 = DenseBN(128, 1024, act, bias, conv=True)
        self.fc1 = DenseBN(1024, 512, act, bias, conv=False)
        self.fc2 = DenseBN(512, 256, act, True, conv=False)
        self.fc3 = Linear(256, out * out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d2(self.conv2d1(x))
        if self.mode == "dgcnn":
            x = x.amax(-2)  # over k
        x = self.conv2d3(x).amax(-2)  # over N
        # the matrix multiplies raw coordinates: float32 at any dtype
        x = self.fc3(self.fc2(self.fc1(x))).float()
        eye = torch.eye(self.out, dtype=x.dtype, device=x.device).reshape(-1)
        return (x + eye).reshape(x.shape[0], self.out, self.out)


class Classifier(nn.Module):
    """Global-feature classifier head (reference `classifier`): the DGCNN
    form (LeakyReLU, biases) or, with `model="pointnet"`, PointNet's (ReLU,
    the first layer bias-free)."""

    def __init__(self, cin: int, num_classes: int, dropout: float = 0.5,
                 model: str = "dgcnn"):
        super().__init__()
        leaky = model == "dgcnn"
        act = "leakyrelu" if leaky else "relu"
        self.mlp1 = DenseBN(cin, 512, act, leaky, conv=False)
        self.mlp2 = DenseBN(512, 256, act, True, conv=False)
        self.mlp3 = Linear(256, num_classes)
        self.p = dropout

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(self.mlp1(x), self.p, self.training, generator)
        x = dropout(self.mlp2(x), self.p, self.training, generator)
        return self.mlp3(x).float()


class PointMLPHead(nn.Module):
    """Per-point head (reference `RegionReconstruction` /
    `Normal_prediction`): 256 -> 256 -> 128 -> out, BN + ReLU + dropout,
    1x1 convs, bias-free unless `bias` (the PointSegDA `segmentation` and
    `DeformationReconstruction` heads)."""

    def __init__(self, cin: int, out: int = 3, dropout: float = 0.5,
                 bias: bool = False):
        super().__init__()
        self.conv1 = PointwiseConv(cin, 256, 1, bias)
        self.bn1 = nn.BatchNorm1d(256)
        self.conv2 = PointwiseConv(256, 256, 1, bias)
        self.bn2 = nn.BatchNorm1d(256)
        self.conv3 = PointwiseConv(256, 128, 1, bias)
        self.bn3 = nn.BatchNorm1d(128)
        self.conv4 = PointwiseConv(128, out, 1, bias)
        self.p = dropout

    def forward(self, x, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.p, self.training, generator)

        x = drop(F.relu(batch_norm(self.bn1, linear_in(self.conv1, x))))
        x = drop(F.relu(batch_norm(self.bn2, self.conv2(x))))
        x = F.relu(batch_norm(self.bn3, self.conv3(x)))
        return self.conv4(x).float()


class DensityHead(nn.Module):
    """Cardinality head (reference `Density_prediction`).

    Per point: 1x1 conv 512 (BN + ReLU + dropout) -> MLP 256 -> 256 ->
    num_cls -> softmax p_vec; the density is the expectation under the
    frozen bins `fc2.weight` = pergroup * arange(num_cls), a parameter that
    never trains but is part of the state_dict.

    Returns (p_vec [B, N, num_cls], density [B, N]).
    """

    def __init__(self, cin: int, num_cls: int = 16, pergroup: float = 2.0,
                 dropout: float = 0.5):
        super().__init__()
        self.conv1 = PointwiseConv(cin, 512, 1, False)
        self.bn1 = nn.BatchNorm1d(512)
        self.mlp1 = DenseBN(512, 256, "leakyrelu", True, conv=False)
        self.mlp2 = DenseBN(256, 256, "leakyrelu", True, conv=False)
        self.mlp3 = Linear(256, num_cls)
        self.fc2 = Linear(num_cls, 1, bias=False)
        self.fc2.weight.requires_grad_(False)
        self.pergroup = pergroup
        self.p = dropout

    def forward(self, x, generator: torch.Generator | None = None):
        def drop(t):
            return dropout(t, self.p, self.training, generator)

        x = drop(F.relu(batch_norm(self.bn1, linear_in(self.conv1, x))))
        x = drop(self.mlp1(x))
        x = drop(self.mlp2(x))
        p_vec = torch.softmax(self.mlp3(x).float(), dim=-1)
        return p_vec, (p_vec * self.fc2.weight[0]).sum(-1)


class FlaxDenseBN(nn.Module):
    """Dense -> BatchNorm -> activation under the JAX package's module
    names, `Dense_0` (a `Linear`) and `BatchNorm_0`: for the parts of
    models with no reference state_dict (PointNet++, Point-ViT's group
    embedders)."""

    def __init__(self, cin: int, cout: int, activation: str = "relu",
                 bias: bool = True):
        super().__init__()
        self.Dense_0 = Linear(cin, cout, bias=bias)
        self.BatchNorm_0 = nn.BatchNorm1d(cout)
        self.act = act_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(batch_norm(self.BatchNorm_0, self.Dense_0(x)))


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as the JAX package does: matmul weights from a normal of
    std 1/sqrt(fan_in) (flax's lecun_normal, untruncated), biases 0,
    BatchNorm and LayerNorm gamma 1, beta 0, running stats (0, 1); a
    module's `init_tokens(generator)` for its learned tokens; density bins
    fixed.
    Draws from `generator`, so a seed gives the same weights on any device
    (initialise on the CPU, then move)."""
    for m in model.modules():
        if isinstance(m, (PointwiseConv, nn.Linear)):
            fan_in = m.weight.flatten(1).shape[1]
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm)):
            m.reset_parameters()
    for m in model.modules():  # after the loop above, which drew fc2 too
        if hasattr(m, "init_tokens"):  # learned tokens (PointTransformer)
            m.init_tokens(generator)
        if isinstance(m, DensityHead):
            n = m.fc2.weight.shape[1]
            m.fc2.weight.copy_(m.pergroup * torch.arange(n)[None, :].float())
