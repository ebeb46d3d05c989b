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

Dropout draws its masks from the `torch.Generator` the caller passes to
`forward` (`dropout` below), never from the global RNG; in train mode a
layer with dropout > 0 needs one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def act_fn(name: str):
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    raise ValueError(f"unknown activation {name!r}")


class PointwiseConv(nn.Module):
    """A 1x1 Conv1d (rank 1) or Conv2d (rank 2) of the reference, run
    channels-last as a matmul. The weight keeps the conv's shape,
    [out, in, 1] or [out, in, 1, 1], so the state_dict matches."""

    def __init__(self, cin: int, cout: int, rank: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(1,) * rank))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


def linear_in(layer: nn.Module, x) -> torch.Tensor:
    """Apply `layer` (PointwiseConv or nn.Linear) to x, or to the implicit
    concat [a | broadcast(b)] when x is a (per-point a [B, N, Ca], global
    b [B, Cb]) pair, as the JAX package's `SplitDense` does: the global half
    is multiplied once per cloud and the concat is never built."""
    if not isinstance(x, tuple):
        return layer(x)
    a, b = x
    w = layer.weight.flatten(1)
    ca = a.shape[-1]
    y = F.linear(a, w[:, :ca]) + F.linear(b, w[:, ca:])[..., None, :]
    return y if layer.bias is None else y + layer.bias


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over every axis but the last (channels-last), in at least
    float32; the result keeps x's dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    y = bn(x.reshape(-1, x.shape[-1]).to(wide)).reshape(x.shape)
    return y.to(x.dtype)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`: keep with probability 1 - p,
    scale kept values by 1 / (1 - p)) with the mask drawn from `generator`,
    which must live on x's device."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(pass generator= to the model's forward)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class DenseBN(nn.Module):
    """Dense -> BatchNorm -> activation: the reference's `conv_2d`
    (`conv=True`: parameters `conv.0`, `conv.1`, a rank-2 1x1 conv) or
    `fc_layer` (`conv=False`: `fc.0`, `fc.1`, an nn.Linear)."""

    def __init__(self, cin: int, cout: int, activation: str, bias: bool,
                 conv: bool):
        super().__init__()
        lin = PointwiseConv(cin, cout, 2, bias) if conv else nn.Linear(
            cin, cout, bias=bias)
        layers = nn.ModuleList([lin, nn.BatchNorm1d(cout)])
        if conv:
            self.conv = layers
        else:
            self.fc = layers
        self.act = act_fn(activation)

    def forward(self, x):
        lin, bn = self.conv if hasattr(self, "conv") else self.fc
        return self.act(batch_norm(bn, linear_in(lin, x)))


class TransformNet(nn.Module):
    """DGCNN's 3x3 input transform (reference `transform_net`): edge
    features [B, N, k, 6] -> [B, 3, 3], the identity plus a learned term."""

    def __init__(self, out: int = 3):
        super().__init__()
        self.out = out
        self.conv2d1 = DenseBN(2 * out, 64, "leakyrelu", False, conv=True)
        self.conv2d2 = DenseBN(64, 128, "leakyrelu", False, conv=True)
        self.conv2d3 = DenseBN(128, 1024, "leakyrelu", False, conv=True)
        self.fc1 = DenseBN(1024, 512, "leakyrelu", False, conv=False)
        self.fc2 = DenseBN(512, 256, "leakyrelu", True, conv=False)
        self.fc3 = nn.Linear(256, out * out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d2(self.conv2d1(x)).amax(-2)  # over k
        x = self.conv2d3(x).amax(-2)  # over N
        x = self.fc3(self.fc2(self.fc1(x)))
        eye = torch.eye(self.out, dtype=x.dtype, device=x.device).reshape(-1)
        return (x + eye).reshape(x.shape[0], self.out, self.out)


class Classifier(nn.Module):
    """Global-feature classifier head (reference `classifier`, DGCNN form)."""

    def __init__(self, cin: int, num_classes: int, dropout: float = 0.5):
        super().__init__()
        self.mlp1 = DenseBN(cin, 512, "leakyrelu", True, conv=False)
        self.mlp2 = DenseBN(512, 256, "leakyrelu", True, conv=False)
        self.mlp3 = nn.Linear(256, num_classes)
        self.p = dropout

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(self.mlp1(x), self.p, self.training, generator)
        x = dropout(self.mlp2(x), self.p, self.training, generator)
        return self.mlp3(x)


class PointMLPHead(nn.Module):
    """Per-point regression head (reference `RegionReconstruction` /
    `Normal_prediction`): 256 -> 256 -> 128 -> out, BN + ReLU + dropout,
    bias-free 1x1 convs."""

    def __init__(self, cin: int, out: int = 3, dropout: float = 0.5):
        super().__init__()
        self.conv1 = PointwiseConv(cin, 256, 1, False)
        self.bn1 = nn.BatchNorm1d(256)
        self.conv2 = PointwiseConv(256, 256, 1, False)
        self.bn2 = nn.BatchNorm1d(256)
        self.conv3 = PointwiseConv(256, 128, 1, False)
        self.bn3 = nn.BatchNorm1d(128)
        self.conv4 = PointwiseConv(128, out, 1, False)
        self.p = dropout

    def forward(self, x, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.p, self.training, generator)

        x = drop(F.relu(batch_norm(self.bn1, linear_in(self.conv1, x))))
        x = drop(F.relu(batch_norm(self.bn2, self.conv2(x))))
        x = F.relu(batch_norm(self.bn3, self.conv3(x)))
        return self.conv4(x)


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
        self.mlp3 = nn.Linear(256, num_cls)
        self.fc2 = nn.Linear(num_cls, 1, bias=False)
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
        # elementwise, so a bf16 autocast region leaves it in float32
        return p_vec, (p_vec * self.fc2.weight[0]).sum(-1)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as the JAX package does: matmul weights from a normal of
    std 1/sqrt(fan_in) (flax's lecun_normal, untruncated), biases 0,
    BatchNorm gamma 1, beta 0 and running stats (0, 1); density bins fixed.
    Draws from `generator`, so a seed gives the same weights on any device
    (initialise on the CPU, then move)."""
    for m in model.modules():
        if isinstance(m, (PointwiseConv, nn.Linear)):
            fan_in = m.weight.flatten(1).shape[1]
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
    for m in model.modules():  # after the loop above, which drew fc2 too
        if isinstance(m, DensityHead):
            n = m.fc2.weight.shape[1]
            m.fc2.weight.copy_(m.pergroup * torch.arange(n)[None, :].float())
