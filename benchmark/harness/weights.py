"""Seeded weights made on the card, in two draws: the inputs both the
system under test and the reference are given.

A matmul weight is normal with standard deviation 1/sqrt(fan-in) (flax's
lecun_normal, as the port initialises); biases are small normals;
BatchNorm's gamma and running variance are uniform on [0.5, 1.5) and
its beta and running mean small normals, away from their initial values
so that an eval-mode BatchNorm does real work; the density head's bins
are the configuration's fixed `pergroup * arange(num_class)`.
"""

from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device, pergroup: float) -> dict:
    """{state_dict name: tensor} for a reference module's `spec`."""
    n_norm = n_unif = 0
    for _, shape, kind in spec:
        size = math.prod(shape)
        if kind in ("w", "b"):
            n_norm += size
        elif kind == "bn":
            n_norm += 2 * size
            n_unif += 2 * size
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(n_norm, generator=g, device=device)
    u = torch.rand(n_unif, generator=g, device=device)
    zi = ui = 0

    def take_z(shape, scale):
        nonlocal zi
        size = math.prod(shape)
        zi += size
        return z[zi - size:zi].view(shape) * scale

    def take_u(shape):
        nonlocal ui
        size = math.prod(shape)
        ui += size
        return u[ui - size:ui].view(shape) + 0.5

    out = {}
    for name, shape, kind in spec:
        if kind == "w":
            out[name] = take_z(shape, math.prod(shape[1:]) ** -0.5)
        elif kind == "b":
            out[name] = take_z(shape, 0.02)
        elif kind == "bn":
            out[f"{name}.weight"] = take_u(shape)
            out[f"{name}.bias"] = take_z(shape, 0.1)
            out[f"{name}.running_mean"] = take_z(shape, 0.1)
            out[f"{name}.running_var"] = take_u(shape)
            out[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
        elif kind == "bins":
            out[name] = pergroup * torch.arange(
                shape[1], dtype=torch.float32, device=device)[None]
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
    return out


def trainable(spec: list) -> list[str]:
    """The names an optimizer moves: matmul weights, biases and BatchNorm's
    gamma and beta (not its running statistics, not the frozen bins)."""
    names = []
    for name, _, kind in spec:
        if kind in ("w", "b"):
            names.append(name)
        elif kind == "bn":
            names += [f"{name}.weight", f"{name}.bias"]
    return names
