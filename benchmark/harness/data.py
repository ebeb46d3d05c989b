"""Seeded point clouds made on the card: the traffic's inputs.

Every cloud is a surface (or a curve or thin sheet) sampled at random, so
that the kNN graphs, the normals and the density labels see the
neighbourhoods a scan gives, not uniform noise. Classification domains
draw ten shape classes (the shapes of `mlsp_tpu_torch/data/synthetic.py`,
with its filled pyramid made a surface), each cloud with the domain's
gaussian noise, centred and scaled to the unit ball. Segmentation
clouds are stretched ellipsoid surfaces with per-point part labels, the
height bands of the body.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def derive_seed(*key) -> int:
    """A 63-bit seed from a tuple of non-negative integers."""
    return int(np.random.SeedSequence(key).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def _u(g, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _shape(cls: int, g, m: int, n: int) -> torch.Tensor:
    """m clouds of n points of shape class `cls` (0-9): [m, n, 3]."""
    dev, two_pi = g.device, 2.0 * math.pi
    if cls in (0, 8):  # sphere; two spheres
        v = torch.randn(m, n, 3, generator=g, device=dev)
        v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if cls == 8:
            v = v * 0.5
            v[:, : n // 2, 0] -= 0.6
            v[:, n // 2:, 0] += 0.6
        return v
    if cls == 1:  # cube surface
        p = _u(g, (m, n, 3), -1.0, 1.0)
        ax = torch.randint(0, 3, (m, n), generator=g, device=dev)
        sign = torch.where(_u(g, (m, n)) < 0.5, -1.0, 1.0)
        return torch.where(torch.nn.functional.one_hot(ax, 3).bool(),
                           sign[..., None], p)
    if cls == 2:  # cylinder
        th, z = _u(g, (m, n), 0, two_pi), _u(g, (m, n), -1.0, 1.0)
        return torch.stack([th.cos(), th.sin(), z], -1)
    if cls == 3:  # cone
        z, th = _u(g, (m, n)), _u(g, (m, n), 0, two_pi)
        r = 1.0 - z
        return torch.stack([r * th.cos(), r * th.sin(), 2 * z - 1], -1)
    if cls == 4:  # torus
        u, v = _u(g, (m, n), 0, two_pi), _u(g, (m, n), 0, two_pi)
        rr = 0.8 + 0.3 * v.cos()
        return torch.stack([rr * u.cos(), rr * u.sin(), 0.3 * v.sin()], -1)
    if cls == 5:  # thin plate
        p = _u(g, (m, n, 3), -1.0, 1.0)
        return p * torch.tensor([1.0, 1.0, 0.05], device=dev)
    if cls == 6:  # pyramid surface: four faces
        z = _u(g, (m, n))
        s = 1.0 - z
        t = _u(g, (m, n), -1.0, 1.0) * s
        face = torch.randint(0, 4, (m, n), generator=g, device=dev)
        side = torch.where(face % 2 == 0, s, -s)
        x = torch.where(face < 2, side, t)
        y = torch.where(face < 2, t, side)
        return torch.stack([x, y, 2 * z - 1], -1)
    if cls == 7:  # helix
        t = _u(g, (m, n), 0, 4 * math.pi)
        return torch.stack([t.cos(), t.sin(), t / two_pi - 1], -1) + \
            0.05 * torch.randn(m, n, 3, generator=g, device=dev)
    # 9: a cross of two thin bars
    p = _u(g, (m, n, 3), -1.0, 1.0) * torch.tensor([1.0, 0.08, 0.08],
                                                   device=dev)
    flip = _u(g, (m, n)) < 0.5
    return torch.where(flip[..., None], p[..., [1, 0, 2]], p)


def _unit_ball(p: torch.Tensor) -> torch.Tensor:
    p = p - p.mean(1, keepdim=True)
    return p / p.norm(dim=-1).amax(1)[:, None, None].clamp_min(1e-12)


def classification(seed: int, m: int, n: int, noise: float,
                   num_classes: int, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """m clouds [m, n, 3] float32 and labels [m] int64, both on `device`:
    the classes in equal shares, shuffled."""
    g = torch.Generator(device=device).manual_seed(seed)
    labels = (torch.arange(m, device=device) % num_classes)[
        torch.randperm(m, generator=g, device=device)]
    x = torch.empty(m, n, 3, device=device)
    for c in range(num_classes):
        rows = (labels == c).nonzero()[:, 0]
        if len(rows):
            p = _shape(c % 10, g, len(rows), n)
            p = p + noise * torch.randn(p.shape, generator=g, device=device)
            x[rows] = _unit_ball(p)
    return x, labels


def segmentation(seed: int, m: int, n: int, num_classes: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """m body-like clouds [m, n, 3] on stretched ellipsoid surfaces, and
    their part labels [m, n] int64: num_classes height bands."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(m, n, 3, generator=g, device=device)
    v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    axes = torch.tensor([0.3, 0.2, 1.0], device=device) * _u(
        g, (m, 1, 3), 0.85, 1.15)
    p = _unit_ball(v * axes + 0.01 * torch.randn(m, n, 3, generator=g,
                                                 device=device))
    z = p[..., 2]
    lo, hi = z.amin(1, keepdim=True), z.amax(1, keepdim=True)
    band = torch.floor((z - lo) / (hi - lo + 1e-9) * num_classes)
    return p, band.clamp(0, num_classes - 1).long()


def split(m: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference trainer's 8/10 split of m examples: (train, val)
    indices, each shuffled by numpy's generator of `seed`."""
    rng = np.random.default_rng(seed)
    i = np.arange(m)
    train, val = i[i % 10 < 8], i[i % 10 >= 8]
    rng.shuffle(train)
    rng.shuffle(val)
    return train, val
