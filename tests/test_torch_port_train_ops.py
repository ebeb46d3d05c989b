"""Port ops, losses and transforms of the train step held against the JAX
package on the CPU.

The same numpy inputs go through both; JAX runs on the CPU, its Pallas
kernels in interpret mode (or through the harness `tests/test_pallas.py`
uses), and the port takes its plain versions because the tensors lie on
the CPU. Random transforms: the port's apply functions take the JAX
package's own draws (recomputed from its key splits) and must give its
results exactly; the port's draws are held by their distribution.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mlsp_tpu import losses as JL
from mlsp_tpu.ops import chamfer as jchamfer
from mlsp_tpu.ops import density as jdensity
from mlsp_tpu.ops import normals as jnormals
from mlsp_tpu.ops.fps import fps as jax_fps
from mlsp_tpu.ops.fps import fps_gather as jax_fps_gather
from mlsp_tpu.ops.pallas import fps_pallas as jfps_pallas
from mlsp_tpu.ops.pallas.edge_pallas import edge_moments as jax_edge_moments
from mlsp_tpu.ops.pallas.normals_pallas import knn_moments_pallas
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.transforms import augment as jaugment
from mlsp_tpu.transforms import deform as jdeform
from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.ops import (
    density_labels,
    edge_moments,
    estimate_normals,
    fps,
    fps_gather,
    masked_chamfer,
    radius_count,
    reconstruction_loss,
)
from mlsp_tpu_torch.ops.normals import knn_moments_torch
from mlsp_tpu_torch.train import steps
from mlsp_tpu_torch.transforms import augment, deform


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _unit_clouds(seed, B, N):
    """Clouds centred and scaled into the unit ball, as the data pipeline
    delivers them (the deform voxels and density radius assume it)."""
    x = _cloud(seed, (B, N, 3))
    x -= x.mean(1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(-1)[:, None, None]


def _fps_pallas_interpret(xyz, npoint, start):
    """The TPU kernel's body `_fps_kernel` in interpret mode (the harness of
    tests/test_pallas.py::TestFpsPallas)."""
    B, N, _ = xyz.shape
    order = pl.pallas_call(
        functools.partial(jfps_pallas._fps_kernel, npoint=npoint),
        out_shape=jax.ShapeDtypeStruct((B, N), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((B, N), jnp.float32)],
        interpret=True,
    )(start.astype(jnp.int32)[:, None],
      jnp.swapaxes(xyz.astype(jnp.float32), 1, 2))
    return jnp.argsort(order, axis=-1, stable=True)[:, :npoint]


class TestFps:
    @pytest.mark.parametrize("N", [256, 100])
    def test_matches_jax(self, N):
        """Exactly the indices of the XLA path and of the Pallas body, the
        start given; the prefix property PCM relies on holds."""
        x = _cloud(N, (3, N, 3))
        start = np.random.default_rng(N + 1).integers(0, N, 3)
        got = fps(_t(x), N, _t(start)).numpy()
        assert got.dtype == np.int64
        want_xla = np.asarray(jax_fps(jnp.asarray(x), N,
                                      jnp.asarray(start, jnp.int32),
                                      backend="xla"))
        want_pallas = np.asarray(_fps_pallas_interpret(
            jnp.asarray(x), N, jnp.asarray(start)))
        np.testing.assert_array_equal(got, want_xla)
        np.testing.assert_array_equal(got, want_pallas)
        np.testing.assert_array_equal(
            fps(_t(x), N // 3, _t(start)).numpy(), got[:, : N // 3])
        np.testing.assert_array_equal(
            fps_gather(_t(x), _t(got)).numpy(),
            np.asarray(jax_fps_gather(jnp.asarray(x), jnp.asarray(got))))

    def test_rejects_bad_npoint(self):
        with pytest.raises(ValueError, match="npoint"):
            fps(torch.zeros(1, 8, 3), 9, torch.zeros(1, dtype=torch.int64))


class TestNormals:
    def test_knn_moments_match_pallas(self):
        x = _cloud(3, (2, 128, 3))
        s1, s2 = knn_moments_torch(_t(x), 20)
        w1, w2 = knn_moments_pallas(jnp.asarray(x), 20, interpret=True)
        np.testing.assert_allclose(s1.numpy(), np.asarray(w1),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s2.numpy(), np.asarray(w2),
                                   rtol=1e-5, atol=1e-5)

    def test_estimate_normals_match_xla(self):
        x = _cloud(4, (2, 256, 3))
        got = estimate_normals(_t(x), 20).numpy()
        want = np.asarray(jnormals.estimate_normals(jnp.asarray(x), 20,
                                                    backend="xla"))
        cos = np.abs((got * want).sum(-1))
        assert np.quantile(cos, 0.01) > 0.999, np.quantile(cos, 0.01)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)

    def test_collinear_cloud_falls_back_to_z(self):
        """A rank-1 neighbourhood (points on the x axis) has no unique
        normal: both packages fall back to z, unflipped (z·x = 0)."""
        x = np.zeros((1, 64, 3), np.float32)
        x[0, :, 0] = np.linspace(-1.0, 1.0, 64, dtype=np.float32)
        got = estimate_normals(_t(x), 20).numpy()
        want = np.asarray(jnormals.estimate_normals(jnp.asarray(x), 20,
                                                    backend="xla"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], np.tile([0.0, 0.0, 1.0],
                                                      (64, 1)))


class TestDensity:
    def test_cap_boundary(self):
        """The fixture of tests/test_ops.py::TestDensity::test_cap_boundary:
        >100 neighbours in radius, and point 0 at the cluster edge, in
        radius of every query but not among the 100 nearest of some."""
        rng = np.random.default_rng(0)
        core = (0.02 * rng.standard_normal((240, 3)) + 1.0).astype(np.float32)
        core[0] = core[1:].mean(0) + np.float32([0.08, 0.0, 0.0])
        got = radius_count(_t(core[None]), 0.5).numpy()
        want = np.asarray(jdensity.radius_count(jnp.asarray(core[None]), 0.5))
        assert want.max() == 100.0 and (want == 99.0).any()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("radius,shift", [(0.3, 0.0), (0.135, 2.0)])
    def test_labels_match_jax(self, radius, shift):
        x = _unit_clouds(5, 2, 256)
        cls, val = density_labels(_t(x), radius, 16, 2.0, shift)
        wcls, wval = jdensity.density_labels(jnp.asarray(x), radius, 16, 2.0,
                                             shift)
        np.testing.assert_array_equal(val.numpy(), np.asarray(wval))
        np.testing.assert_array_equal(cls.numpy(), np.asarray(wcls))


class TestChamfer:
    def _inputs(self):
        pred, gold = _cloud(6, (3, 64, 3)), _cloud(7, (3, 64, 3))
        mask = (np.random.default_rng(8).random((3, 64)) < 0.3).astype(
            np.float32)
        mask[1] = 0.0  # an empty mask: the cloud contributes 0, not NaN
        return pred, gold, mask

    def test_masked_chamfer_and_grad(self):
        pred, gold, mask = self._inputs()
        p = _t(pred).requires_grad_()
        got = reconstruction_loss(p, _t(gold), _t(mask))
        got.backward()
        want, wgrad = jax.jit(jax.value_and_grad(
            jchamfer.reconstruction_loss))(
            jnp.asarray(pred), jnp.asarray(gold), jnp.asarray(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-5, atol=1e-6)
        one = masked_chamfer(_t(pred), _t(gold), _t(mask))
        np.testing.assert_allclose(
            float(one), float(jchamfer.masked_chamfer(
                jnp.asarray(pred), jnp.asarray(gold), jnp.asarray(mask))),
            rtol=1e-5)

    def test_all_zero_mask_is_zero(self):
        pred, gold, _ = self._inputs()
        zero = np.zeros(pred.shape[:2], np.float32)
        assert float(reconstruction_loss(_t(pred), _t(gold), _t(zero))) == 0.0


class TestEdgeMomentsGrad:
    def test_grad_matches_jax_kernel(self):
        """The plain version's autograd gradient against `jax.grad` through
        the Pallas kernel's custom_vjp (interpret mode), with duplicated
        points and features so that the max and min are tied (the pattern
        of tests/test_pallas.py::test_backward_matches_gather_path)."""
        rng = np.random.default_rng(9)
        k = 6
        pts = rng.standard_normal((2, 64, 8)).astype(np.float32)
        pts[:, 17] = pts[:, 3]
        pts[:, 41] = pts[:, 3]
        u = rng.standard_normal((2, 64, 16)).astype(np.float32)
        u[:, 17] = u[:, 3]
        u[:, 41] = u[:, 3]
        w = rng.standard_normal((4, 2, 64, 16)).astype(np.float32)

        def f_jax(u_):
            outs = jax_edge_moments(jnp.asarray(pts), u_, k, True, tile=32,
                                    interpret=True)
            return sum((w[i] * o).sum() for i, o in enumerate(outs))

        want = np.asarray(jax.grad(f_jax)(jnp.asarray(u)))
        uu = _t(u).requires_grad_()
        outs = edge_moments(_t(pts), uu, k, True)
        sum((_t(w[i]) * o).sum() for i, o in enumerate(outs)).backward()
        np.testing.assert_allclose(uu.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _loss_inputs():
    rng = np.random.default_rng(10)
    B, N, C = 3, 40, 16
    p = rng.random((B * N, C)).astype(np.float32) + 0.05
    return {
        "logits": rng.standard_normal((B, 10)).astype(np.float32),
        "y_a": rng.integers(0, 10, B), "y_b": rng.integers(0, 10, B),
        "pred": rng.standard_normal((B, N, 3)).astype(np.float32),
        "gold": rng.standard_normal((B, N, 3)).astype(np.float32),
        "mask": (rng.random((B, N)) < 0.3).astype(np.float32),
        "p_vec": p / p.sum(-1, keepdims=True),
        "p_val": rng.random(B * N).astype(np.float32) * 30,
        "t_vec": np.eye(C, dtype=np.float32)[rng.integers(0, C, B * N)],
        "t_val": rng.random(B * N).astype(np.float32) * 30,
    }


LOSSES = {
    "cross_entropy": lambda m, a: m.cross_entropy(a["logits"], a["y_a"]),
    "mixup_cross_entropy": lambda m, a: m.mixup_cross_entropy(
        a["logits"], a["y_a"], a["y_b"], 0.3, 0.5),
    "defrec_loss": lambda m, a: m.defrec_loss(a["pred"], a["gold"],
                                              a["mask"], 0.5),
    "normal_loss": lambda m, a: m.normal_loss(a["pred"], a["gold"], 0.5),
    "region_weights": lambda m, a: m.region_weights(a["mask"], False),
    "region_weights_defpart": lambda m, a: m.region_weights(a["mask"], True),
    "masked_normal_loss": lambda m, a: m.masked_normal_loss(
        a["pred"], a["gold"], m.region_weights(a["mask"], False), 0.5),
    "density_loss": lambda m, a: m.density_loss(
        a["p_vec"], a["p_val"], a["t_vec"], a["t_val"], 0.05),
    "density_loss_masked": lambda m, a: m.density_loss(
        a["p_vec"], a["p_val"], a["t_vec"], a["t_val"], 0.05,
        mask=m.region_weights(a["mask"], False).reshape(-1)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    a = _loss_inputs()
    got = LOSSES[name](L, {k: _t(v) for k, v in a.items()})
    want = jax.jit(lambda a: LOSSES[name](JL, a))(
        {k: jnp.asarray(v) for k, v in a.items()})
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    assert L.DEFREC_SCALER == JL.DEFREC_SCALER


class TestTransforms:
    """The apply functions on the JAX package's own draws, exactly. The JAX
    side runs op by op (`jax.disable_jit`): under jit, XLA's CPU fusion
    contracts a*b + c into one FMA, a rounding that a program of separate
    elementwise ops (the port's, on any device) does not make."""

    def test_augment(self):
        """Exact given the rotation matrices; the matrices themselves
        within 1 ulp (cos and sin of the two libraries may round apart)."""
        x = _unit_clouds(11, 2, 128)
        key = jax.random.key(3)
        kr, kj = jax.random.split(key)
        ang = jax.random.uniform(kr, (2,), jnp.float32, 0.0, 2.0 * jnp.pi)
        R = jaugment._axis_rotation("z", jnp.cos(ang), jnp.sin(ang))
        noise = jax.random.normal(kj, x.shape, jnp.float32)
        got = steps.augment_batch(_t(x), _t(R), _t(noise)).numpy()
        with jax.disable_jit():
            want = np.asarray(jsteps.augment_batch(key, jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
        for axis in "xyz":
            np.testing.assert_allclose(
                augment.axis_rotation(_t(ang), axis).numpy(),
                np.asarray(jaugment._axis_rotation(axis, jnp.cos(ang),
                                                   jnp.sin(ang))),
                rtol=0, atol=2.0 ** -23)

    def test_regions(self):
        x = _unit_clouds(12, 2, 256)
        np.testing.assert_array_equal(deform.region_means(3).numpy(),
                                      np.asarray(jdeform.region_means(3)))
        np.testing.assert_array_equal(
            deform.assign_regions(_t(x)).numpy(),
            np.asarray(jdeform.assign_regions(jnp.asarray(x))))

    def test_deform_batch(self):
        x = _unit_clouds(13, 2, 256)
        key = jax.random.key(4)
        kperm, knoise = jax.random.split(key)
        perm = jax.vmap(lambda k: jax.random.permutation(k, 27))(
            jax.random.split(kperm, 2))
        noise = jax.random.normal(knoise, x.shape, jnp.float32)
        got, gmask = deform.deform_batch(_t(x), _t(perm).long(), _t(noise))
        with jax.disable_jit():
            want, wmask = jdeform.deform_batch(key, jnp.asarray(x))
        assert np.asarray(wmask).sum(-1).min() >= deform.MIN_PTS
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_collapse_to_point(self):
        x = _unit_clouds(14, 2, 128)
        key = jax.random.key(5)
        kpick, knoise = jax.random.split(key)
        gumbel = jax.random.gumbel(kpick, (2, 128))
        noise = jax.random.normal(knoise, x.shape, jnp.float32)
        got, gmask = deform.collapse_to_point_batch(_t(x), _t(gumbel),
                                                    _t(noise))
        with jax.disable_jit():
            want, wmask = jdeform.collapse_to_point_batch(key,
                                                          jnp.asarray(x))
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_pcm_mix_matches_jax(self):
        """The port's PCM on the JAX step's draws (`pcm_mix` key splits)."""
        B, N = 3, 64
        x = _unit_clouds(15, B, N)
        y = np.arange(B)
        key = jax.random.key(6)
        kperm, klam, ksa, ksb, kpts = jax.random.split(key, 5)
        draws = {
            "perm": jax.random.permutation(kperm, B),
            "lam": jax.random.beta(klam, 1.0, 1.0),
            "start_a": jax.random.randint(ksa, (B,), 0, N),
            "start_b": jax.random.randint(ksb, (B,), 0, N),
            "points": jax.random.permutation(kpts, N),
        }
        got, (ya, yb, lam) = steps.pcm_mix(
            _t(x), _t(y), {k: _t(v).long() if k != "lam" else _t(v)
                           for k, v in draws.items()})
        want, (wa, wb, wlam) = jsteps.pcm_mix(key, jnp.asarray(x),
                                              jnp.asarray(y), 1.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(yb.numpy(), np.asarray(wb))
        assert float(lam) == float(wlam)


class TestDraws:
    """The port's draws, held by their distribution (seeded)."""

    def test_rotation_and_jitter(self):
        g = torch.Generator().manual_seed(0)
        ang = augment.draw_rotation(g, 20000)
        assert 0.0 <= float(ang.min()) and float(ang.max()) < 2 * math.pi
        # uniform: mean pi, sd 2 pi / sqrt(12) / sqrt(n)
        assert abs(float(ang.mean()) - math.pi) < 4 * 1.8138 / math.sqrt(2e4)
        noise = augment.draw_jitter(g, (20000, 3))
        assert abs(float(noise.mean())) < 4 / math.sqrt(6e4)
        assert abs(float(noise.std()) - 1.0) < 0.02

    def test_deform_permutations(self):
        g = torch.Generator().manual_seed(1)
        perm, noise = deform.draw_deform(g, (3000, 16, 3))
        assert torch.equal(torch.sort(perm, -1).values,
                           torch.arange(27).expand(3000, 27))
        counts = torch.bincount(perm[:, 0], minlength=27).float()
        chi2 = float(((counts - 3000 / 27) ** 2 / (3000 / 27)).sum())
        assert chi2 < 60.0  # 26 degrees of freedom: p < 1e-3 beyond
        assert noise.shape == (3000, 16, 3)

    def test_pcm_draws(self):
        g = torch.Generator().manual_seed(2)
        lams = torch.stack([steps.draw_pcm(g, 8, 64, 1.0)["lam"]
                            for _ in range(2000)])
        assert 0.0 <= float(lams.min()) and float(lams.max()) < 1.0
        assert abs(float(lams.mean()) - 0.5) < 4 * 0.2887 / math.sqrt(2000)
        d = steps.draw_pcm(g, 8, 64, 0.4)  # Beta(0.4, 0.4) via numpy
        assert 0.0 <= float(d["lam"]) <= 1.0
        assert torch.equal(torch.sort(d["perm"]).values, torch.arange(8))
        assert torch.equal(torch.sort(d["points"]).values, torch.arange(64))
        assert int(d["start_a"].max()) < 64 and int(d["start_b"].min()) >= 0
