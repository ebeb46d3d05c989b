"""The port's PointNet, PointNet++, PointTransformer and Hengshuang models
(classifier and segmenter) and their ops, held against the JAX package on
the CPU at small sizes.

Weights go across with `utils.jax_weights` (randomised BatchNorm: gamma of
both signs, beta and running statistics away from init), gradients come
back with its `*_grads_from_jax`. Dropout is 0 on both sides (the one
random stream that cannot be shared). Each model's eval forward and its
gradients, and its train forward (outputs and BatchNorm running
statistics), are held at rtol 1e-4 / atol 1e-4 (statistics atol 1e-5;
gradients 1e-4 relative L2, `testing.grad_gaps`; the train forward plus
JAX's own chaos floor), each side on its own kNN graphs and FPS orders:
the inputs are standard-normal clouds, where the two packages' float32
distances pick the same neighbours. PointNet++ runs on coordinates that
are multiples of 1/128 in [-0.5, 0.5]: every squared distance is then
exact in float32 in both packages and lies at least 2e-5 from either
ball radius squared, so no point sits within rounding of a ball's edge.
It needs N >= 512 (its first FPS takes 512 centroids). Its millions of
ReLU inputs hold, on typical inputs, a few within float32 rounding of 0
(|z| ~ 1e-8), and its max-pools over up to 512 candidates a few near
ties; the two packages' rounding can flip either kink, moving one
element's share of a gradient by ~1e-3 of a tensor's norm (seeds 1, 2 and
5 of six; the port agrees with its own float64 run to 1e-6 there). So its
gradients are held with JAX on the port's ReLU signs and max-pool picks
(`_jax_on_kinks`), as the DGCNN tests replay the port's kNN graphs.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

from mlsp_tpu.losses import losses as jlosses
from mlsp_tpu.models.hengshuang import HengshuangSeg as JaxHengshuangSeg
from mlsp_tpu.models.hengshuang import HengshuangTransformer as JaxHengshuang
from mlsp_tpu.models.pointnet import PointNet as JaxPointNet
from mlsp_tpu.models.pointnet2 import PointNet2SSG as JaxPointNet2
from mlsp_tpu.models.transformer import PointTransformer as JaxPT
from mlsp_tpu.models.transformer import feature_propagation as jax_fp
from mlsp_tpu.ops import grouping as jgrouping
from mlsp_tpu.ops import knn as jknn
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils import torch_export
from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
from mlsp_tpu_torch.models import make_model, model_kwargs
from mlsp_tpu_torch.models.transformer import feature_propagation
from mlsp_tpu_torch.ops import kernels
from mlsp_tpu_torch.ops.grouping import ball_query, group_points
from mlsp_tpu_torch.ops.knn import knn_indices
from mlsp_tpu_torch.testing import grad_gaps
from mlsp_tpu_torch.train import pointda_losses
from mlsp_tpu_torch.train.steps import check_recipe
from mlsp_tpu_torch.utils import jax_weights as jw
from mlsp_tpu_torch.utils.config import PointDAConfig

_jlayers = importlib.import_module("mlsp_tpu.models.layers")
_jpointnet2 = importlib.import_module("mlsp_tpu.models.pointnet2")
B = 4
STEP_N = 128  # a DefRec region holds at least 40 points
PT_KW = dict(trans_dim=32, depth=2, heads=2, num_group=8, group_size=8,
             encoder_dims=32, fetch_idx=(0, 1))
HS_KW = dict(nblocks=2, d_model=16)


@dataclasses.dataclass(frozen=True)
class Family:
    jax_model: object  # a flax module, dropout 0
    port_kw: dict  # make_model keywords beside dropout 0
    heads: tuple
    n: int
    classes: int
    convert: object
    grads: object


FAMILIES = {
    "pointnet": Family(JaxPointNet(num_classes=10, dropout=0.0), {},
                       ("defrec",), 64, 10, jw.pointnet_state_dict_from_jax,
                       jw.pointnet_grads_from_jax),
    "pointnet2": Family(JaxPointNet2(num_classes=10, dropout=0.0,
                                     knn_backend="xla"), {}, (), 512, 10,
                        jw.pointnet2_state_dict_from_jax,
                        jw.pointnet2_grads_from_jax),
    "point_transformer": Family(
        JaxPT(num_classes=10, dropout=0.0, knn_backend="xla", **PT_KW),
        PT_KW, ("defrec",), 64, 10, jw.point_transformer_state_dict_from_jax,
        jw.point_transformer_grads_from_jax),
    "hengshuang": Family(
        JaxHengshuang(num_classes=10, dropout=0.0, knn_backend="xla",
                      **HS_KW), HS_KW, ("defrec",), 64, 10,
        jw.hengshuang_state_dict_from_jax, jw.hengshuang_grads_from_jax),
    "hengshuang_seg": Family(
        JaxHengshuangSeg(num_classes=8, dropout=0.0, knn_backend="xla",
                         **HS_KW), HS_KW, ("seg", "defrec"), 64, 8,
        jw.hengshuang_state_dict_from_jax, jw.hengshuang_grads_from_jax),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small CPU forwards here run several times
    faster than with a thread per core beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomised(v: dict, seed: int) -> dict:
    """`v` with every norm's scale of both signs in 0.5..1.5, every bias
    and running mean 0.1 N(0, 1), every running variance in 0.5..1.5."""
    rng = np.random.default_rng(seed)

    def param(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "scale":
            sign = rng.choice([-1.0, 1.0], a.shape)
            return (sign * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v.get("batch_stats", {}))}


@functools.cache
def _jax_init(name: str):
    f = FAMILIES[name]
    return jax.jit(lambda r: f.jax_model.init(
        {"params": r}, jnp.zeros((1, f.n, 3)), train=False, heads=f.heads))


def variables(name: str, seed: int = 0) -> dict:
    return randomised(_jax_init(name)(jax.random.key(seed)), seed)


def port(name: str, v: dict) -> torch.nn.Module:
    f = FAMILIES[name]
    model = make_model(name, f.classes, device="cpu", dropout=0.0,
                       **f.port_kw)
    model.load_state_dict(f.convert(v), strict=True)
    return model


def clouds(name: str, seed: int, n: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = n or FAMILIES[name].n
    if name == "pointnet2":  # multiples of 1/128: exact distances
        return (rng.integers(-64, 65, (B, n, 3)) / 128.0).astype(np.float32)
    return rng.standard_normal((B, n, 3)).astype(np.float32)


@contextlib.contextmanager
def _port_kinks(model):
    """Records, in call order, the port's PointNet++ kinks: the signs of
    its ReLU inputs (each `FlaxDenseBN`'s BatchNorm output) and the points
    its three max-pools take (the first maximum: their exact ties are
    padded duplicates of one point, whose shares add up the same)."""
    kinks = {"relu": [], "max": []}
    hooks = [m.BatchNorm_0.register_forward_hook(
        lambda m, i, out: kinks["relu"].append(out.detach().numpy() > 0))
        for m in model.modules() if type(m).__name__ == "FlaxDenseBN"]
    for m, axis in ((model.SetAbstraction_0.DenseBN_2, -2),
                    (model.SetAbstraction_1.DenseBN_2, -2),
                    (model.GlobalAbstraction_0.DenseBN_2, 1)):
        hooks.append(m.register_forward_hook(
            lambda m, i, out, axis=axis: kinks["max"].append(
                out.detach().argmax(axis).numpy())))
    try:
        yield kinks
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def _jax_on_kinks(kinks):
    """JAX's PointNet++ ReLUs (its `DenseBN`s' activations) and max-pools
    (`jnp.max` of its module), in call order, take the port's branches:
    the two gradients then differ by rounding alone."""
    signs, picks = iter(kinks["relu"]), iter(kinks["max"])

    def act_fn(name):
        assert name == "relu"
        return lambda x: jnp.where(
            jnp.asarray(next(signs)).reshape(x.shape), x, 0.0)

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def max(g, axis):
            idx = jnp.expand_dims(jnp.asarray(next(picks)), axis)
            return jnp.take_along_axis(g, idx, axis=axis).squeeze(axis)

    with mock.patch.object(_jlayers, "act_fn", act_fn), \
            mock.patch.object(_jpointnet2, "jnp", Jnp()):
        yield
    assert next(signs, None) is None and next(picks, None) is None


class TestOps:
    def test_cross_knn_matches_jax(self):
        """Random clouds, then integer coordinates (exact distances, many
        ties, which both order by the lower index): equal indices."""
        rng = np.random.default_rng(0)
        for x, y in ((rng.standard_normal((3, 20, 3)),
                      rng.standard_normal((3, 70, 3))),
                     (rng.integers(-2, 3, (3, 20, 3)),
                      rng.integers(-2, 3, (3, 70, 3)))):
            x, y = x.astype(np.float32), y.astype(np.float32)
            for k in (1, 16, 70):
                want = jknn.knn_indices(jnp.asarray(x), k, y=jnp.asarray(y),
                                        backend="xla")
                got = knn_indices(torch.from_numpy(x), k,
                                  y=torch.from_numpy(y))
                assert got.dtype == torch.int64
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(ValueError, match="exceeds"):
            knn_indices(torch.zeros(1, 4, 3), 9, y=torch.zeros(1, 8, 3))

    def test_cross_knn_launches_no_kernel(self):
        kernels.reset_launches()
        knn_indices(torch.zeros(1, 4, 3), 2, y=torch.zeros(1, 8, 3),
                    backend="auto")
        assert not any(kernels.launches().values())
        with pytest.raises(ValueError, match="backend"):
            knn_indices(torch.zeros(1, 4, 3), 2, y=torch.zeros(1, 8, 3),
                        backend="pallas")

    @pytest.mark.parametrize("radius", [0.05, 0.2, 0.4])
    def test_ball_query_and_group_points_match_jax(self, radius):
        """Coordinates in multiples of 1/128 (exact squared distances, at
        least 2e-5 from r² for these radii): equal indices, with short
        balls (r = 0.05) padded by their first hit and empty balls (centers
        away from the cloud) at index 0; the grouped neighbourhoods equal."""
        rng = np.random.default_rng(1)
        xyz = (rng.integers(-64, 65, (2, 100, 3)) / 128.0).astype(np.float32)
        centers = np.concatenate(
            [xyz[:, :12], np.full((2, 2, 3), 3.0, np.float32)], axis=1)
        feats = rng.standard_normal((2, 100, 5)).astype(np.float32)
        want = np.asarray(jgrouping.ball_query(
            jnp.asarray(xyz), jnp.asarray(centers), radius, 16))
        got = ball_query(torch.from_numpy(xyz), torch.from_numpy(centers),
                         radius, 16)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[:, -2:] == 0).all()  # empty balls
        if radius == 0.05:
            assert (got[:, :12, -1] == got[:, :12, 0]).any()  # short balls
        g_want = jgrouping.group_points(jnp.asarray(xyz), jnp.asarray(feats),
                                        jnp.asarray(centers), jnp.asarray(want))
        g_got = group_points(torch.from_numpy(xyz), torch.from_numpy(feats),
                             torch.from_numpy(centers), got)
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("s", [1, 2, 9])
    def test_feature_propagation_matches_jax(self, s):
        """k = min(3, S): one source point copies its features."""
        rng = np.random.default_rng(s)
        dst = rng.standard_normal((2, 40, 3)).astype(np.float32)
        src = rng.standard_normal((2, s, 3)).astype(np.float32)
        f = rng.standard_normal((2, s, 6)).astype(np.float32)
        want = jax_fp(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(f))
        got = feature_propagation(torch.from_numpy(dst), torch.from_numpy(src),
                                  torch.from_numpy(f))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


class TestWeights:
    @pytest.mark.parametrize("name,export,extra", [
        ("pointnet", torch_export.export_pointnet, ()),
        ("point_transformer", torch_export.export_point_transformer,
         ("attn.qkv.bias", "DefRec.")),
        ("hengshuang", lambda v: torch_export.export_hengshuang(v, 2), ()),
        ("hengshuang_seg", lambda v: torch_export.export_hengshuang(
            v, 2, strict=False), ("DefRec.",)),
    ])
    def test_equals_the_jax_exporter(self, name, export, extra):
        """Every key the JAX exporter emits, with its array, bit for bit;
        beyond them only what the reference layout cannot hold (the
        PointTransformer's q/k/v biases and DefRec head, HengshuangSeg's
        DefRec head); the port loads it strictly."""
        v = variables(name, 3)
        got = FAMILIES[name].convert(v)
        with (pytest.warns(UserWarning, match="qkv biases")
              if name == "point_transformer" else contextlib.nullcontext()):
            want = export(v)
        assert set(want) <= set(got)
        assert all(any(e in k for e in extra) for k in set(got) - set(want))
        if extra:
            assert set(got) - set(want)
        for key, a in want.items():
            assert got[key].numpy().dtype == np.asarray(a).dtype, key
            np.testing.assert_array_equal(got[key].numpy(), a, err_msg=key)
        port(name, v)

    def test_pointnet2_keeps_the_flax_paths(self):
        v = variables("pointnet2", 4)
        got = jw.pointnet2_state_dict_from_jax(v)
        leaf = v["params"]["SetAbstraction_1"]["DenseBN_2"]
        np.testing.assert_array_equal(
            got["SetAbstraction_1.DenseBN_2.Dense_0.weight"].numpy(),
            np.asarray(leaf["Dense_0"]["kernel"]).T)
        np.testing.assert_array_equal(
            got["SetAbstraction_1.DenseBN_2.BatchNorm_0.running_var"].numpy(),
            np.asarray(v["batch_stats"]["SetAbstraction_1"]["DenseBN_2"][
                "BatchNorm_0"]["var"]))
        port("pointnet2", v)

    def test_missing_head_raises(self):
        m = FAMILIES["hengshuang"].jax_model
        v = jax.jit(lambda r: m.init({"params": r}, jnp.zeros((1, 64, 3)),
                                     train=False))(jax.random.key(0))
        with pytest.raises(ValueError, match="UpDecoder_0"):
            jw.hengshuang_state_dict_from_jax(v)


@functools.cache
def _jax_train_forward(name: str):
    """JAX's train-mode outputs and new batch_stats."""
    f = FAMILIES[name]
    return jax.jit(lambda v, x: f.jax_model.apply(
        v, x, train=True, heads=f.heads, mutable=["batch_stats"]))


def _jax_eval_grads(name: str):
    """(outputs, gradient of sum(w * outputs)) of JAX's eval forward."""
    f = FAMILIES[name]

    def loss(params, bstats, x, w):
        o = f.jax_model.apply({"params": params, "batch_stats": bstats}, x,
                              train=False, heads=f.heads)
        return sum((w[n] * o[n]).sum() for n in w), o

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_grads(model, want: dict) -> dict:
    """The port's gradients under the names of `want`, zeros where a
    parameter got none (no loss reaches it)."""
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    return {n: (named[n].grad if named[n].grad is not None
                else torch.zeros_like(named[n])) for n in want}


def _loss_weights(out: dict) -> dict:
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(t.shape).astype(np.float32)
            for n, t in out.items()}


class TestForward:
    @pytest.mark.parametrize("name", list(FAMILIES))
    def test_eval_outputs_and_grads_match_jax(self, name):
        """Eval-mode BN: every output at rtol 1e-4 / atol 1e-4 and the
        gradient of every parameter of a loss sum(w * outputs) within 1e-4
        relative L2."""
        f = FAMILIES[name]
        v = variables(name, 1)
        x = clouds(name, 2)
        model = port(name, v)
        with (_port_kinks(model) if name == "pointnet2"
              else contextlib.nullcontext(None)) as kinks:
            out = model(torch.from_numpy(x), heads=f.heads)
        w = _loss_weights(out)
        sum((torch.from_numpy(w[n]) * out[n]).sum() for n in w).backward()
        with (_jax_on_kinks(kinks) if kinks else contextlib.nullcontext()):
            (_, want), grads = _jax_eval_grads(name)(
                v["params"], v["batch_stats"], jnp.asarray(x), w)
        assert set(out) == set(want)
        for key in want:
            np.testing.assert_allclose(out[key].detach().numpy(),
                                       np.asarray(want[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=key)
        want_g = f.grads(grads)
        bad = {n: g for n, g in grad_gaps(_port_grads(model, want_g),
                                          want_g).items() if g > 1e-4}
        assert not bad, bad

    @pytest.mark.parametrize("name", list(FAMILIES))
    def test_train_outputs_and_stats_match_jax(self, name):
        """Train-mode BN: the outputs and the updated running statistics,
        each within its bound (rtol 1e-4, atol 1e-4; statistics atol 1e-5)
        plus 3 times JAX's own change when the input moves by 1e-6 (its
        chaos floor: a train-mode BN over the batch of 4 clouds, in
        PointNet's T-nets and classifier and PointNet++'s head, amplifies
        float32 rounding about a hundredfold, as in the DGCNN tests)."""
        f = FAMILIES[name]
        v = variables(name, 5)
        x = clouds(name, 6)
        model = port(name, v).train()
        with torch.no_grad():
            out = model(torch.from_numpy(x), heads=f.heads)
        want, mut = _jax_train_forward(name)(v, jnp.asarray(x))
        moved, moved_mut = _jax_train_forward(name)(v, jnp.asarray(x + 1e-6))
        for n in out:
            a = np.asarray(want[n])
            floor = np.abs(np.asarray(moved[n]) - a).max()
            np.testing.assert_allclose(out[n].numpy(), a, rtol=1e-4,
                                       atol=1e-4 + 3.0 * floor, err_msg=n)

        def running(m):
            return {k: t for k, t in f.convert(
                {"params": v["params"], "batch_stats": m["batch_stats"]}
            ).items() if k.endswith(("running_mean", "running_var"))}

        sd, moved_stats = model.state_dict(), running(moved_mut)
        for k, t in running(mut).items():
            floor = float((moved_stats[k] - t).abs().max())
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-5 + 3.0 * floor, err_msg=k)
            assert int(sd[k.replace(k.rsplit(".", 1)[1],
                                    "num_batches_tracked")]) == 1


def _jax_state(name, v, cfg_j):
    f = FAMILIES[name]
    return jstate.TrainState.create(
        apply_fn=f.jax_model.apply, params=v["params"],
        batch_stats=v["batch_stats"],
        tx=jstate.make_optimizer("ADAM", cfg_j.lr, cfg_j.wd, 0.9,
                                 cfg_j.epochs, 10))


class TestStep:
    @pytest.mark.parametrize("name", ["pointnet", "pointnet2",
                                      "point_transformer", "hengshuang"])
    def test_losses_and_grads_match_jax(self, name):
        """One PointDA iteration at N=128 (PointNet++ 512), PCM plus DefRec on the target (PointNet++,
        which has no DefRec head: PCM alone), fed the JAX step's own draws
        (`debug_aux`; the deformed target re-derived from the step's key
        split with JAX's `deform_dispatch`), eval-mode BN: every loss term
        within rtol 1e-4 and every gradient within 1e-4 relative L2 (for
        PointNet++ against JAX's gradient of the same loss on the step's
        mixed clouds on the port's ReLU signs and max-pool picks)."""
        f = FAMILIES[name]
        defrec = "defrec" in f.heads
        n = max(f.n, STEP_N)
        flags = dict(batch_size=B, num_points=n, dropout=0.0, model=name,
                     apply_PCM=True, DefRec_on_trgt=defrec)
        cfg_j = dataclasses.replace(JaxConfig(knn_backend="xla", **flags),
                                    debug_aux=True, debug_bn_eval=True)
        cfg = dataclasses.replace(PointDAConfig(**flags), debug_bn_eval=True)
        check_recipe(cfg)
        v = variables(name, 8)
        src, trgt = clouds(name, 9, n), clouds(name, 10, n)
        if name != "pointnet2":
            src /= np.abs(src).max()
            trgt /= np.abs(trgt).max()
        src_y = np.random.default_rng(11).integers(0, 10, B)
        key = jax.random.key(12)
        # PointNet++: no augmentation on the JAX side, so that the clouds
        # stay on the 1/128 grid (the port takes the step's clouds as
        # inputs either way)
        with (mock.patch.object(jsteps, "augment_batch", lambda k, x: x)
              if name == "pointnet2" else contextlib.nullcontext()):
            _, m = jsteps.pointda_train_step(
                _jax_state(name, v, cfg_j), jnp.asarray(src),
                jnp.asarray(src_y), jnp.asarray(trgt), key, cfg_j)
        aux = {k: torch.from_numpy(np.array(a)) for k, a in m.items()
               if k.startswith("aux_") and k != "aux_grads"}
        draws = {"mixed": aux["aux_mixed"], "ya": aux["aux_ya"].long(),
                 "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"]}
        if defrec:
            keys = jax.random.split(key, 17)
            dx, mask = jsteps.deform_dispatch(
                keys[8], jnp.asarray(aux["aux_trgt"].numpy()), cfg_j)
            assert float(mask.sum(-1).min()) >= 40  # a region each
            draws.update(trgt_dx=torch.from_numpy(np.array(dx)),
                         trgt_dmask=torch.from_numpy(np.array(mask)))
        model = port(name, v)
        with (_port_kinks(model) if name == "pointnet2"
              else contextlib.nullcontext(None)) as kinks:
            total, got = pointda_losses(
                model, cfg, {"src_x": aux["aux_src"],
                             "src_y": torch.from_numpy(src_y),
                             "trgt_x": aux["aux_trgt"]}, draws, None)
        total.backward()
        assert set(got) == {k for k in m if not k.startswith("aux_")}
        for n, t in got.items():
            assert abs(t.item() / float(m[n]) - 1.0) <= 1e-4, (
                n, t.item(), float(m[n]))
        grads = m["aux_grads"]
        if kinks:  # PointNet++: PCM alone, on the port's kinks
            def loss(p):
                o = f.jax_model.apply(
                    {"params": p, "batch_stats": v["batch_stats"]},
                    jnp.asarray(draws["mixed"].numpy()), train=False)
                return jlosses.mixup_cross_entropy(
                    o["cls"], jnp.asarray(m["aux_ya"]),
                    jnp.asarray(m["aux_yb"]), m["aux_lam"],
                    cfg_j.DefRec_weight)

            with _jax_on_kinks(kinks):
                grads = jax.jit(jax.grad(loss))(v["params"])
        want_g = f.grads(grads)
        bad = {n: g for n, g in grad_gaps(_port_grads(model, want_g),
                                          want_g).items() if g > 1e-4}
        assert not bad, bad


class TestRecipes:
    def test_every_name_and_alias_builds_and_vit_is_queued(self):
        """Every name and alias builds; `vit` too (ported since: it builds
        and runs, and an unknown name raises ValueError)."""
        for name, cls in (("pointnet2_ssg", "PointNet2SSG"),
                          ("transformer", "PointTransformer"),
                          ("hengshuang_transformer", "HengshuangTransformer"),
                          ("HengShuang_Seg", "HengshuangSeg"),
                          ("ViT", "PointViT")):
            assert type(make_model(name, 10, device="cpu")).__name__ == cls
        vit = make_model("vit", 10, device="cpu", **PT_KW)
        with torch.no_grad():
            assert vit(torch.zeros(2, 64, 3))["cls"].shape == (2, 10)
        with pytest.raises(ValueError, match="unknown model"):
            make_model("vit_b16", 10, device="cpu")

    def test_model_kwargs_follow_the_jax_construction(self):
        cfg = PointDAConfig(knn_backend="torch", dropout=0.3)
        assert model_kwargs(cfg, "pointnet") == {"dropout": 0.3}
        assert model_kwargs(cfg, "transformer") == {"dropout": 0.3,
                                                    "knn_backend": "torch"}
        assert model_kwargs(cfg)["head_dtype"] == cfg.head_dtype

    def test_pointnet2_refuses_defrec_where_jax_fails_mid_step(self):
        """JAX's PointNet++ ignores `heads`, so its step raises a KeyError
        on the missing "defrec" output while tracing; the port refuses the
        recipe before the first step."""
        flags = dict(batch_size=2, num_points=512, dropout=0.0,
                     model="pointnet2", DefRec_on_trgt=True)
        cfg_j = JaxConfig(knn_backend="xla", **flags)
        v = variables("pointnet2", 0)
        x = jnp.asarray(clouds("pointnet2", 0)[:2])
        with pytest.raises(KeyError, match="defrec"):
            jsteps.pointda_train_step(_jax_state("pointnet2", v, cfg_j), x,
                                      jnp.zeros(2, jnp.int32), x,
                                      jax.random.key(0), cfg_j)
        with pytest.raises(ValueError, match="no DefRec head"):
            check_recipe(PointDAConfig(**flags))
        with pytest.raises(ValueError, match="unknown heads"):
            make_model("pointnet2", 10, device="cpu")(
                torch.zeros(1, 512, 3), heads=("defrec",))
