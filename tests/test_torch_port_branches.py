"""Every PointDA recipe branch of the port, its transforms, losses and
optimizers, held against the JAX package on the CPU.

The branches run in two JAX step compiles (one per group of branches that
can share a step): the JAX step runs with `debug_aux=True` and eval-mode
BN (`debug_bn_eval`), the port's `pointda_losses` takes its draws. The
deformations of the DefRec-only and Chamfer branches, which `debug_aux`
does not return, are re-derived from the step's key split with JAX's own
`deform_dispatch`, op by op. Each loss term is held within rtol 1e-4 and
every gradient within 1e-4 relative L2. The SPL gates are set halfway
across the widest gap between the batch's confidences, so no sample lies
within rounding of the gate.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_port_train_step as ts
from mlsp_tpu.losses import losses as jlosses
from mlsp_tpu.ops import chamfer as jchamfer
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.transforms import augment as jaug
from mlsp_tpu.transforms import extra as jextra
from mlsp_tpu.transforms import scan as jscan
from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
from mlsp_tpu_torch import losses as L
from mlsp_tpu_torch.ops import nearest_index_pair
from mlsp_tpu_torch.train import make_optimizer, pointda_losses
from mlsp_tpu_torch.train.state import (
    make_epoch_lr_optimizer,
    set_learning_rate,
    torch_cosine_lr,
)
from mlsp_tpu_torch.transforms import augment, extra, scan
from mlsp_tpu_torch.utils.config import PointDAConfig

B, N = 4, 128
KEY = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small CPU forwards here run several times
    faster than with a thread per core beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# Branch groups sharing one JAX step each. Group "ssl": every branch that
# can run beside the others, with the entropy-gated SPL; group "chamfer":
# the Chamfer-transported labels (an alternative to the input ones) with
# the max-prob SPL.
GROUPS = {
    "ssl": dict(DefRec_on_src=True, Density_normal_viainput_onsrc=True,
                Normal_ondef=True, Density_ondef=True, DefRec_on_trgt=True,
                Norm_on_trgt=True, Scan_on_trgt=True, Density_on_trgt=True,
                apply_SPL_v2=True),
    "chamfer": dict(Density_normal_viachamfer=True, Normal_ondef=True,
                    Density_ondef=True, apply_SPL=True),
}
# The loss terms each branch emits, and the group that runs it.
BRANCHES = {
    "DefRec_on_src": ("ssl", ["src_DefRec"]),
    "Density_normal_viainput_onsrc": (
        "ssl", ["src_def_normal", "src_def_density_cls",
                "src_def_density_mse"]),
    "DefRec_on_trgt": ("ssl", ["trgt_DefRec"]),
    "Norm_on_trgt": ("ssl", ["trgt_Normal"]),
    "Scan_on_trgt": ("ssl", ["trgt_Rec_scan"]),
    "Density_on_trgt": ("ssl", ["trgt_Density_cls", "trgt_Density_mse"]),
    "apply_SPL_v2": ("ssl", ["trgt_SPL", "trgt_SPL_selected"]),
    "Density_normal_viachamfer": (
        "chamfer", ["trgt_DefRec", "trgt_def_normal", "trgt_def_density_cls",
                    "trgt_def_density_mse"]),
    "apply_SPL": ("chamfer", ["trgt_SPL", "trgt_SPL_selected"]),
}


def _gate_between(values: np.ndarray) -> float:
    """A threshold halfway across the widest gap between the sorted values,
    asserted to lie well clear of each."""
    v = np.sort(values)
    i = int(np.argmax(np.diff(v)))
    assert v[i + 1] - v[i] > 1e-4, v
    return float((v[i] + v[i + 1]) / 2)


def _spl_gate(model, trgt: np.ndarray, v2: bool) -> float:
    """The SPL gate for the batch's target clouds: eval-mode BN, so the
    SPL forward's logits are the model's eval logits of the clouds."""
    with torch.no_grad():
        conf = torch.softmax(model.eval()(torch.tensor(trgt))["cls"],
                             -1).double()
    if v2:
        return _gate_between(
            -(conf * torch.log_softmax(conf, -1)).sum(-1).numpy())
    return _gate_between(conf.amax(-1).numpy())


def _run_group(name):
    v = ts._variables(2)
    rng = np.random.default_rng(3)
    src, trgt = ts._unit_clouds(rng, B, N), ts._unit_clouds(rng, B, N)
    src_y = rng.integers(0, 10, B)
    flags = dict(GROUPS[name], apply_PCM=False)
    jcfg = dataclasses.replace(
        JaxConfig(batch_size=B, num_points=N, dropout=0.0, knn_backend="xla",
                  edge_impl="moments", head_dtype="f32").resolved(),
        debug_aux=True, debug_bn_eval=True, **flags)
    keys = jax.random.split(jax.random.key(KEY), 17)
    # the step's augmented target, to place the SPL gate
    trgt_aug = np.asarray(jsteps.augment_batch(keys[1], jnp.asarray(trgt)))
    gate = _spl_gate(ts._port(v), trgt_aug, flags.get("apply_SPL_v2", False))
    gate_kw = ({"gamma_v2": gate} if flags.get("apply_SPL_v2")
               else {"gamma": gate})
    jcfg = dataclasses.replace(jcfg, **gate_kw)
    cfg = dataclasses.replace(
        PointDAConfig(batch_size=B, num_points=N, dropout=0.0,
                      head_dtype="f32").resolved(),
        debug_bn_eval=True, **flags, **gate_kw)

    jm = ts._jax_model()
    state = jstate.TrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=jstate.make_optimizer("ADAM", cfg.lr, cfg.wd, 0.9, cfg.epochs, 10))
    _, m = jsteps.pointda_train_step(state, jnp.asarray(src),
                                     jnp.asarray(src_y), jnp.asarray(trgt),
                                     jax.random.key(KEY), jcfg)
    aux = {k: np.array(a) for k, a in m.items()
           if k.startswith("aux_") and k != "aux_grads"}
    np.testing.assert_allclose(aux["aux_trgt"], trgt_aug, rtol=0, atol=1e-6)

    def deformed(key_index, x):
        dx, mask = jsteps.deform_dispatch(keys[key_index], jnp.asarray(x),
                                          jcfg)
        return torch.from_numpy(np.array(dx)), torch.from_numpy(
            np.array(mask))

    t = {k: torch.from_numpy(a) for k, a in aux.items()}
    draws = {}
    if cfg.DefRec_on_src:
        draws["src_dx"], draws["src_dmask"] = deformed(2, aux["aux_src"])
    if cfg.Density_normal_viainput_onsrc:
        draws["src_dx_via"], draws["src_dmask_via"] = deformed(
            6, aux["aux_src"])
    if cfg.DefRec_on_trgt:
        draws["trgt_dx"], draws["trgt_dmask"] = deformed(8, aux["aux_trgt"])
    if cfg.Scan_on_trgt:
        draws["sx"], draws["smask"] = t["aux_sx"], t["aux_smask"]
        assert float(t["aux_smask"].mean()) > 0.1  # a real occlusion
    if cfg.Density_normal_viachamfer:
        draws["dx"], draws["dmask"] = deformed(14, aux["aux_trgt"])

    model = ts._port(v)
    total, got = pointda_losses(
        model, cfg, {"src_x": t["aux_src"], "src_y": torch.from_numpy(src_y),
                     "trgt_x": t["aux_trgt"]}, draws, None)
    total.backward()
    return model, got, m


@pytest.fixture(scope="module")
def groups():
    return {name: _run_group(name) for name in GROUPS}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_terms_match_jax(groups, branch):
    """Each branch's loss terms within rtol 1e-4 of the JAX step's, at
    B=4, N=128, k=20, eval-mode BN, on the JAX step's own draws."""
    group, terms = BRANCHES[branch]
    _, got, m = groups[group]
    for name in terms:
        want = float(m[name])
        assert got[name].item() == pytest.approx(want, rel=1e-4), name
    if branch.startswith("apply_SPL"):
        # the gate keeps some samples and drops others
        assert 0.0 < float(m["trgt_SPL_selected"]) < 1.0


@pytest.mark.parametrize("group", list(GROUPS))
def test_group_terms_and_grads_match_jax(groups, group):
    """The group's whole set of terms (none missing, none extra) and every
    gradient within 1e-4 relative L2 of the JAX step's."""
    model, got, m = groups[group]
    assert set(got) == {k for k in m if not k.startswith("aux_")}
    assert got["total"].item() == pytest.approx(float(m["total"]), rel=1e-4)
    ts._assert_grads(model, m["aux_grads"], 1e-4)


class TestScan:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_scan_batch_matches_jax(self, seed):
        """The port's scan on JAX's own pixel size and rotation matrices
        equals JAX's `scan_batch` exactly, exact-zero clouds included."""
        rng = np.random.default_rng(seed)
        x = ts._unit_clouds(rng, 3, 256)
        x[1, :40] = x[1, 0]  # repeated points: ties in depth and cell
        key = jax.random.key(seed)
        want_scan, want_mask = jscan.scan_batch(key, jnp.asarray(x))
        kpix, krot = jax.random.split(key)
        pixel = jax.random.uniform(kpix, (), jnp.float32, jscan._PIX_MIN,
                                   jscan._PIX_MAX)
        ang = jax.random.uniform(krot, (3, 3), jnp.float32, 0.0, 2 * jnp.pi)
        c, s = jnp.cos(ang), jnp.sin(ang)
        R = (jaug._axis_rotation("y", c[..., 0], s[..., 0])
             @ jaug._axis_rotation("x", c[..., 1], s[..., 1])
             @ jaug._axis_rotation("z", c[..., 2], s[..., 2]))
        got_scan, got_mask = scan.scan_batch(
            torch.from_numpy(x), torch.tensor(np.asarray(pixel)),
            torch.from_numpy(np.array(R)))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(got_scan.numpy(), np.asarray(want_scan))
        assert 0.05 < float(got_mask.mean()) < 0.95

    def test_draw_scan(self):
        g = torch.Generator().manual_seed(0)
        pixel, R = scan.draw_scan(g, 5)
        assert scan._PIX_MIN <= float(pixel) < scan._PIX_MAX
        eye = torch.eye(3).expand(5, 3, 3)
        torch.testing.assert_close(R @ R.transpose(1, 2), eye, atol=1e-6,
                                   rtol=0)

    def test_scan_rec_loss_matches_jax(self):
        rng = np.random.default_rng(7)
        p, g = (rng.standard_normal((2, 64, 3)).astype(np.float32)
                for _ in range(2))
        mask = (rng.uniform(size=(2, 64)) < 0.3).astype(np.float32)
        got = L.scan_rec_loss(torch.from_numpy(p), torch.from_numpy(g),
                              torch.from_numpy(mask), 0.5)
        want = jlosses.scan_rec_loss(jnp.asarray(p), jnp.asarray(g),
                                     jnp.asarray(mask), 0.5)
        assert got.item() == pytest.approx(float(want), rel=1e-5)


class TestChamferTransport:
    def test_nearest_index_pair_matches_jax_with_ties(self):
        """Both index maps equal `jnp.argmin`'s, exact ties (a repeated gold
        point, a prediction equidistant from two) going to the lowest
        index."""
        rng = np.random.default_rng(3)
        pred = rng.standard_normal((2, 64, 3)).astype(np.float32)
        gold = rng.standard_normal((2, 64, 3)).astype(np.float32)
        gold[0, 10] = gold[0, 30] = gold[0, 50]
        pred[0, 5] = gold[0, 50]
        gold[1, 7], gold[1, 9] = [10.0, 1.0, 0.0], [10.0, -1.0, 0.0]
        pred[1, 3] = [10.0, 0.0, 0.0]
        mask = (rng.uniform(size=(2, 64)) < 0.5).astype(np.float32)
        mask[0, [10, 30, 50]] = 1.0
        mask[1, [7, 9]] = 1.0
        got = nearest_index_pair(*map(torch.from_numpy, (pred, gold, mask)))
        want = jchamfer.nearest_index_pair(*map(jnp.asarray,
                                                (pred, gold, mask)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(got[0][0, 5]) == 10 and int(got[0][1, 3]) == 7

    def test_transported_losses_match_jax(self):
        rng = np.random.default_rng(4)
        Bn, Nn, C = 3, 48, 16
        arrs = {
            "normal_pred": rng.standard_normal((Bn, Nn, 3)),
            "normal_labels": rng.standard_normal((Bn, Nn, 3)),
            "p_vec": rng.dirichlet(np.ones(C), (Bn, Nn)),
            "p_val": rng.uniform(size=(Bn, Nn)),
            "target_vec": rng.dirichlet(np.ones(C), (Bn, Nn)),
            "target_val": rng.uniform(size=(Bn, Nn)),
            "weights": rng.uniform(0.0, 27.0, (Bn, Nn)),
        }
        arrs = {k: a.astype(np.float32) for k, a in arrs.items()}
        idx = tuple(rng.integers(0, Nn, (Bn, Nn)) for _ in range(2))
        t = {k: torch.from_numpy(a) for k, a in arrs.items()}
        j = {k: jnp.asarray(a) for k, a in arrs.items()}
        tidx = tuple(torch.from_numpy(i) for i in idx)
        jidx = tuple(jnp.asarray(i, jnp.int32) for i in idx)
        got = L.transported_normal_loss(t["normal_pred"], t["normal_labels"],
                                        t["weights"], tidx, 0.5)
        want = jlosses.transported_normal_loss(
            j["normal_pred"], j["normal_labels"], j["weights"], jidx, 0.5)
        assert got.item() == pytest.approx(float(want), rel=1e-5)
        got = L.transported_density_loss(t["p_vec"], t["p_val"],
                                         t["target_vec"], t["target_val"],
                                         t["weights"], tidx, 0.05)
        want = jlosses.transported_density_loss(
            j["p_vec"], j["p_val"], j["target_vec"], j["target_val"],
            j["weights"], jidx, 0.05)
        for a, b in zip(got, want):
            assert a.item() == pytest.approx(float(b), rel=1e-5)


def _clouds(seed, shape=(3, 50)):
    return (np.random.default_rng(seed).standard_normal((*shape, 3))
            .astype(np.float32))


class TestExtraTransforms:
    """`transforms/extra.py` and the augment helpers against JAX, the
    random ones applied to JAX's own draws."""

    def test_normalize_pc(self):
        x = _clouds(0)
        np.testing.assert_allclose(
            extra.normalize_pc(torch.from_numpy(x)).numpy(),
            np.asarray(jextra.normalize_pc(jnp.asarray(x))), rtol=1e-6,
            atol=1e-6)

    def test_scale(self):
        x, key = _clouds(1), jax.random.key(1)
        s = jax.random.uniform(key, (3, 1, 1), jnp.float32, 2 / 3, 3 / 2)
        got = extra.scale(torch.from_numpy(x), torch.from_numpy(np.asarray(s)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jextra.scale(key, jnp.asarray(x))))
        f = extra.draw_scale(torch.Generator().manual_seed(0), (3,))
        assert f.shape == (3, 1, 1) and bool(((f >= 2 / 3) & (f < 1.5)).all())

    def test_rotate_perturbation(self):
        x, key = _clouds(2), jax.random.key(2)
        ang = jnp.clip(0.06 * jax.random.normal(key, (3, 3)), -0.18, 0.18)
        got = extra.rotate_perturbation(torch.from_numpy(x),
                                        torch.from_numpy(np.asarray(ang)))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jextra.rotate_perturbation(
                key, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
        a = extra.draw_rotate_perturbation(torch.Generator().manual_seed(0),
                                           (3,))
        assert a.shape == (3, 3) and float(a.abs().max()) <= 0.18

    def test_drop_hole(self):
        x, key = _clouds(3), jax.random.key(3)
        center = jax.random.randint(key, (3,), 0, 50)
        _, got = extra.drop_hole(torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(center)).long())
        _, want = jextra.drop_hole(key, jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.sum(-1).tolist() == [38.0, 38.0, 38.0]

    def test_viewpoint_dropout(self):
        x, key = _clouds(4), jax.random.key(4)
        u = jax.random.uniform(jax.random.split(key)[1], (3, 50))
        _, got = extra.viewpoint_dropout(torch.from_numpy(x),
                                         torch.from_numpy(np.asarray(u)))
        _, want = jextra.viewpoint_dropout(key, jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_draw_from_uniform(self):
        key, gap, mean = jax.random.key(5), [0.1, 0.2, 0.3], [0.5, -0.5, 0.0]
        u = jax.random.uniform(key, (40, 3))
        got = extra.uniform_in_box(torch.from_numpy(np.asarray(u)), gap, mean)
        want = jextra.draw_from_uniform(key, gap, mean, 40)
        # within an ulp: XLA fuses the scale and shift into one rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=6e-8)
        pts = extra.draw_from_uniform(torch.Generator().manual_seed(0), gap,
                                      mean, 40)
        assert pts.shape == (40, 3)

    def test_scale_to_unit_cube_and_rotate_shape(self):
        x = _clouds(6)
        np.testing.assert_allclose(
            augment.scale_to_unit_cube(torch.from_numpy(x)).numpy(),
            np.asarray(jaug.scale_to_unit_cube(jnp.asarray(x))), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(
            augment.rotate_shape(torch.from_numpy(x), "x", -np.pi / 2).numpy(),
            np.asarray(jaug.rotate_shape(jnp.asarray(x), "x", -np.pi / 2)),
            rtol=1e-6, atol=1e-6)

    def test_translate_and_rotation_3d(self):
        x, key = _clouds(7), jax.random.key(7)
        k1, k2 = jax.random.split(key)
        s = jax.random.uniform(k1, (3, 1, 3), jnp.float32, 2 / 3, 3 / 2)
        t = jax.random.uniform(k2, (3, 1, 3), jnp.float32, -0.2, 0.2)
        got = augment.translate(torch.from_numpy(x),
                                torch.from_numpy(np.asarray(s)),
                                torch.from_numpy(np.asarray(t)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jaug.translate(key, jnp.asarray(x))))
        ang = jax.random.uniform(key, (3, 3), jnp.float32, 0.0, 2 * jnp.pi)
        got = augment.rotate(torch.from_numpy(x), augment.rotation_3d(
            torch.from_numpy(np.asarray(ang))))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jaug.random_rotate_3d(key,
                                                          jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# optimizers and schedules against optax


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "frozen": rng.standard_normal((2, 2)).astype(np.float32)}


def _grads(p0, n, seed):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(a.shape).astype(np.float32)
             for k, a in p0.items()} for _ in range(n)]


def _module(p0):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
         for k, a in p0.items()})


def _torch_step(opt, module, g):
    """One update with `frozen` at grad None (no loss reads it)."""
    opt.zero_grad(set_to_none=True)
    for k in ("w", "b"):
        module[k].grad = torch.from_numpy(g[k])
    opt.step()


def _jax_grads(g):
    jg = {k: jnp.asarray(a) for k, a in g.items()}
    jg["frozen"] = jnp.zeros_like(jg["frozen"])
    return jg


def _assert_params(module, params, p0):
    for k in ("w", "b"):
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(module["frozen"].detach().numpy(),
                                  p0["frozen"])


@pytest.mark.parametrize("name,scheduler", [("SGD", "cos"), ("ADAMW", "cos"),
                                            ("ADAM", "step"), ("SGD", "step")])
def test_optimizer_matches_optax(name, scheduler):
    """SGD (coupled L2, momentum trace), AdamW (decoupled decay of the
    ndim > 1 parameters only) and the StepLR schedule against the JAX
    package's optax chains on the same gradients, over epoch boundaries; a
    parameter at grad None stays frozen, momentum and decay included, as
    the decay mask freezes it in JAX."""
    p0 = _params(5)
    lr, wd, epochs, spe = 1e-3, 5e-2, 4, 2
    kw = dict(scheduler=scheduler, decay_epochs=1, decay_rate=0.5)
    tx = jstate.make_optimizer(
        name, lr, wd, 0.9, epochs, spe,
        decay_mask=jstate.untrained_decay_mask({"frozen"}), **kw)
    params = {k: jnp.asarray(a) for k, a in p0.items()}
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    module = _module(p0)
    opt, sched = make_optimizer(module, lr, wd, epochs, spe, name, 0.9, **kw)
    for g in _grads(p0, 7, 6):
        upd, opt_state = update(_jax_grads(g), opt_state, params)
        params = optax.apply_updates(params, upd)
        _torch_step(opt, module, g)
        sched.step()
        _assert_params(module, params, p0)
    if name == "ADAMW":  # the 1-d parameter gets no decoupled decay
        groups = {len(gr["params"]): gr["weight_decay"]
                  for gr in opt.param_groups}
        assert groups == {2: wd, 1: 0.0}
    want = (jstate.step_schedule(lr, 1, 0.5, spe) if scheduler == "step"
            else jstate.cosine_per_epoch(lr, epochs, spe))(7)
    assert [gr["lr"] for gr in opt.param_groups] == pytest.approx(
        [float(want)] * len(opt.param_groups), rel=1e-6)


@pytest.mark.parametrize("name", ["ADAM", "SGD"])
def test_epoch_lr_optimizer_matches_optax_across_rounds(name):
    """SPST's optimizer: the LR set once per epoch from `torch_cosine_lr`
    at the global epoch, over 2 rounds of 2 epochs. The LR is not clamped:
    it falls to 0 at the end of round 1 and rises again in round 2, as
    torch's `CosineAnnealingLR` stepped past T_max does."""
    p0 = _params(8)
    lr, wd, epochs, rounds = 1e-3, 5e-3, 2, 2
    tx = jstate.make_epoch_lr_optimizer(
        name, lr, wd, 0.9, decay_mask=jstate.untrained_decay_mask({"frozen"}))
    state = jstate.TrainState.create(
        apply_fn=None, params={k: jnp.asarray(a) for k, a in p0.items()},
        tx=tx)
    module = _module(p0)
    opt = make_epoch_lr_optimizer(module, name, lr, wd, 0.9)
    ref = torch.optim.lr_scheduler.CosineAnnealingLR(
        torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=lr),
        T_max=epochs)
    grads = iter(_grads(p0, epochs * rounds * 2, 9))
    lrs = []
    for e in range(epochs * rounds):
        lr_e = torch_cosine_lr(lr, epochs, e)
        assert lr_e == jstate.torch_cosine_lr(lr, epochs, e)
        assert lr_e == pytest.approx(ref.get_last_lr()[0], rel=1e-9,
                                     abs=1e-12)
        ref.optimizer.step()
        ref.step()
        lrs.append(lr_e)
        state = jstate.set_learning_rate(state, lr_e)
        set_learning_rate(opt, lr_e)
        for _ in range(2):
            g = next(grads)
            state = state.apply_gradients(grads=_jax_grads(g))
            _torch_step(opt, module, g)
            _assert_params(module, state.params, p0)
    assert lrs == pytest.approx([lr, lr / 2, 0.0, lr / 2], abs=1e-12)
    assert all(gr["lr"] == lrs[-1] for gr in opt.param_groups)
    assert math.isclose(lrs[3], lrs[1])  # round 2 rises again
