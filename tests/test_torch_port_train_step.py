"""The port's train-mode DGCNN, paper-recipe step and optimizer held against
the JAX package on the CPU.

Weights go across with `dgcnn_state_dict_from_jax`, gradients come back
with `dgcnn_grads_from_jax`. The JAX step runs with `debug_aux=True`, so
the port's `pointda_losses` consumes exactly the JAX step's augmented,
mixed and deformed clouds, and JAX may run on the port's kNN graphs
(`_jax_on_graphs`), so that only rounding separates the two. Dropout is 0
on both sides (the one random stream that cannot be shared), heads in
float32.
"""

import contextlib
import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.models import DGCNN as JaxDGCNN
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils.config import PointDAConfig as JaxConfig
from mlsp_tpu.utils.torch_export import export_dgcnn
from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data.synthetic import make_classification
from mlsp_tpu_torch.ops import density_labels, estimate_normals, kernels
from mlsp_tpu_torch.train import (
    make_optimizer,
    pointda_losses,
    pointda_train_step,
)
from mlsp_tpu_torch.testing import Tape, grad_gaps
from mlsp_tpu_torch.utils.config import PointDAConfig
from mlsp_tpu_torch.utils.jax_weights import (
    dgcnn_grads_from_jax,
    dgcnn_state_dict_from_jax,
)

HEADS = ("defrec", "normal", "scan", "density")
_jdgcnn = importlib.import_module("mlsp_tpu.models.dgcnn")
_jnormals = importlib.import_module("mlsp_tpu.ops.normals")


def _jax_model():
    return JaxDGCNN(num_classes=10, k=20, dropout=0.0, edge_impl="moments",
                    knn_backend="xla")


@jax.jit
def _init(key):
    return _jax_model().init({"params": key}, jnp.zeros((1, 64, 3)),
                             train=False, heads=HEADS)


def _variables(seed):
    """Initialised variables with randomised BatchNorm: gamma of both signs
    (a negative gamma turns EdgeConvM's max into a min), beta, and running
    statistics."""
    v = _init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def param(path, a):
        if path[-1].key == "scale":
            sign = rng.choice([-1.0, 1.0], a.shape)
            return (sign * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a, np.float32)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v["batch_stats"])}


def _port(variables):
    model = make_model("dgcnn", 10, device="cpu", k=20, dropout=0.0)
    model.load_state_dict(dgcnn_state_dict_from_jax(variables), strict=True)
    return model


def _unit_clouds(rng, B, N):
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x -= x.mean(1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(-1)[:, None, None]


@contextlib.contextmanager
def _jax_on_graphs(graphs):
    """JAX's kNN graphs, the DGCNN's and the normals', replaced in call
    order by `graphs` (the port's, recorded by `testing.Tape`) while the
    block traces."""
    it = iter(graphs)

    def knn(x, k, *args, **kwargs):
        g = next(it)
        assert tuple(g.shape) == (*x.shape[:2], k)
        return jnp.asarray(g.numpy().astype(np.int32))

    with mock.patch.object(_jdgcnn, "knn_indices", knn), \
            mock.patch.object(_jnormals, "knn_indices", knn):
        yield
    assert next(it, None) is None


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_grads(model, jax_grads, bound, floor_grads=None, names=None):
    """Every trainable parameter's gradient within `bound` of the JAX
    gradient, plus, with `floor_grads`, 3 times the JAX gradient's own
    change under a 1e-6 input perturbation (its chaos floor: train-mode BN
    amplifies float32 rounding, and near-tie kNN or Chamfer choices flip).
    Gaps are `testing.grad_gaps`: relative L2 with the gradients' RMS as the
    floor of the scale, since a bias ahead of a train-mode BN has an exact
    gradient of 0 and its computed one is rounding alone. A parameter
    without a gradient (no loss reaches it) has an all-zero JAX gradient.
    With `names`, only those parameters' gradients are held."""
    want = dgcnn_grads_from_jax(jax_grads)
    named = dict(model.named_parameters())
    assert set(want) == {n for n, p in named.items() if p.requires_grad}
    got = {}
    for name, w in want.items():
        if named[name].grad is None:
            np.testing.assert_array_equal(w.numpy(), 0.0, err_msg=name)
        else:
            got[name] = named[name].grad
    want = {n: want[n] for n in got}
    gaps = grad_gaps(got, want)
    floor = (grad_gaps({n: t for n, t in dgcnn_grads_from_jax(
        floor_grads).items() if n in got}, want)
             if floor_grads is not None else dict.fromkeys(got, 0.0))
    for name in names or gaps:
        assert gaps[name] <= bound + 3.0 * floor[name], (
            name, gaps[name], floor[name])


def _assert_batch_stats(model, batch_stats, params, floor_stats=None):
    """Running statistics within rtol 1e-4, atol 1e-5; with `floor_stats`
    (the JAX statistics after a 1e-6 input perturbation) each tensor within
    1e-4 plus 3 times that floor in relative L2, as the gradients."""
    def stats(bstats):
        sd = dgcnn_state_dict_from_jax({"params": params,
                                        "batch_stats": bstats})
        return {k: t for k, t in sd.items()
                if k.endswith(("running_mean", "running_var"))}

    got = model.state_dict()
    want = stats(batch_stats)
    floor = stats(floor_stats) if floor_stats is not None else None
    for name, w in want.items():
        if floor is None:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            tol = 1e-4 + 3.0 * _rel_l2(floor[name].numpy(), w.numpy())
            gap = _rel_l2(got[name].numpy(), w.numpy())
            assert gap <= tol, (name, gap, tol)


# The layers whose gradient no kink separates from the loss: their inputs
# are continuous in the cloud (given the kNN graphs) and the loss is linear
# in their outputs.
OUTPUT_LAYERS = ("C.mlp3.weight", "C.mlp3.bias", "DefRec.conv4.weight",
                 "Norm_pred.conv4.weight", "Rec_scan.conv4.weight",
                 "Density_cls.mlp3.weight", "Density_cls.mlp3.bias")


def _dgcnn_case(input_seed, shared_graphs, grads_of=None):
    """B=4, N=128, k=20, train-mode BN, randomised BN, dropout 0: the
    port's outputs at rtol = 1e-4 and atol = 1e-4, the gradients of the
    parameters named in `grads_of` (all with None) within 1e-4
    (`_assert_grads`), each plus 3 times JAX's own change under a 1e-6
    input shift (over a batch of 4 the transform net's train-mode BN
    amplifies float32 rounding about a hundredfold), and the updated
    running statistics. With `shared_graphs` JAX runs on the port's kNN
    graphs, shifted input included, so no kNN near tie flips."""
    jm = _jax_model()
    v = _variables(0)
    rng = np.random.default_rng(input_seed)
    x = rng.standard_normal((4, 128, 3)).astype(np.float32)
    names = ("cls", "feat", "defrec", "normal", "scan", "density",
             "density_mse")
    w = {n: rng.standard_normal(s).astype(np.float32) for n, s in (
        ("cls", (4, 10)), ("feat", (4, 1024)), ("defrec", (4, 128, 3)),
        ("normal", (4, 128, 3)), ("scan", (4, 128, 3)),
        ("density", (4, 128, 16)), ("density_mse", (4, 128)))}

    model = _port(v).train()
    tape = Tape()
    with tape.record():
        out = model(torch.from_numpy(x), heads=HEADS)
    sum((torch.from_numpy(w[n]) * out[n]).sum() for n in names).backward()

    @jax.jit
    def grad_fn(params, xx):
        def loss(p):
            o, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                              xx, train=True, heads=HEADS,
                              mutable=["batch_stats"])
            return sum((w[n] * o[n]).sum() for n in names), (o, mut)

        return jax.value_and_grad(loss, has_aux=True)(params)

    with (_jax_on_graphs(tape.graphs) if shared_graphs
          else contextlib.nullcontext()):
        (_, (want, mut)), grads = grad_fn(v["params"], jnp.asarray(x))
        (_, (shifted, _)), floor = grad_fn(v["params"], jnp.asarray(x + 1e-6))

    for n in names:
        w = np.asarray(want[n])
        floor_n = np.abs(np.asarray(shifted[n]) - w).max()
        np.testing.assert_allclose(out[n].detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 + 3.0 * floor_n, err_msg=n)
    _assert_grads(model, grads, 1e-4, floor, grads_of)
    _assert_batch_stats(model, mut["batch_stats"], v["params"])
    assert int(model.conv1.conv[1].num_batches_tracked) == 1


class TestTrainModeDGCNN:
    def test_forward_grads_and_stats_match_jax(self):
        """Each side on its own kNN graphs, every gradient. The input has
        no near tie that the two packages' float32 rounding flips: no kNN
        tie (a flip at a deeper graph changes a point's features
        outright, and train-mode BN carries it to every point), and no
        max-pool or ReLU kink (a flip there moves one element's share of
        a gradient, a percent of a small tensor's norm). Seeds 1, 2 and 6
        have such a flip; the next test covers typical inputs."""
        _dgcnn_case(4, shared_graphs=False)

    @pytest.mark.parametrize("input_seed", [1, 2, 3])
    def test_forward_output_grads_and_stats_match_jax_on_shared_graphs(
            self, input_seed):
        """Typical inputs, JAX on the port's kNN graphs: every output and
        running statistic, which are continuous in the cloud once the
        graphs are fixed, and the gradients of the output layers
        (`OUTPUT_LAYERS`). The other gradients pass max-pool and ReLU
        kinks, which rounding flips on most inputs (see above)."""
        _dgcnn_case(input_seed, shared_graphs=True, grads_of=OUTPUT_LAYERS)

    def test_dropout_needs_a_generator(self):
        model = make_model("dgcnn", 10, device="cpu").train()
        x = torch.randn(2, 32, 3)
        with pytest.raises(ValueError, match="Generator"):
            model(x)
        g = torch.Generator().manual_seed(0)
        a = model(x, generator=g)["cls"]
        b = model(x, generator=torch.Generator().manual_seed(0))["cls"]
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestStep:
    B, N = 4, 256

    @pytest.mark.parametrize("bn_eval", [False, True])
    def test_losses_and_grads_match_jax(self, bn_eval):
        """One paper-recipe iteration at B=4, N=256, k=20, fed the JAX step's
        own draws. With eval-mode BN (`debug_bn_eval`): every loss term
        within rtol 1e-4, every gradient within 1e-4 relative L2. With
        train-mode BN the JAX step is chaotic: its own loss terms and
        gradients move by up to several percent when its inputs move by
        1e-6 (train-mode BN over B=4 amplifies float32 rounding, and the
        deformed blob's near-tie kNN and Chamfer choices flip). There the
        port must stay within 1e-4 plus 3 times that floor, term by term
        and tensor by tensor."""
        B, N = self.B, self.N
        cfg_j = dataclasses.replace(
            JaxConfig(batch_size=B, num_points=N, dropout=0.0,
                      knn_backend="xla", edge_impl="moments",
                      head_dtype="f32").paper_recipe,
            debug_aux=True, debug_bn_eval=bn_eval)
        cfg = dataclasses.replace(
            PointDAConfig(batch_size=B, num_points=N, dropout=0.0,
                          head_dtype="f32").paper_recipe,
            debug_bn_eval=bn_eval)
        jm = _jax_model()
        v = _variables(2)
        # create_train_state's state, built without its second init
        state = jstate.TrainState.create(
            apply_fn=jm.apply, params=v["params"],
            batch_stats=v["batch_stats"], tx=jstate.make_optimizer(
                "ADAM", cfg.lr, cfg.wd, 0.9, cfg.epochs, 10,
                decay_mask=jstate.untrained_decay_mask({"RecScan"})))
        rng = np.random.default_rng(3)
        src, trgt = _unit_clouds(rng, B, N), _unit_clouds(rng, B, N)
        src_y = rng.integers(0, 10, B)

        def jax_step(delta):
            return jsteps.pointda_train_step(
                state, jnp.asarray(src + delta), jnp.asarray(src_y),
                jnp.asarray(trgt + delta), jax.random.key(4), cfg_j)

        new_state, m = jax_step(0.0)
        floor_state, floor = jax_step(1e-6) if not bn_eval else (None, None)
        aux = {k: torch.from_numpy(np.array(a)) for k, a in m.items()
               if k.startswith("aux_") and k != "aux_grads"}
        assert float(aux["aux_dmask"].sum(-1).min()) >= 40  # a region each

        # the labels the port computes from the same target clouds
        cos = (estimate_normals(aux["aux_trgt"], cfg.near)
               * aux["aux_ngt"]).sum(-1).abs()
        assert float(torch.quantile(cos.flatten(), 0.01)) > 0.999
        dvec, dval = density_labels(aux["aux_trgt"], cfg.radius, 16, 2.0)
        assert torch.equal(dval, aux["aux_dval"])
        assert torch.equal(dvec, aux["aux_dvec"])

        model = _port(v)
        total, got = pointda_losses(
            model, cfg,
            {"src_x": aux["aux_src"], "src_y": torch.from_numpy(src_y),
             "trgt_x": aux["aux_trgt"]},
            {"mixed": aux["aux_mixed"], "ya": aux["aux_ya"].long(),
             "yb": aux["aux_yb"].long(), "lam": aux["aux_lam"],
             "dx": aux["aux_dx"], "dmask": aux["aux_dmask"]}, None)
        total.backward()
        assert set(got) == {k for k in m if not k.startswith("aux_")}
        for name, t in got.items():
            want = float(m[name])
            tol = 1e-4
            if floor is not None:
                tol += 3.0 * abs(float(floor[name]) / want - 1.0)
            assert abs(t.item() / want - 1.0) <= tol, (name, t.item(), want)
        _assert_grads(model, m["aux_grads"], 1e-4,
                      None if bn_eval else floor["aux_grads"])
        if bn_eval:  # eval-mode BN leaves the statistics alone
            assert all(torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), _port(v).state_dict().values()))
        else:
            _assert_batch_stats(model, new_state.batch_stats, v["params"],
                                floor_state.batch_stats)


class TestOptimizer:
    def test_adam_and_schedule_match_optax(self):
        """torch Adam with coupled L2 + the per-epoch cosine LambdaLR against
        the JAX package's optax chain, on the same gradients, over an epoch
        boundary; a parameter left at grad None is frozen, as the decay mask
        freezes it in JAX."""
        rng = np.random.default_rng(5)
        p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "frozen": rng.standard_normal(2).astype(np.float32)}
        grads = [{k: rng.standard_normal(a.shape).astype(np.float32)
                  for k, a in p0.items()} for _ in range(5)]
        lr, wd, epochs, spe = 1e-3, 5e-5, 3, 2

        tx = jstate.make_optimizer(
            "ADAM", lr, wd, 0.9, epochs, spe,
            decay_mask=jstate.untrained_decay_mask({"frozen"}))
        params = {k: jnp.asarray(a) for k, a in p0.items()}
        opt_state = tx.init(params)
        update = jax.jit(tx.update)

        module = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
             for k, a in p0.items()})
        opt, sched = make_optimizer(module, lr, wd, epochs, spe)
        for g in grads:
            jg = {k: jnp.asarray(a) for k, a in g.items()}
            jg["frozen"] = jnp.zeros_like(jg["frozen"])
            upd, opt_state = update(jg, opt_state, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
            opt.zero_grad(set_to_none=True)
            for k in ("a", "b"):
                module[k].grad = torch.from_numpy(g[k])
            opt.step()
            sched.step()
            for k in p0:
                np.testing.assert_allclose(module[k].detach().numpy(),
                                           np.asarray(params[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(module["frozen"].detach().numpy(),
                                      p0["frozen"])
        sched_j = jstate.cosine_per_epoch(lr, epochs, spe)
        assert [g["lr"] for g in opt.param_groups] == pytest.approx(
            [float(sched_j(len(grads)))], rel=1e-6)


class TestPortStep:
    def test_runs_on_the_cpu_with_plain_versions(self):
        """The whole step on CPU tensors: finite losses, no kernel launch,
        the scan head untouched (no loss reads it), BN statistics moved."""
        cfg = PointDAConfig(batch_size=2, num_points=128).paper_recipe
        g = torch.Generator().manual_seed(0)
        model = make_model("dgcnn", 10, device="cpu", generator=g,
                           head_dtype="bf16")
        before = {k: t.clone() for k, t in model.state_dict().items()}
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10)
        x, y = make_classification(4, 128, 10, seed=1)
        kernels.reset_launches()
        m = pointda_train_step(model, opt, sched, torch.from_numpy(x[:2]),
                               torch.from_numpy(y[:2]), torch.from_numpy(x[2:]),
                               g, cfg)
        assert all(n == 0 for n in kernels.launches().values())
        assert set(m) == {"src_mixup", "trgt_DefRec", "trgt_def_normal",
                          "trgt_def_density_cls", "trgt_def_density_mse",
                          "total"}
        assert all(torch.isfinite(t) for t in m.values())
        after = model.state_dict()
        for k in before:
            same = torch.equal(before[k], after[k])
            if k.startswith("Rec_scan.") and "running" not in k:
                assert same, k
        assert not torch.equal(before["conv1.conv.0.weight"],
                               after["conv1.conv.0.weight"])
        assert not torch.equal(before["conv4.conv.1.running_var"],
                               after["conv4.conv.1.running_var"])

    @pytest.mark.parametrize("flag", [
        "DefRec_on_src", "DefRec_on_trgt", "Norm_on_trgt", "Scan_on_trgt",
        "Density_on_trgt", "Density_normal_viachamfer", "apply_SPL",
        "apply_SPL_v2"])
    def test_unported_branches_raise(self, flag):
        cfg = dataclasses.replace(PointDAConfig().paper_recipe, **{flag: True})
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pointda_losses(None, cfg, {}, {}, None)

    def test_generator_on_another_device_raises(self):
        cfg = PointDAConfig().paper_recipe
        x = torch.zeros(2, 64, 3, device="meta")
        with pytest.raises(ValueError, match="generator"):
            pointda_train_step(None, None, None, x, None, x,
                               torch.Generator(), cfg)

    def test_weights_round_trip_through_export(self):
        """The gradient mapping is the weight mapping: a params tree maps to
        the port's parameters as `export_dgcnn` maps it."""
        v = _variables(6)
        got = dgcnn_grads_from_jax(v["params"])
        want = export_dgcnn(v)
        for name, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
