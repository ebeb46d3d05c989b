"""The port's PointSegDA train step held against the JAX package's
`_seg_step_inner` on the CPU, branch by branch, and run on the CPU with
the port's own draws.

Weights, inputs and helpers as in `test_torch_port_seg.py`: the port is
fed the JAX step's own draws and replays its kNN graphs
(`testing.Tape`), dropout is 0 on both sides.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_seg import (
    _assert_seg_grads,
    _jax_model,
    _jdseg,
    _jnormals,
    _port,
    _t,
    _unit_clouds,
    seg_variables,  # noqa: F401 (a fixture)
)

from mlsp_tpu.train import seg_steps as jseg
from mlsp_tpu.train import state as jstate
from mlsp_tpu.train import steps as jsteps
from mlsp_tpu.utils import config as jconfig
from mlsp_tpu_torch import make_model
from mlsp_tpu_torch.data import synthetic
from mlsp_tpu_torch.testing import Tape
from mlsp_tpu_torch.train import make_optimizer, seg_steps
from mlsp_tpu_torch.utils import config
from mlsp_tpu_torch.utils.config import PointSegDAConfig


# The seg step's branches: the MLSP recipe with PCM, DefRec_on_trgt alone
# (the base recipe), DefRec_on_trgt with the combined branch (their DefRec
# terms add), Norm_on_trgt and Density_on_trgt.
MLSP = {"DefRec_on_trgt": False, "Density_normal_viainput": True,
        "Normal_ondef": True, "Density_ondef": True}
STEP_CASES = {
    "mlsp_pcm": {**MLSP, "apply_PCM": True},
    "defrec": {},
    "defrec_viainput": {**MLSP, "DefRec_on_trgt": True},
    "norm": {"DefRec_on_trgt": False, "Norm_on_trgt": True},
    "density": {"DefRec_on_trgt": False, "Density_on_trgt": True},
}


@contextlib.contextmanager
def _capture_jax_graphs(store: dict):
    """JAX's kNN graphs (the seg model's and the normals') into `store`
    while a jitted program traced inside the block runs, keyed by trace
    order, which is the step's call order."""
    count = [0]

    def wrap(orig):
        def knn(x, k, *args, **kwargs):
            idx = orig(x, k, *args, **kwargs)
            i = count[0]
            count[0] += 1
            jax.debug.callback(
                lambda g, i=i: store.__setitem__(i, np.array(g)), idx)
            return idx
        return knn

    with mock.patch.object(_jdseg, "knn_indices", wrap(_jdseg.knn_indices)), \
            mock.patch.object(_jnormals, "knn_indices",
                              wrap(_jnormals.knn_indices)):
        yield


class TestSegStep:
    B, N = 2, 128

    @pytest.mark.parametrize("case", list(STEP_CASES))
    def test_losses_and_grads_match_jax(self, seg_variables, case):
        """One iteration at B=2, N=128, k=20, train-mode BN, dropout 0, fed
        the JAX step's own draws (its `debug_aux` taps; the combined
        branch's deformation recomputed from its key split), the port
        replaying the JAX step's kNN graphs. Train-mode BN over a batch of
        2 carries a ReLU or max kink that float32 rounding flips to every
        point, so each loss term must be within 1e-4 relative and each
        gradient within 2e-4 relative L2 (`grad_gaps`), each plus 3 times
        the JAX step's own change under a 1e-6 input shift. The gradient
        bound is 2e-4, not 1e-4: torch's float32 BatchNorm backward on the
        CPU rounds its sums more coarsely than XLA's (MLSP recipe,
        `seg.bn2.bias`: the port 1.2e-4 from a float64 run of itself, the
        JAX step 2.8e-7 from it). The JAX step
        returns no gradients: they come from one step of SGD at lr 1e4,
        (before - after) / 1e4. The predictions for the train mIoU and
        their labels agree."""
        B, N = self.B, self.N
        recipe = STEP_CASES[case]
        cfg_j = jconfig.PointSegDAConfig(batch_size=B, num_points=N,
                                         dropout=0.0, knn_backend="xla",
                                         debug_aux=True, **recipe).resolved()
        cfg = PointSegDAConfig(batch_size=B, num_points=N, dropout=0.0,
                               **recipe).resolved()
        v = seg_variables
        lr = 1e4
        state = jstate.TrainState.create(
            apply_fn=_jax_model().apply, params=v["params"],
            batch_stats=v["batch_stats"], tx=optax.sgd(lr))
        rng = np.random.default_rng(11)
        src, trgt = _unit_clouds(rng, B, N), _unit_clouds(rng, B, N)
        src_y = rng.integers(0, 8, (B, N))
        key = jax.random.key(12)
        graphs = {}
        jax.clear_caches()  # no inner program traced by another case
        with _capture_jax_graphs(graphs):
            step = jax.jit(functools.partial(jseg._seg_step_inner, cfg=cfg_j))

            def run(delta):
                out = step(state, jnp.asarray(src + delta), jnp.asarray(src_y),
                           jnp.asarray(trgt + delta), key)
                jax.effects_barrier()
                return out

            new_state, m, (jpreds, jlabels) = run(0.0)
            recorded = [torch.from_numpy(graphs[i]) for i in sorted(graphs)]
            floor_state, floor, _ = run(1e-6)
        aux = {k: _t(a) for k, a in m.items() if k.startswith("aux_")}
        draws = {}
        if cfg.apply_PCM:
            draws["mixed"], draws["mixed_y"] = aux["aux_src"], aux["aux_sy"]
        if cfg.DefRec_on_trgt:
            draws["dx"], draws["dmask"] = aux["aux_dx"], aux["aux_dmask"]
        if cfg.Density_normal_viainput:
            k8 = jax.random.split(key, 12)[8]
            dx, mask = jax.jit(functools.partial(
                jsteps.deform_dispatch, cfg=cfg_j))(k8, jnp.asarray(
                    m["aux_trgt"]))
            draws["dx_via"], draws["dmask_via"] = _t(dx), _t(mask)

        model = _port(v)
        tape = Tape(graphs=recorded)
        with tape.replay():
            total, got, (preds, labels) = seg_steps.pointsegda_losses(
                model, cfg, {"src_x": aux["aux_src"],
                             "src_y": aux["aux_sy"].long(),
                             "trgt_x": aux["aux_trgt"]}, draws, None)
            total.backward()
        assert set(got) == {k for k in m if not k.startswith("aux_")}
        for name, t in got.items():
            want = float(m[name])
            tol = 1e-4 + 3.0 * abs(float(floor[name]) / want - 1.0)
            assert abs(t.item() / want - 1.0) <= tol, (name, t.item(), want)

        def grads(new):
            return jax.tree_util.tree_map(
                lambda a, b: (np.asarray(a) - np.asarray(b)) / lr,
                v["params"], new.params)

        trained = _assert_seg_grads(model, grads(new_state), 2e-4,
                                    grads(floor_state))
        heads = {"seg": "seg.", "defrec": "DefRec.", "normal": "Norm_pred.",
                 "density": "Density_cls."}
        assert {h for h, p in heads.items()
                if any(n.startswith(p) for n in trained)} == set(
                    config.trained_seg_heads(cfg))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        assert (preds.numpy() == np.asarray(jpreds)).mean() >= 0.99


class TestPortSegStep:
    def test_runs_on_the_cpu(self):
        """The whole step on CPU tensors with the port's own draws: finite
        losses, predictions and labels of the batch's shape."""
        cfg = PointSegDAConfig(batch_size=2, num_points=128, apply_PCM=True,
                               **MLSP).resolved()
        g = torch.Generator().manual_seed(0)
        model = make_model("dgcnn_seg", 8, device="cpu", generator=g)
        opt, sched = make_optimizer(model, cfg.lr, cfg.wd, cfg.epochs, 10)
        x, y = synthetic.make_segmentation(4, 128, 8, seed=1)
        m, (preds, labels) = seg_steps.pointsegda_train_step(
            model, opt, sched, torch.from_numpy(x[:2]),
            torch.from_numpy(y[:2]), torch.from_numpy(x[2:]), g, cfg)
        assert set(m) == {"src_seg", "trgt_DefRec", "trgt_def_normal",
                          "trgt_def_density_cls", "trgt_def_density_mse",
                          "total"}
        assert all(torch.isfinite(t) for t in m.values())
        assert preds.shape == labels.shape == (2, 128)
        # PCM moves the labels with their points: a permutation of a mix
        assert not torch.equal(labels, torch.from_numpy(y[:2]))

    def test_unported_model_raises(self):
        """`vit` is a classifier (ported): the seg step refuses it."""
        cfg = PointSegDAConfig(model="vit")
        with pytest.raises(ValueError, match="not a PointSegDA segmenter"):
            seg_steps.pointsegda_losses(None, cfg, {}, {}, None)
