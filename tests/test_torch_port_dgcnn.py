"""Port DGCNN (`mlsp_tpu_torch.models`) held against the JAX DGCNN on the CPU:
weights carried over by `dgcnn_state_dict_from_jax`, eval forward compared
head by head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.models import DGCNN as JaxDGCNN
from mlsp_tpu.utils.torch_export import export_dgcnn
from mlsp_tpu_torch.models import DGCNN, make_model
from mlsp_tpu_torch.utils.jax_weights import dgcnn_state_dict_from_jax

HEADS = ("defrec", "normal", "scan", "density")
B, N = 4, 128


def _jax_model(edge_impl):
    return JaxDGCNN(num_classes=10, k=20, edge_impl=edge_impl,
                    knn_backend="xla")


def _variables(model, seed):
    """Initialised variables with randomised BatchNorm: gamma of both signs
    (a negative gamma turns EdgeConvM's max into a min, which gamma = 1
    at init would hide), beta, and running statistics."""
    v = jax.jit(lambda r, x: model.init({"params": r}, x, train=False,
                                        heads=HEADS))(
        jax.random.key(seed), jnp.zeros((1, N, 3), jnp.float32))
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
                stat, v["batch_stats"])}


def _port(variables):
    model = make_model("dgcnn", 10, device="cpu", k=20)
    model.load_state_dict(dgcnn_state_dict_from_jax(variables), strict=True)
    return model


class TestWeights:
    def test_equals_export_dgcnn(self):
        v = _variables(_jax_model("moments"), 0)
        got = dgcnn_state_dict_from_jax(v)
        want = export_dgcnn(v)
        assert list(got) == list(want)
        for key, a in want.items():
            assert got[key].numpy().dtype == np.asarray(a).dtype, key
            np.testing.assert_array_equal(got[key].numpy(), a, err_msg=key)
        # the reference layout is the port's own
        DGCNN(num_classes=10).load_state_dict(got, strict=True)

    def test_missing_head_raises(self):
        m = _jax_model("moments")
        v = jax.jit(lambda r, x: m.init({"params": r}, x, train=False,
                                        heads=("defrec",)))(
            jax.random.key(0), jnp.zeros((1, N, 3), jnp.float32))
        with pytest.raises(ValueError, match="NormPred"):
            dgcnn_state_dict_from_jax(v)


class TestForward:
    @pytest.mark.parametrize("edge_impl", ["moments", "direct"])
    def test_eval_matches_jax(self, edge_impl):
        """Both JAX EdgeConv forms load into the one port class."""
        jm = _jax_model(edge_impl)
        v = _variables(jm, 1)
        x = np.random.default_rng(2).standard_normal((B, N, 3)).astype(
            np.float32)
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False, heads=HEADS))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got = _port(v)(torch.from_numpy(x), heads=HEADS)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)

    def test_unknown_head_raises(self):
        with pytest.raises(ValueError, match="unknown heads"):
            make_model("dgcnn", 10, device="cpu")(torch.zeros(1, 32, 3),
                                                  heads=("seg",))

    def test_seeded_init(self):
        """The generator alone fixes the weights; density bins are frozen."""
        def sd(seed):
            return make_model("dgcnn", 10, device="cpu",
                              generator=torch.Generator().manual_seed(seed)
                              ).state_dict()
        a, b, c = sd(3), sd(3), sd(4)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["conv1.conv.0.weight"],
                               c["conv1.conv.0.weight"])
        np.testing.assert_array_equal(a["Density_cls.fc2.weight"].numpy(),
                                      2.0 * np.arange(16)[None])
