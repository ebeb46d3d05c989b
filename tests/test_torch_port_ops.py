"""Port ops (`mlsp_tpu_torch.ops`) held against the JAX package on the CPU.

The same numpy inputs go through both; JAX runs on the CPU (conftest), its
Pallas kernels in interpret mode, and the port takes its plain versions
because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.ops.knn import edge_features as jax_edge_features
from mlsp_tpu.ops.knn import knn_indices as jax_knn_indices
from mlsp_tpu.ops.pairwise import pairwise_sqdist as jax_pairwise_sqdist
from mlsp_tpu.ops.pallas.edge_pallas import edge_moments as jax_edge_moments
from mlsp_tpu.ops.pallas.knn_pallas import knn_pallas
from mlsp_tpu_torch.ops import (
    edge_features,
    edge_moments,
    knn_indices,
    pairwise_sqdist,
)
from mlsp_tpu_torch.ops.kernels import edge_moments_cuda, knn_cuda


def _sorted_dists(x, idx):
    """Each row's neighbour distances, recomputed in float64 and sorted:
    equal sets mean the same neighbourhood up to the order of ties."""
    xn = np.asarray(x, np.float64)
    d = ((xn[:, :, None] - xn[:, None]) ** 2).sum(-1)
    return np.sort(np.take_along_axis(d, np.asarray(idx), -1), -1)


def _cloud(seed, shape, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:  # every 4th point repeats its predecessor
        x[:, 1::4] = x[:, 0::4][:, : x[:, 1::4].shape[1]]
    return x


class TestKnn:
    @pytest.mark.parametrize("C,N,dup", [
        (3, 128, False), (8, 128, False), (64, 128, False),
        (3, 128, True),    # duplicate points: ties at distance 0
        (3, 100, False),   # N not a multiple of any power-of-two tile
    ])
    def test_matches_jax(self, C, N, dup):
        k = 20
        x = _cloud(C + N, (2, N, C), dup)
        got = knn_indices(torch.from_numpy(x), k).numpy()
        assert got.shape == (2, N, k) and got.dtype == np.int64
        want_xla = np.asarray(jax_knn_indices(jnp.asarray(x), k, backend="xla"))
        want_pallas = np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True))
        for want in (want_xla, want_pallas):
            np.testing.assert_allclose(_sorted_dists(x, got),
                                       _sorted_dists(x, want), atol=1e-9)
        # distinct points: the same indices as the XLA path, self first
        if not dup:
            np.testing.assert_array_equal(got, want_xla)
            np.testing.assert_array_equal(got[:, :, 0],
                                          np.broadcast_to(np.arange(N), (2, N)))

    def test_duplicates_lower_index_first(self):
        """With the clamp at 0 a duplicate ties with self; the lower index
        ranks first, as in the XLA path."""
        x = _cloud(0, (1, 64, 3), dup=True)
        got = knn_indices(torch.from_numpy(x), 4).numpy()
        np.testing.assert_array_equal(got[0, 1::4, 0], np.arange(0, 64, 4))
        np.testing.assert_array_equal(got[0, 0::4, 0], np.arange(0, 64, 4))

    def test_k_exceeds_n_raises(self):
        with pytest.raises(ValueError, match="exceeds"):
            knn_indices(torch.zeros(1, 8, 3), 9)

    def test_backend_dispatch(self):
        x = torch.zeros(1, 8, 3)
        with pytest.raises(ValueError, match="no path"):
            knn_indices(x, 4, backend="cuda")  # the kernel needs the card
        with pytest.raises(ValueError, match="backend must be"):
            knn_indices(x, 4, backend="pallas")
        with pytest.raises(ValueError, match="CUDA tensor"):
            knn_cuda(x, 4)
        with pytest.raises(ValueError, match="CUDA tensors"):
            edge_moments_cuda(x, torch.zeros(1, 8, 4, dtype=torch.int64), False)


class TestPairwiseAndGather:
    def test_pairwise_sqdist(self):
        x, y = _cloud(1, (2, 50, 8)), _cloud(2, (2, 70, 8))
        got = pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(jax_pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert got.min() >= 0.0

    def test_edge_features(self):
        x = _cloud(3, (2, 40, 5))
        idx = np.random.default_rng(4).integers(0, 40, (2, 40, 7))
        got = edge_features(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        want = np.asarray(jax_edge_features(jnp.asarray(x), jnp.asarray(idx)))
        np.testing.assert_array_equal(got, want)


class TestEdgeMoments:
    @pytest.mark.parametrize("want_moments", [True, False])
    def test_matches_jax_kernel(self, want_moments):
        k = 6
        xg, u = _cloud(5, (2, 64, 8)), _cloud(6, (2, 64, 16))
        got = edge_moments(torch.from_numpy(xg), torch.from_numpy(u), k,
                           want_moments)
        want = jax_edge_moments(jnp.asarray(xg), jnp.asarray(u), k,
                                want_moments, tile=32, interpret=True)
        assert len(got) == len(want) == (4 if want_moments else 2)
        for name, g, w in zip("mx mn s1 s2".split(), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
