"""The EdgeConv statistics (`ops/edge.py`, kernels K2-fwd and K2-bwd) on the
CPU: the plain version against the JAX package's Pallas kernel (interpret
mode) on graphs where a few points are neighbours of many, and the launch
plan of the kernels (`ops/kernels/edge.py::plan`), which launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu.ops.pallas.edge_pallas import edge_moments as jax_edge_moments
from mlsp_tpu_torch.ops import edge_moments
from mlsp_tpu_torch.ops.kernels import edge as K


def _high_in_degree(kind, B=2, N=48, Cg=4, C=8, seed=11):
    """(xg, u, cotangents) as numpy. Integer coordinates make every kNN
    distance exact in both programs, so both rank equal distances by the
    lower index. `repeated`: every point at one place, so every row's
    neighbours are the k lowest indices (in-degree N). `third`: the first
    third of the points at one place. u repeats each even point's values
    at the next point, so maxima and minima tie."""
    rng = np.random.default_rng(seed)
    xg = rng.integers(-2, 3, (B, N, Cg)).astype(np.float32)
    if kind == "repeated":
        xg[:] = xg[:, :1]
    else:
        xg[:, : N // 3] = xg[:, :1]
    u = rng.standard_normal((B, N, C)).astype(np.float32)
    u[:, 1::2] = u[:, 0::2]
    cots = rng.standard_normal((4, B, N, C)).astype(np.float32)
    return xg, u, cots


@pytest.mark.parametrize("kind", ["repeated", "third"])
def test_plain_matches_jax_kernel_on_high_in_degree(kind):
    """Forward at rtol = atol = 1e-5, and the gradient at rtol = 1e-5,
    atol = 1e-5 max|want| (the tolerance of the JAX comparisons of
    test_torch_port_train_ops.py): the case the backward's scatter, whose
    additions land on few rows, is most exposed to."""
    k = 6
    xg, u, cots = _high_in_degree(kind)
    got = edge_moments(torch.from_numpy(xg), torch.from_numpy(u), k, True)
    want = jax_edge_moments(jnp.asarray(xg), jnp.asarray(u), k, True,
                            tile=16, interpret=True)
    for name, g, w in zip("mx mn s1 s2".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    def f_jax(u_):
        outs = jax_edge_moments(jnp.asarray(xg), u_, k, True, tile=16,
                                interpret=True)
        return sum((cots[i] * o).sum() for i, o in enumerate(outs))

    want = np.asarray(jax.grad(f_jax)(jnp.asarray(u)))
    uu = torch.from_numpy(u).requires_grad_()
    outs = edge_moments(torch.from_numpy(xg), uu, k, True)
    sum((torch.from_numpy(cots[i]) * o).sum() for i, o in enumerate(outs)
        ).backward()
    np.testing.assert_allclose(uu.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("C", [1, 3, 64, 100, 256])
@pytest.mark.parametrize("N", [1, 20, 1000, 1024, 2048, K.N_MAX])
def test_plan_fits_shared_memory(N, C, backward):
    for k in (1, 20, N, 3 * N + 7):
        p = K.plan(32, N, C, k, backward)
        assert p.smem <= K.SMEM_LIMIT
        assert p.cs in (1, 2, 4, 8, 16, 32) and p.threads % 32 == 0
        assert 32 <= p.threads <= 1024 and p.split >= 1
        assert 1 <= p.qc <= -(-N // p.split) and 1 <= p.kc <= k
        if k <= 32:  # kNN graphs: every index chunk holds whole rows
            assert p.kc == k


# Each path of the kernels that a plan can take, and a shape of the card
# tests (tests/test_torch_port_cuda.py) whose plan takes it.
PATHS = {
    "query ranges": ((2, 1000, 64, 20, False),
                     lambda p, N, k: p.split > 1),
    "index chunks": ((2, 8192, 100, 20, False),
                     lambda p, N, k: p.qc < -(-N // p.split)),
    "index chunks, backward": ((2, 8192, 100, 20, True),
                               lambda p, N, k: p.qc < N),
    "neighbour chunks": ((1, 300, 5, 5000, False), lambda p, N, k: p.kc < k),
    "neighbour chunks, backward": ((1, 300, 5, 5000, True),
                                   lambda p, N, k: p.kc < k),
    "512 threads": ((2, 200, 64, 20, True),
                    lambda p, N, k: p.threads == 512),
}


@pytest.mark.parametrize("path", PATHS)
def test_plan_takes_every_path_at_a_card_test_shape(path):
    (B, N, C, k, backward), takes = PATHS[path]
    p = K.plan(B, N, C, k, backward)
    assert takes(p, N, k), p
    assert p.split == 1 or not backward  # the backward has no query ranges


@pytest.mark.parametrize("backward", [False, True])
def test_plan_refuses_clouds_beyond_the_limit(backward):
    assert K.N_MAX >= 8192
    K.plan(1, K.N_MAX, 64, 20, backward)
    with pytest.raises(ValueError, match=str(K.N_MAX)):
        K.plan(1, K.N_MAX + 1, 64, 20, backward)
