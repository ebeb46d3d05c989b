"""Reproducible training pieces of the port on the CPU.

K2-bwd (`csrc/edge_moments.cu`) adds du in fixed point, split over two
32-bit integer sums, at a scale its pre-pass picks per (cloud, channel
slice), so that its sums do not depend on the order of its atomics. Here,
without the card: that pre-pass in plain PyTorch
(`ops/kernels/edge.py::fixed_point_split`) against numpy;
the fixed-point sum of the plain terms at that scale, in any order,
against autograd's du within K2-bwd's tolerance; the plain K2-bwd against
the gradient of the JAX package's Pallas kernel (interpret mode) on
tie-heavy graphs; and the `download` subcommand of both packages with
`subprocess.run` stubbed. (A train step taken twice is held bit-equal on
the card, tests/test_torch_port_cuda.py. On the CPU two paper steps in
one pytest process have parted in their gradients at the rounding level,
equal in a plain process: the CPU's libraries promise no fixed order.)
"""

import os
import subprocess
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlsp_tpu import cli as jax_cli
from mlsp_tpu.data import download as jax_download
from mlsp_tpu.ops.pallas.edge_pallas import edge_moments as jax_edge_moments
from mlsp_tpu_torch import cli as torch_cli
from mlsp_tpu_torch.data import download as torch_download
from mlsp_tpu_torch.ops import edge_moments
from mlsp_tpu_torch.ops.edge import edge_moments_torch
from mlsp_tpu_torch.ops.kernels import edge as K
from mlsp_tpu_torch.ops.knn import knn_indices_torch
from mlsp_tpu_torch.testing import edge_grad_magnitude


def _operands(B=2, N=40, C=37, k=6, seed=0, nonfinite=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, N, C)).astype(np.float32)
    cots = [rng.standard_normal((B, N, C)).astype(np.float32)
            * np.float32(10.0 ** rng.integers(-3, 3)) for _ in range(4)]
    if nonfinite:
        u[0, 3, 5] = np.inf
        cots[0][1, 2, 30] = np.nan
        cots[3][0, 7, 1] = -np.inf
    idx = rng.integers(0, N, (B, N, k))
    return u, idx, cots


def _numpy_split(u, idx, cots, cs):
    """The pre-pass as its comment in csrc/edge_moments.cu states it."""
    B, N, C = u.shape
    slices = -(-C // cs)

    def slice_max(a):
        if a is None:
            return np.zeros((B, slices))
        a = np.abs(a.astype(np.float32))
        a = np.where(np.isfinite(a), a, 0.0)
        out = np.zeros((B, slices))
        for s in range(slices):
            out[:, s] = a[:, :, s * cs:(s + 1) * cs].max(axis=(1, 2))
        return out

    degree = np.array([np.bincount(i[(i >= 0) & (i < N)], minlength=N).max()
                       for i in idx.reshape(B, -1)]).clip(1)[:, None]
    lbits = np.array([[32 - int(3 * d).bit_length()] for d in degree[:, 0]])
    dmx, dmn, ds1, ds2 = cots
    two_ds2 = None if ds2 is None else np.float32(2.0) * ds2
    most = degree * (slice_max(ds1) + slice_max(two_ds2) * slice_max(u)
                     + slice_max(dmx) + slice_max(dmn))
    return 30 + lbits - np.frexp(most)[1], lbits


@pytest.mark.parametrize("case", ["random", "nonfinite", "no sums",
                                  "max only", "zero cotangents",
                                  "out-of-range indices"])
def test_fixed_point_split_matches_numpy(case):
    u, idx, cots = _operands(nonfinite=case == "nonfinite")
    if case == "no sums":
        cots = cots[:2] + [None, None]
    elif case == "max only":
        cots = cots[:1] + [None, None, None]
    elif case == "zero cotangents":
        cots = [np.zeros_like(u)] * 4
    elif case == "out-of-range indices":
        idx[0, :, 0] = u.shape[1] + 3  # the spare row: not counted
        idx[1, 4, 2] = -1
    cs = K.plan(*u.shape, idx.shape[-1], True).cs
    got = K.fixed_point_split(
        torch.from_numpy(u), torch.from_numpy(idx),
        *[None if c is None else torch.from_numpy(c) for c in cots])
    want = _numpy_split(u, idx, cots, cs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].shape == (u.shape[0], -(-u.shape[2] // cs))


def _plain_du(u, idx, cots):
    uu = torch.from_numpy(u).requires_grad_()
    outs = edge_moments_torch(uu, torch.from_numpy(idx), True)
    return torch.autograd.grad(outs, uu, [torch.from_numpy(c)
                                          for c in cots])[0].numpy()


def _fixed_point_du(u, idx, cots, split, cs, order):
    """du as K2-bwd sums it, in units of 2^-s: a sum term as
    round(ds1_i 2^s) + round(fl(2 ds2_i 2^s u_j)) (the product rounded in
    float32), a tie's share of dmx_i, dmn_i as round(w 2^s); each q split
    as h 2^L + l, the h and the l summed apart in the order `order` of the
    edges, each sum held to its 32-bit range, then converted back."""
    B, N, C = u.shape
    k = idx.shape[-1]
    dmx, dmn, ds1, ds2 = cots
    shift, lbits = split
    scale = np.ldexp(1.0, np.repeat(shift, cs, axis=1)[:, :C])  # [B, C]
    sum_h = np.zeros((B, N, C), np.int64)
    sum_l = np.zeros((B, N, C), np.int64)
    g = u[np.arange(B)[:, None, None], idx]  # [B, N, k, C]
    mx, mn = g.max(2), g.min(2)
    n_hi = (g == mx[:, :, None]).sum(2)
    n_lo = (g == mn[:, :, None]).sum(2)
    for e in order:
        i, p = divmod(int(e), k)
        j = idx[:, i, p]
        v = u[np.arange(B), j]  # [B, C]
        g2s = (2 * ds2[:, i]) * scale.astype(np.float32)  # exact
        share_hi = dmx[:, i] / n_hi[:, i].astype(np.float32)
        share_lo = dmn[:, i] / n_lo[:, i].astype(np.float32)
        qs = [np.rint(ds1[:, i].astype(np.float64) * scale)
              + np.rint((g2s * v).astype(np.float64))]
        qs += [np.rint(np.where(v == ext, share, 0).astype(np.float64)
                       * scale)
               for ext, share in ((mx[:, i], share_hi), (mn[:, i], share_lo))]
        for q in qs:
            q = q.astype(np.int64)
            sum_h[np.arange(B), j] += q >> lbits
            sum_l[np.arange(B), j] += q & ((1 << lbits) - 1)
    assert (np.abs(sum_h) < 2 ** 31).all() and (sum_l < 2 ** 32).all()
    q = sum_h * (1 << lbits)[:, :, None] + sum_l
    return (q.astype(np.float64) / scale[:, None, :]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_point_sum_is_order_free_and_within_tolerance(seed):
    """Two orders of the edges give bit-equal fixed-point du, within 1e-5
    of the summed term magnitudes of autograd's du (the card's bound:
    `tests/test_torch_port_cuda.py::
    test_edge_gradient_within_tolerance_of_the_plain_version`), on a graph
    where a third of the rows point at the same few points; the 32-bit
    sums do not overflow."""
    u, idx, cots = _operands(B=2, N=24, C=19, k=5, seed=seed)
    idx[:, : 8] = np.arange(5)  # in-degree >= 8 at rows 0-4
    u[:, 1::2] = u[:, 0::2]  # ties at the max and the min
    cs = K.plan(*u.shape, idx.shape[-1], True).cs
    split = [t.numpy() for t in K.fixed_point_split(
        torch.from_numpy(u), torch.from_numpy(idx),
        *map(torch.from_numpy, cots))]
    rng = np.random.default_rng(seed)
    edges = np.arange(u.shape[1] * idx.shape[-1])
    a = _fixed_point_du(u, idx, cots, split, cs, edges)
    b = _fixed_point_du(u, idx, cots, split, cs, rng.permutation(edges))
    np.testing.assert_array_equal(a, b)
    want = _plain_du(u, idx, cots)
    tol = 1e-5 * edge_grad_magnitude(torch.from_numpy(u),
                                     torch.from_numpy(idx),
                                     [torch.from_numpy(c) for c in cots])
    assert (np.abs(a - want) <= tol.numpy()).all()


def _tie_heavy(kind, B=2, N=32, Cg=3, C=8, seed=5):
    """(xg, u, k) as numpy, on integer coordinates (exact distances: both
    programs pick the same sets, ties to the lower index)."""
    rng = np.random.default_rng(seed)
    xg = rng.integers(-2, 3, (B, N, Cg)).astype(np.float32)
    u = rng.standard_normal((B, N, C)).astype(np.float32)
    k = 6
    if kind == "repeated point":  # every neighbour tied, in-degree N
        xg[:] = 0.0
        u[:] = u[:, :1]
    elif kind == "signed zeros":  # +0 and -0 tie under float ==
        u = rng.integers(-1, 2, (B, N, C)).astype(np.float32)
        u[u == 0] = 0.0
        u[:, ::3][u[:, ::3] == 0] = -0.0
    elif kind == "N <= k":  # every row holds every point
        xg, u, k = xg[:, :6], u[:, :6], 6
    elif kind == "few values":  # many ties at the max and the min
        u = rng.integers(-2, 3, (B, N, C)).astype(np.float32) * 0.5
    return xg, u, k


@pytest.mark.parametrize("cots_used", ["all", "max only"])
@pytest.mark.parametrize("kind", ["repeated point", "signed zeros",
                                  "N <= k", "few values"])
def test_plain_backward_matches_jax_kernel_on_ties(kind, cots_used):
    """The plain K2-bwd (autograd through `edge_moments_torch`) against
    jax.grad of the Pallas kernel, rtol 1e-5 and atol 1e-5 max|want| (the
    bound of test_torch_port_edge.py). "max only" is the cotangent a max
    over gathered u sends (dmx alone)."""
    xg, u, k = _tie_heavy(kind)
    rng = np.random.default_rng(7)
    cots = rng.standard_normal((4,) + u.shape).astype(np.float32)
    used = 4 if cots_used == "all" else 1

    def f_jax(u_):
        outs = jax_edge_moments(jnp.asarray(xg), u_, k, True, tile=u.shape[1],
                                interpret=True)
        return sum((cots[i] * o).sum() for i, o in enumerate(outs[:used]))

    want = np.asarray(jax.grad(f_jax)(jnp.asarray(u)))
    uu = torch.from_numpy(u).requires_grad_()
    outs = edge_moments(torch.from_numpy(xg), uu, k, True)
    sum((torch.from_numpy(cots[i]) * o).sum() for i, o in enumerate(outs[:used])
        ).backward()
    np.testing.assert_allclose(uu.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if kind == "N <= k":
        idx = knn_indices_torch(torch.from_numpy(xg), k)
        assert (idx.sort(-1).values == torch.arange(k)).all()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _fake_gdown(calls):
    """A stand-in for `subprocess.run(["gdown", URL, "-O", dest])`: writes a
    small zip at dest."""
    def run(cmd, check=False, **kw):
        calls.append(list(cmd))
        assert cmd[0] == "gdown" and cmd[2] == "-O"
        top = os.path.basename(cmd[3]).rsplit(".", 1)[0]
        with zipfile.ZipFile(cmd[3], "w") as z:
            z.writestr(f"{top}/modelnet/train/a.npy", b"\x93NUMPY-a")
            z.writestr(f"{top}/scannet/test/b.npy", b"\x93NUMPY-b")
        return subprocess.CompletedProcess(cmd, 0)
    return run


@pytest.mark.parametrize("task", ["pointda", "pointsegda"])
def test_download_writes_the_same_tree_as_jax(task, tmp_path, monkeypatch,
                                              capsys):
    """Both packages' `download` subcommands, gdown stubbed: the same
    Google Drive URL and archive name, the same extracted tree, the same
    message; an archive already there is not fetched again."""
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_gdown(calls))
    roots = {}
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        root = str(tmp_path / name)
        assert main(["download", "--task", task, "--dataroot", root]) == 0
        said = capsys.readouterr().out
        assert said.strip() == f"dataset extracted under {root}"
        roots[name] = root
    assert len(calls) == 2
    assert [c[:2] for c in calls][0] == [c[:2] for c in calls][1]
    assert os.path.basename(calls[0][3]) == os.path.basename(calls[1][3])
    assert _tree(roots["jax"]) == _tree(roots["torch"])
    assert len(_tree(roots["torch"])) == 3  # the archive and two files
    # the archive is there: no second fetch, extracted again
    fetch = {"pointda": torch_download.download_pointda,
             "pointsegda": torch_download.download_pointsegda}[task]
    assert fetch(roots["torch"]) == roots["torch"]
    assert len(calls) == 2


@pytest.mark.parametrize("fault", [FileNotFoundError("gdown"),
                                   subprocess.CalledProcessError(1, "gdown")])
@pytest.mark.parametrize("task", ["pointda", "pointsegda"])
def test_download_without_gdown_raises_the_same_error(task, fault, tmp_path,
                                                      monkeypatch):
    """No gdown, or gdown failing: both packages raise RuntimeError with
    the same text, naming --synthetic, and leave no archive."""
    def run(cmd, check=False, **kw):
        raise fault

    monkeypatch.setattr(subprocess, "run", run)
    root = str(tmp_path / "data")
    msgs = []
    for mod in (jax_download, torch_download):
        with pytest.raises(RuntimeError) as e:
            getattr(mod, f"download_{task}")(root)
        assert e.value.__cause__ is fault
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--synthetic" in msgs[1]
    assert os.listdir(root) == []
    assert (jax_download.POINTDA_GDRIVE_ID, jax_download.POINTSEGDA_GDRIVE_ID
            ) == (torch_download.POINTDA_GDRIVE_ID,
                  torch_download.POINTSEGDA_GDRIVE_ID)


def test_backward_plan_refuses_clouds_whose_sums_could_overflow():
    """K2-bwd's 32-bit sums hold at most 3D adds of an element, D <= N k:
    N k above 2^28 is refused before a launch; the forward takes it."""
    n = 8192
    K.plan(1, n, 64, (1 << 28) // n, True)
    with pytest.raises(ValueError, match="overflow"):
        K.plan(1, n, 64, (1 << 28) // n + 1, True)
    K.plan(1, n, 64, (1 << 28) // n + 1, False)
