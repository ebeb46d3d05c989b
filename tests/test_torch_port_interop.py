"""Checkpoint interop of the port on the CPU: reference `model.pt` files
in (`--from_torch`, `utils/reference_import.py`) and out (`export`,
`utils/reference_export.py`), and the JAX package's msgpack `.ckpt` in
(`utils/jax_checkpoint.py`).

No reference file is in the repository: the `model.pt` fixtures are
written by the JAX package's own `mlsp_tpu.utils.torch_export` from
seeded flax variables (randomised BatchNorm, as in
`test_torch_port_families.py`), and the `.ckpt` fixtures by its
`mlsp_tpu.utils.checkpoint.save_train_state`. Bounds: logits within
rtol/atol 1e-4 of JAX's on the same file (each side on its own kNN graphs
and FPS orders of standard-normal clouds; dropout 0), but for the export
of an untied DGCNNSeg, whose pseudo-inverse solve is exact only up to
rounding, which it amplifies: JAX's own round-trip tolerance, 1e-3. The
DGCNNSeg `model.pt` read in is written from tied second maps, the one conv
the reference has (`_reference_tied`).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_port_families import FAMILIES, HS_KW, randomised

from mlsp_tpu.models import DGCNN as JaxDGCNN
from mlsp_tpu.models import DGCNNSeg as JaxDGCNNSeg
from mlsp_tpu.models.vit import PointViT as JaxViT
from mlsp_tpu.train.state import create_train_state
from mlsp_tpu.utils import checkpoint as jcheckpoint
from mlsp_tpu.utils import torch_export, torch_import
from mlsp_tpu_torch import cli, make_model
from mlsp_tpu_torch.train import evaluation
from mlsp_tpu_torch.utils import (
    checkpoint,
    jax_checkpoint,
    reference_export,
    reference_import,
)
from mlsp_tpu_torch.utils import jax_weights as jw
from mlsp_tpu_torch.utils.config import EvalConfig

B, N = 2, 64
DGCNN_HEADS = ("defrec", "normal", "scan", "density")
SEG_HEADS = ("seg", "defrec", "normal", "density")
VIT_KW = dict(trans_dim=32, encoder_dims=32, depth=2, heads=2, num_group=8,
              group_size=8, fetch_idx=(0, 1))


def _family(name):
    f = FAMILIES[name]
    return f.jax_model, f.port_kw, f.heads, f.classes


# name -> (flax model, port keywords, heads, classes)
MODELS = {
    "dgcnn": (JaxDGCNN(num_classes=10, k=20, edge_impl="moments",
                       knn_backend="xla", dropout=0.0), {}, DGCNN_HEADS, 10),
    "dgcnn_seg": (JaxDGCNNSeg(num_classes=8, k=20, knn_backend="xla",
                              dropout=0.0), {}, SEG_HEADS, 8),
    **{n: _family(n) for n in ("pointnet", "pointnet2", "point_transformer",
                               "hengshuang", "hengshuang_seg")},
    **{f"vit_{e}": (JaxViT(num_classes=10, dropout=0.0, knn_backend="xla",
                           encoder_type=e, **VIT_KW),
                    {"encoder_type": e, **VIT_KW}, ("defrec",), 10)
       for e in ("relative", "pointnet", "dgcnn", "pointnet_tnet")},
}
REFERENCE = ("dgcnn", "pointnet", "dgcnn_seg", "point_transformer",
             "hengshuang", "hengshuang_seg")
EXPORT = {
    "dgcnn": torch_export.export_dgcnn,
    "pointnet": torch_export.export_pointnet,
    "dgcnn_seg": torch_export.export_dgcnn_seg,
    "point_transformer": torch_export.export_point_transformer,
    "hengshuang": lambda v: torch_export.export_hengshuang(v, 2),
    "hengshuang_seg": lambda v: torch_export.export_hengshuang(
        v, 2, strict=False),
}
IMPORT = {
    "dgcnn": torch_import.load_reference_dgcnn,
    "pointnet": torch_import.load_reference_pointnet,
    "dgcnn_seg": torch_import.load_reference_dgcnn_seg,
    "point_transformer": torch_import.load_reference_point_transformer,
    "hengshuang": lambda p, v: torch_import.load_reference_hengshuang(p, v, 2),
    "hengshuang_seg": lambda p, v: torch_import.load_reference_hengshuang(
        p, v, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n(name):
    return 512 if name == "pointnet2" else N


def _key(name):
    return "seg" if "seg" in name else "cls"


@functools.cache
def _init(name):
    m, _, heads, _ = MODELS[name]
    return jax.jit(lambda r: m.init({"params": r}, jnp.zeros((1, _n(name), 3)),
                                    train=False, heads=heads))


def variables(name, seed):
    v = _init(name)(jax.random.key(seed))
    return jax.tree_util.tree_map(np.asarray, randomised(v, seed))


def canonical(name):
    return "vit" if name.startswith("vit_") else name


def port_model(name, **kw):
    _, port_kw, _, classes = MODELS[name]
    return make_model(canonical(name), classes, device="cpu", dropout=0.0,
                      **{**port_kw, **kw})


@functools.cache
def _jax_logits_fn(name):
    m, _, _, _ = MODELS[name]
    return jax.jit(lambda v, x: m.apply(v, x, train=False)[_key(name)])


def jax_logits(name, v, x):
    return np.asarray(_jax_logits_fn(name)(
        {"params": v["params"], "batch_stats": v["batch_stats"]},
        jnp.asarray(x)))


def port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))[_key(model.NAME)].numpy()


def clouds(seed, n=N):
    return np.random.default_rng(seed).standard_normal(
        (B, n, 3)).astype(np.float32)


def _reference_tied(v):
    """DGCNNSeg variables with each double edge block's second maps tied,
    w_center1 = w_diff1, as the reference's one conv V has them (and as
    JAX imports every reference file): the export's solve is then exact
    and its conv pairs keep the weights' scale. Untied random maps make
    the pseudo-inverse of w_diff1 scale W_c ~50-fold (entries ~70), and
    the two packages' float32 rounding with it (2.5e-3 of logits ~3.6)."""
    v = jax.tree_util.tree_map(lambda a: a, v)
    for blk in ("LinearEdgeBlock_0", "LinearEdgeBlock_1"):
        p = v["params"][blk]
        p["w_center1"] = {**p["w_center1"], "kernel": p["w_diff1"]["kernel"]}
    return v


def _moderate(v, seed):
    """The moderate perturbation of the JAX package's own export tests
    (`tests/test_torch_export.py::_perturb`, whose round trip holds 1e-3):
    parameters + 0.02 N(0, 1), running means 0.05 N(0, 1), variances in
    0.9..1.1."""
    rng = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.9, 1.1, a.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(
                    a.shape).astype(np.float32), v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v["batch_stats"])}


def write_reference(name, v, path, prefix=""):
    """The JAX exporter's `model.pt` of variables v."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PointTransformer's qkv biases
        sd = EXPORT[name](v)
    torch_export.save_torch_checkpoint({prefix + k: a for k, a in sd.items()},
                                       str(path))
    return sd


def jax_import(name, path, seed=0):
    """JAX's own load of `path` into freshly initialised variables."""
    init = jax.tree_util.tree_map(np.asarray, _init(name)(jax.random.key(seed)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return IMPORT[name](str(path), init)


class TestFromTorch:
    @pytest.mark.parametrize("name", REFERENCE)
    def test_reference_model_pt_gives_jax_logits(self, name, tmp_path):
        """A `model.pt` written by the JAX exporter (DGCNN's with a
        DataParallel `module.` prefix) loads through `--from_torch`; the
        port's logits equal JAX's on the same file, within 1e-4.
        PointTransformer and the Hengshuang family load non-strictly, as in
        JAX: the port's DefRec heads that the file cannot hold are named in
        a warning."""
        v = variables(name, 1)
        if name == "dgcnn_seg":
            v = _reference_tied(v)
        path = tmp_path / "model.pt"
        write_reference(name, v, path, "module." if name == "dgcnn" else "")
        model = port_model(name)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            checkpoint.load_model_weights(model, str(path), from_torch=True)
        kept = [str(w.message) for w in caught if "kept at init" in str(
            w.message)]
        assert bool(kept) == (name in ("point_transformer",
                                       "hengshuang_seg")), kept
        x = clouds(2, _n(name))
        np.testing.assert_allclose(port_logits(model, x),
                                   jax_logits(name, jax_import(name, path), x),
                                   rtol=1e-4, atol=1e-4)

    def test_point_bert_checkpoint(self, tmp_path):
        """A pretraining checkpoint, `{"base_model": {"module.transformer_q.*"
        ...}}`, goes through `strip_pretrain_prefixes` (its cls_head keys
        dropped) and loads non-strictly: the backbone as the plain file
        loads it, the head left at init and reported."""
        v = variables("point_transformer", 3)
        sd = write_reference("point_transformer", v, tmp_path / "plain.pt")
        torch.save({"base_model": {
            f"module.transformer_q.{k}": torch.from_numpy(np.array(a))
            for k, a in sd.items()} | {
            "module.transformer_q.cls_head_finetune.0.weight":
                torch.zeros(1)}}, tmp_path / "bert.pt")
        plain, bert = port_model("point_transformer"), port_model(
            "point_transformer")
        head = bert.state_dict()["cls_head_finetune.0.weight"].clone()
        checkpoint.load_model_weights(plain, str(tmp_path / "plain.pt"), True)
        with pytest.warns(UserWarning, match="cls_head_finetune"):
            checkpoint.load_model_weights(bert, str(tmp_path / "bert.pt"),
                                          True)
        got, want = bert.state_dict(), plain.state_dict()
        assert torch.equal(got["cls_head_finetune.0.weight"], head)
        for k in want:
            if not k.startswith(("cls_head_finetune", "DefRec")):
                assert torch.equal(got[k], want[k]), k

    def test_missing_keys_are_listed_by_prefix(self, tmp_path):
        """A strict family (DGCNN) missing a whole BatchNorm and a bias:
        `CheckpointMismatchError` with JAX's header and every missing key,
        grouped by module prefix; JAX refuses the same file."""
        v = variables("dgcnn", 4)
        sd = write_reference("dgcnn", v, tmp_path / "full.pt")
        gone = [k for k in sd if k.startswith("conv2.conv.1.")
                and "num_batches" not in k] + ["C.mlp3.bias"]
        torch_export.save_torch_checkpoint(
            {k: a for k, a in sd.items() if k not in gone},
            str(tmp_path / "model.pt"))
        with pytest.raises(reference_import.CheckpointMismatchError) as e:
            checkpoint.load_model_weights(port_model("dgcnn"),
                                          str(tmp_path / "model.pt"), True)
        msg = str(e.value)
        assert msg.startswith("checkpoint does not match DGCNN:\nSome model "
                              "parameters or buffers are not found in the "
                              "checkpoint:\n")
        assert "  C.mlp3.bias\n" in msg + "\n"
        assert ("  conv2.conv.1.{bias, running_mean, running_var, weight}"
                in msg)
        with pytest.raises(torch_import.CheckpointMismatchError,
                           match="not found in the checkpoint"):
            jax_import("dgcnn", tmp_path / "model.pt")

    def test_unexpected_keys_warn_and_partial_batchnorm_stays_at_init(
            self, tmp_path):
        """A non-strict family (PointTransformer): the reference's DefRec
        pyramid keys are reported as unused; a BatchNorm whose running
        variance is missing stays wholly at init (its conv loads) and is
        reported as missing."""
        v = variables("point_transformer", 5)
        sd = write_reference("point_transformer", v, tmp_path / "full.pt")
        sd = {k: a for k, a in sd.items()
              if k != "encoder.first_conv.1.running_var"}
        sd["propagation_0.mlp_convs.0.weight"] = np.zeros((2, 2), np.float32)
        torch_export.save_torch_checkpoint(sd, str(tmp_path / "model.pt"))
        model = port_model("point_transformer")
        before = {k: t.clone() for k, t in model.state_dict().items()}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            checkpoint.load_model_weights(model, str(tmp_path / "model.pt"),
                                          True)
        text = "\n".join(str(w.message) for w in caught)
        assert ("The checkpoint state_dict contains keys that are not used "
                "by the model:\n  propagation_0.mlp_convs.0.weight") in text
        assert "  encoder.first_conv.1.running_var" in text
        after = model.state_dict()
        for k in ("weight", "bias", "running_mean", "running_var"):
            key = f"encoder.first_conv.1.{k}"
            assert torch.equal(after[key], before[key]), key
        np.testing.assert_array_equal(
            after["encoder.first_conv.0.weight"].numpy(),
            sd["encoder.first_conv.0.weight"])

    def test_density_bin_mismatch_raises_as_jax(self, tmp_path):
        """The file's frozen bins (pergroup 2) against a model built with
        pergroup 3: JAX's ValueError, word for word."""
        write_reference("dgcnn", variables("dgcnn", 6), tmp_path / "model.pt")
        with pytest.raises(ValueError) as port_err:
            checkpoint.load_model_weights(port_model("dgcnn", pergroup=3.0),
                                          str(tmp_path / "model.pt"), True)
        init = jax.tree_util.tree_map(np.asarray,
                                      _init("dgcnn")(jax.random.key(0)))
        with pytest.raises(ValueError) as jax_err:
            torch_import.load_reference_dgcnn(str(tmp_path / "model.pt"),
                                              init, 3.0)
        assert str(port_err.value) == str(jax_err.value)
        assert "density bin width 2.0 != model pergroup 3.0" in str(
            port_err.value)

    @pytest.mark.parametrize("name", ["pointnet2", "vit"])
    def test_families_without_a_reference_layout_raise(self, name, tmp_path):
        torch.save({}, tmp_path / "model.pt")
        model = make_model(name, 10, device="cpu", **(
            VIT_KW if name == "vit" else {}))
        with pytest.raises(ValueError) as e:
            checkpoint.load_model_weights(model, str(tmp_path / "model.pt"),
                                          from_torch=True)
        assert str(e.value) == (
            "from_torch supports dgcnn/pointnet/dgcnn_seg/point_transformer/"
            f"hengshuang, not {name!r}")


class TestExport:
    @pytest.mark.parametrize("name", REFERENCE)
    def test_equals_the_jax_exporter_and_loads_back_into_jax(self, name,
                                                             tmp_path):
        """The port's export of JAX-converted weights equals the JAX
        exporter's state_dict key for key, within 1e-6 (DGCNNSeg's solved
        W_c plus 4 cond(D1) float32 units of its scale: a float64
        pseudo-inverse of a float32 product, rounded by LAPACK as the
        memory layout goes; PointTransformer's dropped
        q/k/v biases warned about, as JAX warns), and JAX's importer loads
        the file to the port's logits within 1e-4 (DGCNNSeg's tied second
        maps, `_reference_tied`). PointTransformer's file lacks the trained
        q/k/v biases, so it is held on its keys alone."""
        v = variables(name, 7)
        if name == "dgcnn_seg":
            v = _reference_tied(v)
        model = port_model(name)
        model.load_state_dict(jw.state_dict_from_jax(name, v))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = reference_export.export_state_dict(model)
        assert any("qkv biases" in str(w.message) for w in caught) == (
            name == "point_transformer")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = EXPORT[name](v)
        assert set(got) == set(want)
        # DGCNNSeg's W_c = pinv(D1) (C1 C0): float64 LAPACK, whose rounding
        # follows the memory layout, on a float32 product; cond(D1) scales it
        solve = {f"shared_layers.conv{i}.weight": np.linalg.cond(
            np.asarray(v["params"][f"LinearEdgeBlock_{j}"]["w_diff1"][
                "kernel"], np.float64)) for i, j in ((1, 0), (3, 1))
                 } if name == "dgcnn_seg" else {}
        for k, a in want.items():
            assert got[k].dtype == torch.from_numpy(np.asarray(a)).dtype, k
            scale = np.abs(a).max() * solve.get(k, 0.0) * 2.0 ** -22
            np.testing.assert_allclose(got[k].numpy(), a, rtol=1e-6,
                                       atol=1e-6 + scale, err_msg=k)
        path = tmp_path / "model.pt"
        reference_export.save(got, str(path))
        if name == "point_transformer":
            return
        x = clouds(8, _n(name))
        np.testing.assert_allclose(jax_logits(name, jax_import(name, path), x),
                                   port_logits(model, x), rtol=1e-4,
                                   atol=1e-4)

    def test_dgcnn_seg_round_trip_and_residual_warning(self, tmp_path):
        """Untied second maps, perturbed as JAX's own export tests perturb
        theirs (`_moderate`): port -> model.pt -> port holds the seg logits
        within JAX's round-trip 1e-3; a rank-deficient second diff map
        warns with the solve's residual, as JAX's exporter does."""
        v = _moderate(_init("dgcnn_seg")(jax.random.key(9)), 9)
        model = port_model("dgcnn_seg")
        model.load_state_dict(jw.state_dict_from_jax("dgcnn_seg", v))
        reference_export.save(reference_export.export_state_dict(model),
                              str(tmp_path / "model.pt"))
        back = port_model("dgcnn_seg")
        checkpoint.load_model_weights(back, str(tmp_path / "model.pt"), True)
        x = clouds(10)
        np.testing.assert_allclose(port_logits(back, x), port_logits(model, x),
                                   rtol=1e-3, atol=1e-3)
        with torch.no_grad():
            model.shared_layers.edge1.w_diff1.weight[0] = 0.0
        with pytest.warns(UserWarning, match="rank-deficient; export "
                                             "residual"):
            reference_export.export_state_dict(model)

    def test_refusals(self, tmp_path):
        """JAX's task/model check and family table: a segmenter under
        `--task pointda`, PointNet++ and vit raise ValueError."""
        base = dict(synthetic=True, device="cpu", out_path=str(tmp_path),
                    model_file=str(tmp_path / "none.ckpt"))
        with pytest.raises(ValueError, match="does not belong to task"):
            evaluation.run_export(EvalConfig(model="dgcnn_seg", **base))
        with pytest.raises(ValueError, match="does not belong to task"):
            evaluation.run_export(EvalConfig(model="pointnet",
                                             task="pointsegda", **base))
        for name in ("pointnet2", "vit"):
            with pytest.raises(ValueError, match="export supports"):
                evaluation.run_export(EvalConfig(model=name, **base))
            with pytest.raises(ValueError, match="export supports"):
                reference_export.export_state_dict(make_model(
                    name, 10, device="cpu",
                    **(VIT_KW if name == "vit" else {})))

    def test_cli_export_then_from_torch_equals_the_ckpt(self, tmp_path):
        """`export` of a port checkpoint, then `infer --from_torch True`
        on the `model.pt`: the same probabilities as `infer` of the
        checkpoint, bit for bit (the same tensors through the same
        path); and `export --from_torch True` normalises a `model.pt`."""
        model = port_model("dgcnn")
        model.load_state_dict(jw.state_dict_from_jax("dgcnn",
                                                     variables("dgcnn", 11)))
        ckpt = str(tmp_path / "model.ckpt")
        checkpoint.save_train_state(ckpt, model)
        common = ["--synthetic", "True", "--device", "cpu", "--num_points",
                  "32", "--test_batch_size", "40", "--out_path",
                  str(tmp_path)]
        assert cli.main(["export", "--model_file", ckpt, "--exp_name", "x",
                         *common]) == 0
        pt = str(tmp_path / "x" / "model.pt")
        assert cli.main(["export", "--model_file", pt, "--from_torch", "True",
                         "--output", str(tmp_path / "again.pt"), *common]) == 0
        a, b = torch.load(pt), torch.load(tmp_path / "again.pt")
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        probs = []
        for argv in (["--model_file", ckpt], ["--model_file", pt,
                                               "--from_torch", "True"]):
            out = str(tmp_path / f"p{len(probs)}.npz")
            assert cli.main(["infer", *argv, "--output", out, *common]) == 0
            probs.append(np.load(out)["prob"])
        np.testing.assert_array_equal(probs[0], probs[1])


def _flax_tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _flax_tree_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _flax_tree_equal(a, b, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


class TestJaxCkpt:
    @pytest.mark.parametrize("name", list(MODELS))
    def test_loads_for_every_family(self, name, tmp_path):
        """A `save_train_state` file (params, batch stats, Adam state,
        step, epoch, metrics) loads through `load_model_weights` into the
        port's state_dict of the same variables, bit for bit; for DGCNN,
        DGCNNSeg, PointTransformer, Hengshuang and ViT the decoded document
        also equals flax's own `msgpack_restore`, leaf for leaf."""
        m, _, heads, _ = MODELS[name]
        state = create_train_state(m, jax.random.key(0),
                                   jnp.zeros((1, _n(name), 3)), heads=heads)
        v = variables(name, 12)
        state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
        path = str(tmp_path / "model.ckpt")
        jcheckpoint.save_train_state(path, state, 3, {"acc": 0.5})
        model = port_model(name)
        checkpoint.load_model_weights(model, path)
        want = jw.state_dict_from_jax(canonical(name), v,
                                      model.config.get("pergroup"))
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        if name in ("dgcnn", "dgcnn_seg", "point_transformer", "hengshuang",
                    "vit_relative"):
            with open(path, "rb") as f:
                data = f.read()
            _flax_tree_equal(serialization.msgpack_restore(data),
                             jax_checkpoint.decode(data))
        with pytest.raises(ValueError, match="optax"):
            checkpoint.load_train_state(path, model)

    def test_decoder_covers_the_msgpack_subset(self, monkeypatch):
        """bfloat16 (widened from its uint16 bits), numpy scalars, int and
        str keys, nil/bools/ints/floats of every width, bin, complex, and
        16/32-bit lengths of str, bin, arrays, maps and ext; and flax's
        chunked arrays (`MAX_CHUNK_SIZE` cut so that one array chunks)."""
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
        tree = {"bf16": jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16),
                "big": np.arange(20000, dtype=np.float32).reshape(100, 200),
                "scal": np.float32(3.5), "i64": np.int64(-7),
                "ints": [0, 127, 128, 255, 65535, 2 ** 31, 2 ** 40, -1, -33,
                         -200, -40000, -(2 ** 40)],
                "floats": [1.25, -0.0], "none": None, "bools": [True, False],
                "str16": "s" * 300, "bin": b"\x00\x01", "c": 1 + 2j,
                "map16": {str(i): i for i in range(20)},
                "arr16": list(range(20)), 7: "int key"}
        data = serialization.to_bytes(tree)
        got = jax_checkpoint.decode(data)
        want = serialization.msgpack_restore(data)
        np.testing.assert_array_equal(
            got["bf16"], np.asarray(want["bf16"]).astype(np.float32))
        assert got["bf16"].dtype == np.float32
        assert got["big"].shape == (100, 200)
        del want["bf16"], got["bf16"]
        _flax_tree_equal(want, got)

    def test_truncated_or_foreign_file_raises_naming_it(self, tmp_path):
        v = variables("dgcnn", 13)
        state = create_train_state(MODELS["dgcnn"][0], jax.random.key(0),
                                   jnp.zeros((1, N, 3)), heads=DGCNN_HEADS)
        state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
        path = tmp_path / "model.ckpt"
        jcheckpoint.save_train_state(str(path), state)
        data = path.read_bytes()
        cut = tmp_path / "cut.ckpt"
        for bad in (data[:len(data) // 2], data + b"\x00", b"\xc1",
                    serialization.to_bytes({"a": np.zeros(2)})):
            cut.write_bytes(bad)
            with pytest.raises(ValueError, match="cut.ckpt"):
                checkpoint.load_model_weights(port_model("dgcnn"), str(cut))
        with pytest.raises(ValueError, match="model.ckpt.*PointNet"):
            checkpoint.load_model_weights(port_model("pointnet"), str(path))
