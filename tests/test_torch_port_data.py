"""The port's config, YAML and CLI merge, PointDA loaders, preprocessing,
batch order and metrics, held against the JAX package on the CPU: the
same inputs, made with numpy from a seed, must give equal results."""

import argparse
import dataclasses
import os
import pathlib

import numpy as np
import pytest

from mlsp_tpu import cli as jcli
from mlsp_tpu.data import pipeline as jpipeline
from mlsp_tpu.data.pointda import load_pointda as jax_load_pointda
from mlsp_tpu.utils import average_meter as javg
from mlsp_tpu.utils import config as jconfig
from mlsp_tpu.utils import metrics as jmetrics
from mlsp_tpu_torch import cli
from mlsp_tpu_torch.data import pipeline
from mlsp_tpu_torch.data.pointda import (
    idx_to_label,
    label_to_idx,
    load_pointda,
)
from mlsp_tpu_torch.train.pointda_trainer import epoch_pairs
from mlsp_tpu_torch.utils import config, metrics
from mlsp_tpu_torch.utils.average_meter import MeterDict

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(ROOT)) for p in
               [*ROOT.glob("configs/pointda*.yaml"),
                *ROOT.glob("configs/pointda/*.yaml")])
# The port's own fields: where the device runs (the JAX package has none).
PORT_ONLY = {"device", "transformer_dim"}


def _shared(port_cfg, jax_cfg) -> tuple[dict, dict]:
    p = dataclasses.asdict(port_cfg)
    j = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    names = set(p) & set(j)
    return {k: p[k] for k in names}, {k: j[k] for k in names}


class TestConfig:
    def test_fields_are_the_jax_fields_but_the_left_out(self):
        for port_cls, jax_cls, left_out in (
                (config.PointDAConfig, jconfig.PointDAConfig, {"debug_aux"}),
                (config.EvalConfig, jconfig.EvalConfig, set())):
            p = {f.name: f.default for f in dataclasses.fields(port_cls)}
            j = {f.name: f.default for f in dataclasses.fields(jax_cls)}
            assert set(j) - set(p) == left_out
            assert set(p) - set(j) == PORT_ONLY
            assert {k: p[k] for k in j if k in p} == {
                k: j[k] for k in j if k in p}

    @pytest.mark.parametrize("path", YAMLS)
    def test_yaml_loads_to_the_same_values(self, path):
        got = config.load_yaml(config.PointDAConfig, str(ROOT / path))
        want = jconfig.load_yaml(jconfig.PointDAConfig, str(ROOT / path))
        assert config.load_yaml_dict(str(ROOT / path)) == \
            jconfig.load_yaml_dict(str(ROOT / path))
        g, w = _shared(got, want)
        assert g == w
        g, w = _shared(got.paper_recipe, want.paper_recipe)
        assert g == w

    @pytest.mark.parametrize("d", [
        {"epochs": 3}, {"nope": 1}, {"debug_bn_eval": True},
        {"debug_aux": True}, {"scan_steps": 4}, {"edge_impl": "moments"},
        {"lr": 0.01, "debug_x": 1}])
    def test_from_dict_rejects_the_same_keys(self, d):
        """`debug_aux`, which the port left out on purpose, is an unknown
        key to it; the rest, `scan_steps` and `edge_impl` among them, load
        as JAX's do."""
        port_only_unknown = {"debug_aux"}
        try:
            want = jconfig.from_dict(jconfig.PointDAConfig, d)
        except (ValueError, TypeError) as e:
            want = e
        if isinstance(want, Exception) or set(d) & port_only_unknown:
            with pytest.raises(ValueError, match="unknown|test-only"):
                config.from_dict(config.PointDAConfig, d)
        else:
            g, w = _shared(config.from_dict(config.PointDAConfig, d), want)
            assert g == w

    def test_eval_config_resolved(self):
        for kw in ({}, {"task": "pointsegda"},
                   {"task": "pointsegda", "num_points": 1024}):
            g, w = _shared(config.EvalConfig(**kw).resolved(),
                           jconfig.EvalConfig(**kw).resolved())
            assert g == w

    @pytest.mark.parametrize("recipe", [
        {}, {"Density_normal_viainput": True, "Normal_ondef": True,
             "Density_ondef": True},
        {"Scan_on_trgt": True, "Norm_on_trgt": True},
        {"Density_normal_viachamfer": True, "model": "pointnet"},
        {"DefRec_on_src": True, "model": "hengshuang"}])
    def test_heads(self, recipe):
        got = config.PointDAConfig(**recipe)
        want = jconfig.PointDAConfig(**recipe)
        assert config.trained_heads(got) == jconfig.trained_heads(want)
        assert config.model_heads(got.model) == jconfig.model_heads(want.model)
        try:
            w = jconfig.validate_heads(want)
        except ValueError:
            with pytest.raises(ValueError, match="head"):
                config.validate_heads(got)
        else:
            assert config.validate_heads(got) == w

    @pytest.mark.parametrize("path", ["configs/pointda/modelnet2scannet.yaml",
                                      "configs/pointda_base.yaml"])
    def test_cli_merge_equals_the_jax_cli(self, path):
        """defaults < YAML < flags, as `mlsp_tpu.cli._to_config` merges."""
        argv = ["--config", str(ROOT / path), "--epochs", "3",
                "--apply_PCM", "no", "--lr", "0.01"]
        jparser = argparse.ArgumentParser()
        jcli._add_config_args(jparser, jconfig.PointDAConfig)
        want = jcli._to_config(jconfig.PointDAConfig, jparser.parse_args(argv))
        args = cli.build_parser().parse_args(["trainer", *argv])
        got = cli._to_config(config.PointDAConfig, args)
        g, w = _shared(got, want)
        assert g == w and got.epochs == 3 and not got.apply_PCM

    def test_cli_flags_are_the_jax_flags(self):
        """Every field but debug_* is a flag, of the same type."""
        jparser = argparse.ArgumentParser()
        jcli._add_config_args(jparser, jconfig.EvalConfig)
        args = cli.build_parser().parse_args(
            ["eval", "--from_torch", "yes", "--num_points", "64",
             "--pergroup", "3", "--device", "cpu"])
        got = cli._to_config(config.EvalConfig, args)
        want = jcli._to_config(jconfig.EvalConfig, jparser.parse_args(
            ["--from_torch", "yes", "--num_points", "64", "--pergroup", "3"]))
        g, w = _shared(got, want)
        assert g == w and got.device == "cpu"
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["trainer", "--debug_bn_eval", "1"])


def _tree(root, name, sizes, rng, classes=("chair", "plant", "lamp")):
    """A PointDA .npy tree with clouds of the given raw sizes."""
    for c, cls in enumerate(classes):
        d = os.path.join(root, "PointDA_data", name, cls, "train")
        os.makedirs(d, exist_ok=True)
        for i, n in enumerate(sizes):
            np.save(os.path.join(d, f"{cls}_{i:04d}.npy"),
                    rng.standard_normal((n + 7 * c, 3)).astype(np.float32) * 2)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.label, want.label)
    for a, b in ((got.train_ind, want.train_ind), (got.val_ind, want.val_ind)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


class TestLoaders:
    @pytest.mark.parametrize("name", ["modelnet", "shapenet", "scannet"])
    @pytest.mark.parametrize("partition", ["train", "test"])
    def test_synthetic(self, tmp_path, name, partition):
        got = load_pointda(name, str(tmp_path), partition, 64, True, 3,
                           device="cpu")
        want = jax_load_pointda(name, str(tmp_path), partition, 64, True, 3)
        _assert_same(got, want)
        assert len(got) == (320 if partition == "train" else 80)

    @pytest.mark.parametrize("name", ["modelnet", "shapenet"])
    def test_npy_tree(self, tmp_path, monkeypatch, name):
        """Ragged raw sizes (some below num_points, tiled; some above, FPS
        in buckets of 64, 128 and 256 points); the JAX package on its numpy
        route."""
        monkeypatch.setenv("MLSP_NATIVE_INGEST", "0")
        _tree(str(tmp_path), name, (20, 64, 65, 100, 129, 200, 250, 50, 90,
                                    33, 170), np.random.default_rng(1))
        got = load_pointda(name, str(tmp_path), "train", 64, device="cpu")
        want = jax_load_pointda(name, str(tmp_path), "train", 64)
        _assert_same(got, want)
        assert len(got) == 33 and got.train_ind.shape == (27,)

    def test_shapenet_plant_is_not_rotated(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MLSP_NATIVE_INGEST", "0")
        base = np.random.default_rng(2).standard_normal((96, 3))
        for cls in ("chair", "plant"):
            d = tmp_path / "PointDA_data" / "shapenet" / cls / "train"
            d.mkdir(parents=True)
            np.save(d / "a.npy", base.astype(np.float32))
        got = load_pointda("shapenet", str(tmp_path), "train", 96,
                           device="cpu")
        _assert_same(got, jax_load_pointda("shapenet", str(tmp_path),
                                           "train", 96))
        chair, plant = (got.data[list(got.label).index(label_to_idx[c])]
                        for c in ("chair", "plant"))
        assert np.abs(chair - plant).max() > 0.1  # only the chair turned
        np.testing.assert_array_equal(chair[:, 0], plant[:, 0])

    def test_scannet_h5(self, tmp_path):
        h5py = pytest.importorskip("h5py")
        rng = np.random.default_rng(3)
        d = tmp_path / "PointDA_data" / "scannet"
        d.mkdir(parents=True)
        for part, m, n in (("train", 12, 100), ("test", 5, 64)):
            for j in range(2):
                with h5py.File(d / f"{part}_{j}.h5", "w") as f:
                    f["data"] = rng.standard_normal((m, n, 6)).astype(
                        np.float32)
                    f["label"] = rng.integers(0, 10, (m, 1))
        for part in ("train", "test"):
            got = load_pointda("scannet", str(tmp_path), part, 64,
                               device="cpu")
            _assert_same(got, jax_load_pointda("scannet", str(tmp_path),
                                               part, 64))
            assert got.data.shape == ((24 if part == "train" else 10), 64, 3)

    def test_missing_raises_without_fallback(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_pointda("modelnet", str(tmp_path), "train", device="cpu")
        with pytest.raises(ValueError, match="unknown PointDA domain"):
            load_pointda("kitti", str(tmp_path), "train", device="cpu")

    def test_label_tables(self):
        from mlsp_tpu.data import idx_to_label as j_idx, label_to_idx as j_lab

        assert label_to_idx == j_lab and idx_to_label == j_idx


class TestPipeline:
    def test_standardize_clouds_ragged_bitwise(self):
        rng = np.random.default_rng(4)
        sizes = (40, 100, 64, 300, 129, 1000, 65, 256, 257, 7)
        clouds = [rng.standard_normal((n, 3 + n % 4)).astype(np.float32) * 3
                  for n in sizes]
        mask = np.arange(len(sizes)) % 3 != 0
        for kw in ({}, {"rotate_axis": "x", "rotate_angle": -np.pi / 2,
                        "rotate_mask": mask},
                   {"rotate_axis": "z", "rotate_angle": 0.3}):
            got = pipeline.standardize_clouds(clouds, 64, device="cpu", **kw)
            want = jpipeline.standardize_clouds(clouds, 64, **kw)
            np.testing.assert_array_equal(got, want)

    def test_needs_a_device_only_for_fps(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        small = [np.ones((10, 3), np.float32)]
        assert pipeline.standardize_clouds(small, 16).shape == (1, 16, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.standardize_clouds([np.ones((20, 3), np.float32)], 16)

    @pytest.mark.parametrize("epoch", [0, 1, 5])
    def test_epoch_batch_order_equals_the_jax_trainer(self, epoch):
        """The JAX trainer's two `batches` iterators on one
        `SeedSequence((seed, epoch))` generator, zipped."""
        src = jax_load_pointda("shapenet", ".", "train", 16, True, 1)
        trgt = jpipeline.Dataset(src.data[:250], src.label[:250]).split(2)
        erng = np.random.default_rng(np.random.SeedSequence((1, epoch)))
        want = list(zip(
            jpipeline.batches(src.data, src.label, 8,
                              indices=src.train_ind, shuffle=True,
                              drop_last=True, rng=erng),
            jpipeline.batches(trgt.data, trgt.label, 8,
                              indices=trgt.train_ind, shuffle=True,
                              drop_last=True, rng=erng)))
        got = epoch_pairs(src, trgt, 8, 1, epoch)
        assert len(got) == len(want) == 200 // 8
        for (s, t), ((sx, sy), (tx, _)) in zip(got, want):
            np.testing.assert_array_equal(src.data[s], sx)
            np.testing.assert_array_equal(src.label[s], sy)
            np.testing.assert_array_equal(trgt.data[t], tx)

    def test_batches_pad_and_count(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((21, 4, 3)).astype(np.float32)
        y = np.arange(21)
        for kw in ({}, {"drop_last": True},
                   {"indices": rng.permutation(21)[:13]},
                   {"shuffle": True, "rng": np.random.default_rng(0)}):
            kj = {**kw, "rng": np.random.default_rng(0)} if "rng" in kw else kw
            for (a, b), (c, d) in zip(pipeline.batches(x, y, 5, **kw),
                                      jpipeline.batches(x, y, 5, **kj)):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
        for n, drop in ((21, True), (21, False), (20, False)):
            assert pipeline.num_batches(n, 5, drop) == \
                jpipeline.num_batches(n, 5, drop)
        for got, want in zip(pipeline.pad_batch(x[:3], y[:3], 8),
                             jpipeline.pad_batch(x[:3], y[:3], 8)):
            np.testing.assert_array_equal(got, want)


class TestMetrics:
    def test_equal_to_the_jax_metrics(self):
        rng = np.random.default_rng(6)
        logits = rng.standard_normal((50, 10)).astype(np.float32) * 4
        y = rng.integers(0, 10, 50)
        y[y == 3] = 4  # a class absent from y_true
        p = logits.argmax(-1)
        np.testing.assert_array_equal(metrics.log_softmax_np(logits),
                                      jmetrics.log_softmax_np(logits))
        np.testing.assert_array_equal(metrics.softmax_np(logits),
                                      jmetrics.softmax_np(logits))
        assert metrics.accuracy(y, p) == jmetrics.accuracy(y, p)
        assert metrics.balanced_accuracy(y, p) == \
            jmetrics.balanced_accuracy(y, p)
        np.testing.assert_array_equal(metrics.confusion_matrix(y, p, 10),
                                      jmetrics.confusion_matrix(y, p, 10))
        assert metrics.accuracy([], []) == jmetrics.accuracy([], []) == 0.0

    def test_meter_dict(self):
        rng = np.random.default_rng(7)
        got, want = MeterDict(), javg.MeterDict()
        for i in range(9):
            m = {"a": np.float32(rng.standard_normal()),
                 "b": rng.standard_normal(3).astype(np.float32)}
            got.update(m, n=1 + i % 4)
            want.update(m, n=1 + i % 4)
        assert got.averages() == want.averages()
        assert "a" in got and got["a"].val == want["a"].val
