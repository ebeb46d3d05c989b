"""Experiment configuration: copies of `PointDAConfig`, `SPSTConfig`,
`PointSegDAConfig` and `EvalConfig` from `mlsp_tpu/utils/config.py` (whose
module the port may not import), the head tables and the YAML/CLI funnel.

Field names and defaults mirror the reference's argparse surfaces
(`PointDA/trainer.py:44-99`, `train_spst.py:56-100`,
`PointSegDA/trainer.py:93-135`) plus their per-target radius tables.
`scan_steps` keeps JAX's defaults (16, 8, 8; 1 = single steps): the
trainers take an epoch as chunks of that many steps, then the remaining
steps as one shorter chunk, each chunk on the card as that many replays
of one captured CUDA graph of the step (`train.graphs`; at 1, one replay
a step, the counterpart of JAX's jitted single step); on the CPU a chunk
runs its steps eagerly. The precision and EdgeConv knobs keep JAX's names, defaults and
models (`models.model_kwargs`): `compute_dtype` ("f32" | "bf16": the
DGCNN trunk, or with the seg trainer DGCNNSeg's edge blocks, in bf16 with
float32 parameters and BatchNorm), `head_dtype`, `gather_dtype` ("" |
"f32" | "bf16": the neighbour gather of the "moments" EdgeConv route) and
`edge_impl` ("auto" | "fused" | "moments" | "direct", DGCNN's EdgeConv
route per layer). JAX reads any other dtype string as float32 and any
other `edge_impl` as "direct"; the port's models raise for them. Left
out: `debug_aux` (`pointda_losses` and `pointsegda_losses` take the draws
as inputs), refused as an unknown key. Added: `device`, where the entry
points run ("" is the CUDA card, which they require unless given
"cpu"), and, in `PointDAConfig` and `EvalConfig`, `transformer_dim`,
the Hengshuang models' `d_model` (the name of the reference's
Point-Transformers YAML; its published value is 512, the default 128
keeps the JAX package's width).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

# Per-target density radius (trainer.py:103-111, seg trainer:139-150).
POINTDA_RADIUS = {"shapenet": 0.12, "modelnet": 0.13, "scannet": 0.135}
POINTSEGDA_RADIUS = {"adobe": 0.0872, "faust": 0.091, "mit": 0.124,
                     "scape": 0.115}


@dataclass(frozen=True)
class PointDAConfig:
    """PointDA-10 classification DA experiment."""

    exp_name: str = "MLSP"
    out_path: str = "./experiments"
    dataroot: str = "./data"
    src_dataset: str = "shapenet"
    trgt_dataset: str = "scannet"
    epochs: int = 150
    model: str = "dgcnn"
    seed: int = 1
    num_class: int = 10
    num_points: int = 1024

    batch_size: int = 32
    test_batch_size: int = 32
    optimizer: str = "ADAM"
    lr: float = 1e-3
    momentum: float = 0.9
    wd: float = 5e-5
    dropout: float = 0.5
    transformer_dim: int = 128  # hengshuang's d_model (models.model_kwargs)

    # SSL recipe flags (reference defaults; `paper_recipe` turns on
    # Density_normal_viainput + Normal_ondef + Density_ondef).
    DefRec_dist: str = "volume_based_voxels"
    num_regions: int = 3
    DefRec_on_src: bool = False
    DefRec_on_trgt: bool = False
    DefRec_weight: float = 0.5
    apply_PCM: bool = True
    mixup_params: float = 1.0
    Norm_on_trgt: bool = False
    normal_pred_weight: float = 0.5
    Scan_on_trgt: bool = False
    Scan_Rec_weight: float = 0.5
    Density_on_trgt: bool = False
    Density_weight: float = 0.05
    density_num_class: int = 16
    pergroup: float = 2.0
    radius: float = 0.1
    Density_normal_viainput: bool = False
    Density_normal_viachamfer: bool = False
    Density_normal_defpart: bool = False
    Density_ondef: bool = False
    Normal_ondef: bool = False
    Density_normal_viainput_onsrc: bool = False
    near: int = 20  # normal-estimation k

    # inline pseudo-labelling
    apply_SPL: bool = False
    gamma: float = 0.1
    apply_SPL_v2: bool = False
    gamma_v2: float = 1.6366

    # runtime: "auto" runs the kernels for CUDA tensors, "torch" the plain
    # versions anywhere (the comparison path)
    knn_backend: str = "auto"
    edge_impl: str = "auto"  # DGCNN's EdgeConv route (models/dgcnn.py)
    compute_dtype: str = "f32"  # "bf16": the DGCNN trunk in bf16
    head_dtype: str = "bf16"  # the per-point heads; "f32" for full float32
    gather_dtype: str = ""  # "bf16": round the "moments" route's gather
    scan_steps: int = 16  # train steps a chunk of graph replays (1: single)
    # Test-only: forwards use the running BN statistics (eval-mode BN, no
    # statistics update), as the JAX package's `debug_bn_eval`.
    debug_bn_eval: bool = False
    resume: str = ""  # checkpoint to resume from (weights, optimizer, epoch)
    save_every: int = 0  # also write last.ckpt every N epochs (0 = off)
    synthetic: bool = False
    device: str = ""  # "" = the CUDA card; "cpu" to run on the CPU

    def resolved(self) -> "PointDAConfig":
        """Apply the per-target radius table (trainer.py:103-111)."""
        r = POINTDA_RADIUS.get(self.trgt_dataset, self.radius)
        return dataclasses.replace(self, radius=r, density_num_class=16)

    @property
    def paper_recipe(self) -> "PointDAConfig":
        """The train.sh headline configuration."""
        return dataclasses.replace(
            self.resolved(),
            Density_normal_viainput=True,
            Normal_ondef=True,
            Density_ondef=True,
            DefRec_weight=0.5,
            Density_weight=0.05,
        )


@dataclass(frozen=True)
class SPSTConfig:
    """Self-paced self-training stage (`train_spst.py:56-100`): fine-tune a
    pretrained PointDA model on confidently pseudo-labelled target clouds.

    `model_file` is a checkpoint of the port or a JAX `.ckpt`
    (`utils.checkpoint`), or with `from_torch` a reference torch
    `model.pt`."""

    exp_name: str = "SPST"
    out_path: str = "./experiments"
    dataroot: str = "./data"
    src_dataset: str = "shapenet"
    trgt_dataset: str = "scannet"
    model: str = "dgcnn"
    model_file: str = "./experiments/MLSP/model.ckpt"
    from_torch: bool = False  # model_file is a reference torch model.pt
    seed: int = 1
    num_class: int = 10
    num_points: int = 1024
    batch_size: int = 32
    test_batch_size: int = 32
    optimizer: str = "ADAM"
    lr: float = 1e-4
    momentum: float = 0.9
    wd: float = 5e-5
    dropout: float = 0.5
    apply_PCM: bool = False  # reference train_spst.py:78 default
    mixup_params: float = 1.0
    DefRec_weight: float = 0.5
    epochs: int = 10
    rounds: int = 5
    threshold: float = 1.5492  # entropy threshold (v2 selection)
    use_entropy_selection: bool = True  # select_target_by_conf_v2
    spl_weight: float = 1.0
    cls_weight: float = 1.0
    weight_decay_per_epoch: float = 5e-3  # train_spst.py:499-500
    density_num_class: int = 16
    pergroup: float = 2.0
    knn_backend: str = "auto"
    edge_impl: str = "auto"  # see PointDAConfig
    compute_dtype: str = "f32"
    head_dtype: str = "bf16"  # see PointDAConfig
    gather_dtype: str = ""
    scan_steps: int = 8  # see PointDAConfig
    synthetic: bool = False
    device: str = ""  # "" = the CUDA card; "cpu" to run on the CPU


@dataclass(frozen=True)
class PointSegDAConfig:
    """PointSegDA segmentation DA (`PointSegDA/trainer.py:93-135`)."""

    exp_name: str = "DefRec_PCM"
    out_path: str = "./experiments"
    dataroot: str = "./data/PointSegDAdataset"
    src_dataset: str = "adobe"
    trgt_dataset: str = "faust"
    model: str = "dgcnn_seg"  # "dgcnn_seg" | "hengshuang_seg"
    epochs: int = 200
    seed: int = 1
    num_class: int = 8
    num_points: int = 2048
    batch_size: int = 16
    test_batch_size: int = 32
    optimizer: str = "ADAM"
    lr: float = 1e-3
    momentum: float = 0.9
    wd: float = 5e-5
    dropout: float = 0.5

    DefRec_dist: str = "volume_based_voxels"
    num_regions: int = 3
    # Read by nothing, as in the reference (`mlsp.deform_input` fixes
    # min_pts at 40, `transforms.deform`): kept for the flag surface.
    min_pts: int = 20
    apply_PCM: bool = False
    mixup_params: float = 1.0
    DefRec_weight: float = 0.02
    DefRec_on_trgt: bool = True
    Norm_on_trgt: bool = False
    normal_pred_weight: float = 0.02
    Density_on_trgt: bool = False
    Density_weight: float = 0.02
    density_num_class: int = 16
    pergroup: float = 5.0
    Density_normal_viainput: bool = False
    Density_normal_viachamfer: bool = False  # read by no seg branch
    Density_normal_defpart: bool = False
    Density_ondef: bool = False
    Normal_ondef: bool = False
    near: int = 10
    shift: int = 10
    density_radius: float = 0.081
    knn_backend: str = "auto"
    compute_dtype: str = "f32"  # "bf16": DGCNNSeg's edge blocks and conv6
    scan_steps: int = 8  # see PointDAConfig
    synthetic: bool = False
    device: str = ""  # "" = the CUDA card; "cpu" to run on the CPU

    def resolved(self) -> "PointSegDAConfig":
        """Apply the per-target radius table (trainer.py:139-150)."""
        r = POINTSEGDA_RADIUS.get(self.trgt_dataset, self.density_radius)
        return dataclasses.replace(self, density_radius=r,
                                   density_num_class=16)


@dataclass(frozen=True)
class EvalConfig:
    """Standalone checkpoint evaluation, batch inference and export
    (`eval`, `infer`, `export`, `aot`). The port serves `task="pointda"` with
    every PointDA family and `task="pointsegda"` with `dgcnn_seg` and
    `hengshuang_seg`."""

    exp_name: str = "EVAL"
    out_path: str = "./experiments"
    dataroot: str = "./data"
    task: str = "pointda"  # "pointda" | "pointsegda"
    dataset: str = "scannet"
    split: str = "test"  # "train" | "val" | "test"
    model: str = "dgcnn"
    model_file: str = ""  # the port's checkpoint or a JAX .ckpt
    from_torch: bool = False  # model_file is a reference torch model.pt
    seed: int = 1
    num_class: int = 10
    num_points: int = 1024
    test_batch_size: int = 32
    dropout: float = 0.5
    transformer_dim: int = 128  # see PointDAConfig
    density_num_class: int = 16
    pergroup: float = 2.0
    knn_backend: str = "auto"
    compute_dtype: str = "f32"  # DGCNN only, as the JAX eval builds it
    head_dtype: str = ""  # "" = the heads in compute_dtype
    gather_dtype: str = ""
    synthetic: bool = False
    output: str = ""  # `infer` .npz, `export` model.pt or `aot` bundle directory
    device: str = ""  # "" = the CUDA card; "cpu" to run on the CPU

    # Fields whose PointDA defaults are wrong for the seg task, with the
    # seg trainer's values (`PointSegDA/trainer.py:124-125,196-199`).
    _SEG_DEFAULTS = {"model": "dgcnn_seg", "num_class": 8,
                     "num_points": 2048, "pergroup": 5.0, "dataset": "faust"}

    def resolved(self) -> "EvalConfig":
        """Task-conditional defaults: with `task=pointsegda`, any field
        still at its PointDA default flips to the seg trainer's value."""
        if self.task != "pointsegda":
            return self
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        repl = {k: v for k, v in self._SEG_DEFAULTS.items()
                if getattr(self, k) == defaults[k]}
        return dataclasses.replace(self, **repl)


def model_heads(model: str) -> tuple[str, ...]:
    """SSL heads a backbone provides: only DGCNN carries the normal, scan
    and density heads."""
    return (("defrec", "normal", "scan", "density") if model == "dgcnn"
            else ("defrec",))


def seg_model_heads(model: str) -> tuple[str, ...]:
    """Heads a PointSegDA backbone provides: DGCNN_DefRec all four
    (`PointSegDA/Models.py:213-242`), the hengshuang seg variant seg and
    DefRec only."""
    return (("seg", "defrec", "normal", "density") if model == "dgcnn_seg"
            else ("seg", "defrec"))


def trained_heads(cfg) -> tuple[str, ...]:
    """Heads some loss term of the recipe reads. The others keep their
    initial weights (`train.state`: their gradients stay None)."""
    combined = (cfg.Density_normal_viainput or cfg.Density_normal_viachamfer
                or cfg.Density_normal_viainput_onsrc)
    t = set()
    if cfg.DefRec_on_src or cfg.DefRec_on_trgt or combined:
        t.add("defrec")
    if cfg.Norm_on_trgt or (combined and cfg.Normal_ondef):
        t.add("normal")
    if cfg.Scan_on_trgt:
        t.add("scan")
    if cfg.Density_on_trgt or (combined and cfg.Density_ondef):
        t.add("density")
    return tuple(h for h in model_heads(cfg.model) if h in t)


def trained_seg_heads(cfg) -> tuple[str, ...]:
    """PointSegDA heads some loss term of the recipe reads (cf.
    `trained_heads`); the seg CE always trains the seg head."""
    t = {"seg"}
    if cfg.DefRec_on_trgt or cfg.Density_normal_viainput:
        t.add("defrec")
    if cfg.Norm_on_trgt or (cfg.Density_normal_viainput and cfg.Normal_ondef):
        t.add("normal")
    if cfg.Density_on_trgt or (cfg.Density_normal_viainput
                               and cfg.Density_ondef):
        t.add("density")
    return tuple(h for h in seg_model_heads(cfg.model) if h in t)


def validate_seg_heads(cfg) -> tuple[str, ...]:
    """`validate_heads` for the seg task: the backbone's heads, or a
    ValueError naming those the enabled branches need and it lacks."""
    available = seg_model_heads(cfg.model)
    needed = {"seg"}
    if cfg.DefRec_on_trgt:
        needed.add("defrec")
    if cfg.Norm_on_trgt:
        needed.add("normal")
    if cfg.Density_on_trgt:
        needed.add("density")
    # the combined branch forwards through all three heads, whatever the
    # *_ondef flags say
    if cfg.Density_normal_viainput:
        needed.update({"defrec", "normal", "density"})
    missing = needed - set(available)
    if missing:
        raise ValueError(
            f"seg model {cfg.model!r} has no {sorted(missing)} head(s) but "
            f"the config enables SSL branches that need them: use --model "
            f"dgcnn_seg or disable those flags")
    return available


def validate_heads(cfg) -> tuple[str, ...]:
    """Check the SSL branches the config enables against the heads the
    backbone provides; returns the backbone's heads. Raises ValueError
    before the first step rather than a KeyError inside it."""
    available = model_heads(cfg.model)
    needed = {"defrec"}
    if cfg.Norm_on_trgt or cfg.Normal_ondef:
        needed.add("normal")
    if cfg.Scan_on_trgt:
        needed.add("scan")
    if cfg.Density_on_trgt or cfg.Density_ondef:
        needed.add("density")
    # the combined branches forward through all three heads
    if (cfg.Density_normal_viainput or cfg.Density_normal_viachamfer
            or cfg.Density_normal_viainput_onsrc):
        needed.update({"normal", "density"})
    missing = needed - set(available)
    if missing:
        raise ValueError(
            f"model {cfg.model!r} has no {sorted(missing)} head(s) but the "
            f"config enables SSL branches that need them: use --model dgcnn "
            f"or disable those flags")
    return available


def from_dict(cls, d: dict):
    """The user-facing funnel (YAML and CLI land here). Unknown keys and
    the test-only `debug_*` fields are refused."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    debug = sorted(k for k in d if k.startswith("debug_"))
    if debug:
        raise ValueError(
            f"{debug} are test-only instrumentation fields and cannot be "
            f"set from YAML/CLI (construct {cls.__name__} directly in a "
            f"test if you need them)")
    return cls(**d)


def load_yaml_dict(path: str) -> dict:
    """A YAML file as a dict, with `_base_` inheritance: the child's keys
    override the recursively loaded base's (one level of dict merge)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base_rel = cfg.pop("_base_", None)
    if not base_rel:
        return cfg
    merged = dict(load_yaml_dict(os.path.join(os.path.dirname(path),
                                              base_rel)))
    for k, v in cfg.items():
        if isinstance(v, dict) and isinstance(merged.get(k), dict):
            merged[k] = {**merged[k], **v}
        else:
            merged[k] = v
    return merged


def load_yaml(cls, path: str):
    return from_dict(cls, load_yaml_dict(path))
