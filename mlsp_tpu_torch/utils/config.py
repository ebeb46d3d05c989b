"""PointDA experiment configuration (a copy of `PointDAConfig` from
`mlsp_tpu/utils/config.py`, whose module the port may not import).

Field names and defaults mirror the reference's argparse surface
(`PointDA/trainer.py:44-99`) plus its per-target radius table. YAML
loading and the CLI come with the trainer, and with it `resume` and
`save_every`. Left out as having no meaning here: `edge_impl` (the port
has one EdgeConv core), `compute_dtype`/`gather_dtype` (the port runs in
float32 but for the heads), `scan_steps` (a TPU dispatch amortisation)
and `debug_aux` (`train.steps.pointda_losses` takes the draws as inputs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Per-target density radius (trainer.py:103-111).
POINTDA_RADIUS = {"shapenet": 0.12, "modelnet": 0.13, "scannet": 0.135}


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
    head_dtype: str = "bf16"  # the per-point heads; "f32" for full float32
    # Test-only: forwards use the running BN statistics (eval-mode BN, no
    # statistics update), as the JAX package's `debug_bn_eval`.
    debug_bn_eval: bool = False
    synthetic: bool = False

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
