"""mlsp_tpu_torch: the PyTorch/CUDA port of `mlsp_tpu`, for NVIDIA Hopper.

It sits beside the JAX package, keeps its layout and names, and imports
nothing of it (nor JAX): the parity tests hold each module against its
JAX counterpart. Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel (`csrc/`, built with nvcc at first use) with a
plain PyTorch version beside it, used for CPU tensors and as the reference.

Subpackages
-----------
ops         pairwise distances, the kNN graph (self and cross-set), ball
            query and grouping, EdgeConv neighbourhood statistics, FPS,
            normals, density labels, masked Chamfer;
            `ops.kernels` wraps the CUDA kernels
models      DGCNN and DGCNNSeg with the MLSP heads, PointNet, PointNet++,
            PointTransformer, the Hengshuang classifier and segmenter,
            Point-ViT (reference state_dict layouts where one exists)
transforms  augmentation and DefRec deformation (draw, then apply)
losses      the MLSP losses
train       the PointDA paper-recipe train step, Adam + cosine schedule
serving     serving bundles: save, load, predict
utils       device resolution, configs, checkpoints: the port's, the JAX
            package's `.ckpt` in, reference `model.pt` in and out
data        synthetic clouds

Entry points run on the CUDA card unless given device="cpu".
"""

from mlsp_tpu_torch.models import make_model
from mlsp_tpu_torch.serving import (
    ServingModel,
    load_serving_bundle,
    save_serving_bundle,
)

__version__ = "0.1.0"
__all__ = ["make_model", "ServingModel", "load_serving_bundle",
           "save_serving_bundle"]
