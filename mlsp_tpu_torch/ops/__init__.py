"""Point-cloud ops: pairwise distances, the kNN graph, ball query and
grouping, EdgeConv neighbourhood statistics, FPS, normals, density labels,
the masked Chamfer distance and its nearest-index transport, each kernel
beside its plain PyTorch version."""

from mlsp_tpu_torch.ops.chamfer import (
    masked_chamfer,
    nearest_index_pair,
    reconstruction_loss,
)
from mlsp_tpu_torch.ops.density import density_labels, radius_count
from mlsp_tpu_torch.ops.edge import edge_moments
from mlsp_tpu_torch.ops.fps import fps, fps_gather
from mlsp_tpu_torch.ops.grouping import ball_query, group_points
from mlsp_tpu_torch.ops.knn import edge_features, knn_gather, knn_indices
from mlsp_tpu_torch.ops.normals import estimate_normals
from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist, self_sqdist

__all__ = ["ball_query", "density_labels", "edge_features", "edge_moments",
           "estimate_normals", "fps", "fps_gather", "group_points", "knn_gather",
           "knn_indices", "masked_chamfer", "nearest_index_pair",
           "pairwise_sqdist", "radius_count", "reconstruction_loss",
           "self_sqdist"]
