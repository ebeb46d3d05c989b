"""Point-cloud ops: pairwise distances, the kNN graph and EdgeConv
neighbourhood statistics, each kernel beside its plain PyTorch version."""

from mlsp_tpu_torch.ops.edge import edge_moments
from mlsp_tpu_torch.ops.knn import edge_features, knn_gather, knn_indices
from mlsp_tpu_torch.ops.pairwise import pairwise_sqdist, self_sqdist

__all__ = ["edge_moments", "edge_features", "knn_gather", "knn_indices",
           "pairwise_sqdist", "self_sqdist"]
