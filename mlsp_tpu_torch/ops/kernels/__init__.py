"""Hand-written CUDA kernels of the port (`csrc/*.cu`) and their wrappers.

Each wrapper launches its kernel on CUDA tensors or raises, and counts its
launches in a plain integer attribute, `<wrapper>.launches`. Importing
this package builds nothing: the sources are compiled at first launch.
"""

from mlsp_tpu_torch.ops.kernels.edge import edge_moments_cuda
from mlsp_tpu_torch.ops.kernels.knn import knn_cuda

WRAPPERS = {"knn": knn_cuda, "edge_moments": edge_moments_cuda}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
