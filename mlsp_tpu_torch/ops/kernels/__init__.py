"""Hand-written CUDA kernels of the port (`csrc/*.cu`) and their wrappers.

Each wrapper launches its kernel on CUDA tensors or raises, and counts its
launches in a plain integer attribute, `<wrapper>.launches`. A launch
captured into a CUDA graph runs at every replay, where no wrapper is
called: `train.graphs` adds the captured launches to the counts at each
replay (`add_launches`). Importing this package builds nothing: the
sources are compiled at first launch.
"""

from mlsp_tpu_torch.ops.kernels.edge import (
    edge_moments_bwd_cuda,
    edge_moments_cuda,
)
from mlsp_tpu_torch.ops.kernels.fps import fps_cuda
from mlsp_tpu_torch.ops.kernels.knn import knn_cuda
from mlsp_tpu_torch.ops.kernels.normals import knn_moments_cuda

WRAPPERS = {"knn": knn_cuda, "edge_moments": edge_moments_cuda,
            "edge_moments_bwd": edge_moments_bwd_cuda,
            "knn_moments": knn_moments_cuda, "fps": fps_cuda}


# the part of each count that graph replays added (`add_launches`)
_IN_GRAPHS = dict.fromkeys(WRAPPERS, 0)


def reset_launches() -> None:
    for name, fn in WRAPPERS.items():
        fn.launches = 0
        _IN_GRAPHS[name] = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launches_in_graphs() -> dict[str, int]:
    """The launches among `launches()` that ran inside CUDA graph
    replays."""
    return dict(_IN_GRAPHS)


def set_launches(counts: dict[str, int]) -> None:
    for name, fn in WRAPPERS.items():
        fn.launches = counts[name]


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add `times` x `counts` to the counts (a graph's replays)."""
    for name, fn in WRAPPERS.items():
        fn.launches += times * counts.get(name, 0)
        _IN_GRAPHS[name] += times * counts.get(name, 0)
