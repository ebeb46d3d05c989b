"""Command-line entry points of the port (counterpart of `mlsp_tpu/cli.py`):

    python -m mlsp_tpu_torch.cli trainer --paper_recipe True --synthetic True
    python -m mlsp_tpu_torch.cli eval --model_file experiments/MLSP/model.ckpt
    python -m mlsp_tpu_torch.cli infer --model_file experiments/MLSP/model.ckpt
    python -m mlsp_tpu_torch.cli spst --model_file experiments/MLSP/model.ckpt
    python -m mlsp_tpu_torch.cli seg --config configs/pointsegda/adobe2faust.yaml
    python -m mlsp_tpu_torch.cli eval --task pointsegda --model_file \
        experiments/MLSP_adobe2faust_adobe_faust/model.ckpt
    python -m mlsp_tpu_torch.cli export --model_file experiments/MLSP/model.ckpt
    python -m mlsp_tpu_torch.cli eval --from_torch True --model_file model.pt
    python -m mlsp_tpu_torch.cli aot --model_file experiments/MLSP/model.ckpt
    python -m mlsp_tpu_torch.cli calibrate
    python -m mlsp_tpu_torch.cli download --task pointda --dataroot ./data
    torchrun --nproc_per_node 2 -m mlsp_tpu_torch.cli trainer --mesh_data 2

Every config field but the test-only `debug_*` ones is a flag; booleans
take true/false/1/0/yes/no like the reference's str2bool. `--config FILE`
(YAML with `_base_` inheritance) composes with the flags: dataclass
defaults < YAML < flags given on the command line. The entry points run
on the CUDA card; `--device cpu` runs them on the CPU. `--model_file`
takes the port's checkpoints and the JAX package's `.ckpt` files, and with
`--from_torch True` a reference `model.pt`. `--mesh_data R` trains
data-parallel on R processes started by torchrun (NCCL between cards,
gloo with `--device cpu`; R = 1 without torchrun starts a world of one);
each rank runs on cuda:LOCAL_RANK unless `--device` says otherwise;
`--mesh_points P` splits each cloud's points over P of them. `download`
fetches a dataset with gdown and needs a network.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

# Sentinel default: the flag was not given. Not a str, which argparse
# would run through `type`.
_UNSET = object()


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _add_config_args(parser: argparse.ArgumentParser, cls) -> None:
    types = {"bool": _str2bool, "int": int, "float": float}
    for f in dataclasses.fields(cls):
        if f.name.startswith("debug_"):
            continue  # test-only instrumentation: no CLI surface
        kind = getattr(f.type, "__name__", f.type)  # a class or its name
        parser.add_argument(f"--{f.name}", default=_UNSET,
                            type=types.get(kind, str))
    parser.add_argument("--config", type=str, default="",
                        help="YAML config (with _base_ inheritance); flags "
                             "given on the command line override its values")


def _to_config(cls, args: argparse.Namespace):
    """defaults < YAML (--config) < explicit flags."""
    from mlsp_tpu_torch.utils.config import from_dict, load_yaml_dict

    names = {f.name for f in dataclasses.fields(cls)}
    merged = load_yaml_dict(args.config) if args.config else {}
    for k, v in vars(args).items():
        if k in names and v is not _UNSET:
            merged[k] = v
    return from_dict(cls, merged)


def _add_profile_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the "
                             "run into this directory (use a short "
                             "--epochs run)")


def _add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh_data", type=int, default=0,
                        help="data-parallel mesh axis size (0 = no mesh; "
                             "replaces the reference's nn.DataParallel)")
    parser.add_argument("--mesh_points", type=int, default=1,
                        help="points-sharding mesh axis size: each cloud's "
                             "O(N^2) work (kNN graphs, Chamfer, radius "
                             "counts, ball queries) split by query rows "
                             "over P ranks; with --mesh_data 0 the data "
                             "axis is WORLD_SIZE / P")


def _mesh_from_args(args: argparse.Namespace, device, batch_size: int):
    """The (data, points) mesh the flags ask for, or None. `--mesh_data D
    --mesh_points P` joins the world torchrun describes (WORLD_SIZE must
    be D x P; D = 0 takes WORLD_SIZE / P, as JAX's `data=None`) or, with
    D x P = 1 and no torchrun, starts a world of one. A `batch_size` that
    does not split over D is refused before joining."""
    from mlsp_tpu_torch import parallel

    points = args.mesh_points
    if not (args.mesh_data or points > 1):
        return None
    if points < 1 or args.mesh_data < 0:
        raise ValueError(f"--mesh_data {args.mesh_data} --mesh_points "
                         f"{points}: sizes must be positive")
    world = os.environ.get("WORLD_SIZE")
    data = args.mesh_data or (int(world) // points if world else 1)
    want = data * points
    launch = (f"launch with torchrun --nproc_per_node {want} -m "
              "mlsp_tpu_torch.cli ...")
    if world is None and want != 1:
        raise ValueError(f"--mesh_data {data} --mesh_points {points} needs "
                         f"{want} processes: {launch}")
    if world is not None and int(world) != want:
        raise ValueError(f"--mesh_data {data} x --mesh_points {points} = "
                         f"{want} but torchrun started WORLD_SIZE={world} "
                         f"processes: {launch}")
    if batch_size % data:  # the message of `parallel.replicate_for_mesh`
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"mesh data axis ({data} devices)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if world is None:
        parallel.init_local_world(backend)
    else:
        parallel.init_distributed(backend)
    if device.type == "cuda" and device.index is None:
        device = None  # cuda:LOCAL_RANK
    return parallel.make_mesh(data, points, device=device)


def build_parser() -> argparse.ArgumentParser:
    from mlsp_tpu_torch.utils.config import (
        EvalConfig,
        PointDAConfig,
        PointSegDAConfig,
        SPSTConfig,
    )

    parser = argparse.ArgumentParser(
        prog="mlsp_tpu_torch",
        description="MLSP point-cloud domain adaptation on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    p_train = sub.add_parser("trainer", help="PointDA-10 classification DA")
    _add_config_args(p_train, PointDAConfig)
    p_train.add_argument("--paper_recipe", type=_str2bool, default=False,
                         help="apply the train.sh headline flag set")
    p_spst = sub.add_parser(
        "spst", help="self-paced self-training of a pretrained PointDA model "
                     "on pseudo-labelled target clouds")
    _add_config_args(p_spst, SPSTConfig)
    p_seg = sub.add_parser("seg", help="PointSegDA segmentation DA")
    _add_config_args(p_seg, PointSegDAConfig)
    for p in (p_train, p_spst, p_seg):
        _add_mesh_args(p)
        _add_profile_arg(p)
    p_eval = sub.add_parser(
        "eval", help="evaluate a checkpoint (the port's, a JAX .ckpt, or a "
                     "reference model.pt via --from_torch) on a dataset "
                     "split")
    _add_config_args(p_eval, EvalConfig)
    p_infer = sub.add_parser(
        "infer", help="batch inference: per-cloud predictions and class "
                      "probabilities of a dataset split, to .npz")
    _add_config_args(p_infer, EvalConfig)
    p_export = sub.add_parser(
        "export", help="export a checkpoint as a reference-loadable torch "
                       "model.pt (inverse of --from_torch; dgcnn/pointnet/"
                       "dgcnn_seg/point_transformer/hengshuang)")
    _add_config_args(p_export, EvalConfig)
    p_aot = sub.add_parser(
        "aot", help="freeze a checkpoint into an AOT serving bundle "
                    "(a torch.export eval program with its weights; loads "
                    "and runs with NO model code)")
    _add_config_args(p_aot, EvalConfig)
    p_dl = sub.add_parser(
        "download", help="fetch and extract a benchmark dataset (as the "
                         "reference's download scripts; needs a network "
                         "and gdown)")
    p_dl.add_argument("--task", choices=("pointda", "pointsegda"),
                      default="pointda")
    p_dl.add_argument("--dataroot", default="./data")
    p_cal = sub.add_parser(
        "calibrate", help="time this card's EdgeConv neighbourhood "
                          "statistics, the gather route against the kernels, "
                          "over the shape grid and cache the per-shape "
                          "records")
    p_cal.add_argument("--force", action="store_true",
                       help="re-measure even if a cached record exists")
    return parser


def main(argv=None) -> int:
    from mlsp_tpu_torch.utils.config import (
        EvalConfig,
        PointDAConfig,
        PointSegDAConfig,
        SPSTConfig,
    )
    from mlsp_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.command == "download":
        from mlsp_tpu_torch.data import download

        fetch = (download.download_pointda if args.task == "pointda"
                 else download.download_pointsegda)
        print(f"dataset extracted under {fetch(args.dataroot)}")
        return 0
    if args.command == "calibrate":
        from mlsp_tpu_torch.utils import chipcal

        records = chipcal.edge_calibration(force=args.force)
        if not records:
            print("calibration unavailable (no CUDA device and no cache)")
            return 1
        print(json.dumps(records, indent=1))
        return 0
    cls = {"trainer": PointDAConfig, "spst": SPSTConfig,
           "seg": PointSegDAConfig}.get(args.command, EvalConfig)
    cfg = _to_config(cls, args)
    try:
        device = resolve_device(cfg.device or None)
    except RuntimeError as e:
        print(f"mlsp_tpu_torch: {e} (--device cpu)", file=sys.stderr)
        return 1
    mesh = (_mesh_from_args(args, device, cfg.batch_size)
            if args.command in ("trainer", "spst", "seg") else None)
    try:
        _run(args, cfg, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


def _run(args: argparse.Namespace, cfg, mesh) -> None:
    trace = contextlib.nullcontext()
    if getattr(args, "profile_dir", ""):
        from mlsp_tpu_torch.utils.profiling import device_trace

        trace = device_trace(args.profile_dir)
    if args.command == "trainer":
        from mlsp_tpu_torch.train.pointda_trainer import train_pointda

        if args.paper_recipe:
            cfg = cfg.paper_recipe
        with trace:
            train_pointda(cfg, mesh=mesh)
    elif args.command == "spst":
        from mlsp_tpu_torch.train.spst import train_spst

        with trace:
            train_spst(cfg, mesh=mesh)
    elif args.command == "seg":
        from mlsp_tpu_torch.train.pointsegda_trainer import train_pointsegda

        with trace:
            train_pointsegda(cfg, mesh=mesh)
    else:
        from mlsp_tpu_torch.train import evaluation

        {"eval": evaluation.run_eval, "infer": evaluation.run_infer,
         "export": evaluation.run_export,
         "aot": evaluation.run_aot_export}[args.command](cfg)


if __name__ == "__main__":
    sys.exit(main())
