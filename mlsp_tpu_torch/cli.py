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

Every config field but the test-only `debug_*` ones is a flag; booleans
take true/false/1/0/yes/no like the reference's str2bool. `--config FILE`
(YAML with `_base_` inheritance) composes with the flags: dataclass
defaults < YAML < flags given on the command line. The entry points run
on the CUDA card; `--device cpu` runs them on the CPU. `--model_file`
takes the port's checkpoints and the JAX package's `.ckpt` files, and with
`--from_torch True` a reference `model.pt`. Not registered yet
(ROADMAP.md): `aot`, `download`, `calibrate` and the mesh flags.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
    _add_profile_arg(p_train)
    p_spst = sub.add_parser(
        "spst", help="self-paced self-training of a pretrained PointDA model "
                     "on pseudo-labelled target clouds")
    _add_config_args(p_spst, SPSTConfig)
    _add_profile_arg(p_spst)
    p_seg = sub.add_parser("seg", help="PointSegDA segmentation DA")
    _add_config_args(p_seg, PointSegDAConfig)
    _add_profile_arg(p_seg)
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
    cls = {"trainer": PointDAConfig, "spst": SPSTConfig,
           "seg": PointSegDAConfig}.get(args.command, EvalConfig)
    cfg = _to_config(cls, args)
    try:
        resolve_device(cfg.device or None)
    except RuntimeError as e:
        print(f"mlsp_tpu_torch: {e} (--device cpu)", file=sys.stderr)
        return 1

    trace = contextlib.nullcontext()
    if getattr(args, "profile_dir", ""):
        from mlsp_tpu_torch.utils.profiling import device_trace

        trace = device_trace(args.profile_dir)
    if args.command == "trainer":
        from mlsp_tpu_torch.train.pointda_trainer import train_pointda

        if args.paper_recipe:
            cfg = cfg.paper_recipe
        with trace:
            train_pointda(cfg)
    elif args.command == "spst":
        from mlsp_tpu_torch.train.spst import train_spst

        with trace:
            train_spst(cfg)
    elif args.command == "seg":
        from mlsp_tpu_torch.train.pointsegda_trainer import train_pointsegda

        with trace:
            train_pointsegda(cfg)
    else:
        from mlsp_tpu_torch.train import evaluation

        {"eval": evaluation.run_eval, "infer": evaluation.run_infer,
         "export": evaluation.run_export}[args.command](cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
