#!/bin/bash
# Check the PyTorch/CUDA port (mlsp_tpu_torch) on one CUDA card, from the
# root of a checkout. Eight steps:
#   smoke       python3 chip_smoke.py: every kernel against its plain
#               version, the serving, train step, data pipeline, trainer
#               CLI and eval/infer paths, the other families, Point-ViT
#               and checkpoint interop (`vit_interop`), segmentation and
#               AOT bundles (`serving_g2`), data-parallel training, native
#               ingest and calibrate (`ddp_ingest`), the step graphs of
#               `scan_steps` (`step_graphs`), the points axis as gloo
#               ranks sharing the card (`points_mesh`), the times
#   cuda_tests  the card-only tests (pytest -m cuda; --noconftest, since
#               tests/conftest.py imports JAX), among them the AOT bundle
#               moved to the card and two gloo ranks sharing it
#   profile     scripts/torch_train_profile.py: where a PointDA train
#               step's device time goes
#   seg_profile the same for a PointSegDA train step (--seg)
#   all_profile the same for a PointDA step with every recipe flag
#               (--all_branches)
#   mesh_profile the PointDA step as the rank of an NCCL world of one
#               beside the same step without a mesh (--mesh_data 1)
#   repro       scripts/torch_step_repro.py: every recipe's and family's
#               train step taken twice, eagerly and replayed, bit-equal
#   alone       chip_smoke.py copied alone into an empty directory: it
#               must exit non-zero, since it cannot run without the package
#
# Usage: bash scripts/torch_chip_check.sh LOG_DIR
#
# Each step's output goes to LOG_DIR/<step>.log; stdout gets one
# "<step> rc=<exit code> seconds=<s>" line per step and the last lines of
# the smoke and test logs. Exits 0 only when smoke, cuda_tests, the four
# profiles and repro exit 0 and alone does not.
set -u
out=$(mkdir -p "${1:?usage: bash scripts/torch_chip_check.sh LOG_DIR}" \
      && cd "$1" && pwd) || exit 2
status=0

step() {  # step NAME COMMAND...: run COMMAND, log to $out/NAME.log
  local name=$1 t0 rc
  shift
  t0=$(date +%s)
  "$@" > "$out/$name.log" 2>&1
  rc=$?
  echo "$name rc=$rc seconds=$(( $(date +%s) - t0 ))"
  return $rc
}

step smoke python3 chip_smoke.py || status=1
tail -n 3 "$out/smoke.log"
step cuda_tests python3 -m pytest --noconftest -m cuda -q -p no:cacheprovider \
  tests/test_torch_port_cuda.py || status=1
tail -n 1 "$out/cuda_tests.log"
step profile env PYTHONPATH=. python3 scripts/torch_train_profile.py || status=1
step seg_profile env PYTHONPATH=. python3 scripts/torch_train_profile.py --seg \
  || status=1
step all_profile env PYTHONPATH=. python3 scripts/torch_train_profile.py \
  --all_branches || status=1
step mesh_profile env PYTHONPATH=. python3 scripts/torch_train_profile.py \
  --mesh_data 1 || status=1
step repro python3 scripts/torch_step_repro.py || status=1
tail -n 1 "$out/repro.log"

alone=$(mktemp -d)
cp chip_smoke.py "$alone/"
if (cd "$alone" && env -u PYTHONPATH python3 chip_smoke.py \
      > "$out/alone.log" 2>&1); then
  echo "alone rc=0: chip_smoke.py ran without the package"
  status=1
else
  echo "alone rc=$? (expected: non-zero)"
fi
rm -rf "$alone"
exit $status
