#!/bin/bash
# Check the PyTorch/CUDA port (mlsp_tpu_torch) on one CUDA card, from the
# root of a checkout. Four steps:
#   smoke       python3 chip_smoke.py: every kernel against its plain
#               version, the serving and train main paths, the times
#   cuda_tests  the card-only tests (pytest -m cuda; --noconftest, since
#               tests/conftest.py imports JAX)
#   profile     scripts/torch_train_profile.py: where a train step's
#               device time goes
#   alone       chip_smoke.py copied alone into an empty directory: it
#               must exit non-zero, since it cannot run without the package
#
# Usage: bash scripts/torch_chip_check.sh LOG_DIR
#
# Each step's output goes to LOG_DIR/<step>.log; stdout gets one
# "<step> rc=<exit code> seconds=<s>" line per step and the last lines of
# the smoke and test logs. Exits 0 only when smoke, cuda_tests and profile
# exit 0 and alone does not.
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
