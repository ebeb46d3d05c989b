#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. Without a card it exits 2 and prints no result. The last line
of standard output is the result (see `benchmark/harness/core.py`);
`benchmark/README.md` says how to add a configuration, a traffic mix, a
cell or a metric.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# Kernel and build caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
