"""Device milliseconds a train step in matmul kernels (cuBLAS, CUTLASS)."""

from benchmark.harness.trace import is_gemm


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if not steps:
        return None
    return 1e3 * ctx.reading.seconds(is_gemm) / steps
