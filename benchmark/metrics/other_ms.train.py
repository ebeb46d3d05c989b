"""Device milliseconds a train step outside matmuls and the port's own
kernels: elementwise, BatchNorm, reductions, copies and fills."""

from benchmark.harness.trace import is_gemm, port_kernel


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if not steps:
        return None
    sec = ctx.reading.seconds(lambda n: not is_gemm(n) and not port_kernel(n))
    return 1e3 * sec / steps
