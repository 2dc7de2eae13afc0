"""Device ms per node tick of the split IPM loop's kernels (condensation,
Riccati, step)."""

from benchmark.metrics import kernels


def read(run):
    return kernels.per_call_ms(run, *kernels.SPLIT_LOOP)
