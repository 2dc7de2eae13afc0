"""Device ms per solve call of the fused launches after the first: the
refine stages."""

from benchmark.metrics import kernels


def read(run):
    segments = run.window.trace.segments if run.window.trace else []
    stages = [kernels.named(s, kernels.FUSED)[1:] for s in segments]
    if not any(stages):
        return None
    return 1e3 * sum(kernels.seconds(s) for s in stages) / len(stages)
