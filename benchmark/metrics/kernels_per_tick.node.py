"""Kernels per node tick (copies and fills apart), between markers."""

from benchmark import traces


def read(run):
    segments = run.window.trace.segments if run.window.trace else []
    if not segments:
        return None
    return sum(sum(1 for e in s if traces.is_kernel(e)) for s in segments) / len(segments)
