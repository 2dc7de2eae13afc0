"""Host ms per node tick: a tick's wall time (host clock, the ticks outside
the traced stretch) less the card's busy time inside a tick (the traced
ticks)."""

from benchmark.metrics import kernels


def read(run):
    busy = kernels.busy_per_call(run)
    times, _ = run.window.untraced()
    if busy is None or not times:
        return None
    return 1e3 * (sum(times) / len(times) - busy)
