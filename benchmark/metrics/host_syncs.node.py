"""The host's waits for the card per node tick: stream, device and event
synchronisations and synchronous copies in the traced stretch."""

from benchmark import traces


def read(run):
    w = run.window
    segments = w.trace.segments if w.trace else []
    if not segments:
        return None
    return traces.host_calls(w.trace, traces.SYNC_CALLS) / len(segments)
