"""The card's idle ms per solve call inside the span `graph.run`
(`solver/graph.py::run`: the copies in, the replay, the clones out): the
program's host work of a call, apart from the traffic's own work between
calls."""

from benchmark.metrics import spans


def read(run):
    return spans.idle_ms(run, "graph.run")
