"""The card's idle ms per node tick inside the span `graph.replay`
(`solver/graph.py::run`): the launch of the tick's CUDA graph."""

from benchmark.metrics import spans


def read(run):
    return spans.idle_ms(run, "graph.replay")
