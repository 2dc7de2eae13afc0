"""The card's idle ms per node tick inside the tick's span `node.tick`
(`io/pubsub.py::ControlLoop.tick`): the host's work of the tick, the
program's, apart from the traffic's own work between ticks."""

from benchmark.metrics import spans


def read(run):
    return spans.idle_ms(run, "node.tick")
