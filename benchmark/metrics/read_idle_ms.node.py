"""The card's idle ms per node tick inside the span `model.read`
(`io/model.py::Model.step`): the reads of the plan, the commands and the
diagnostics to numpy."""

from benchmark.metrics import spans


def read(run):
    return spans.idle_ms(run, "model.read")
