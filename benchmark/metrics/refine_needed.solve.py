"""The share of the scenarios the refine stages re-solved that entered
them unconverged (%): the rest were converged already, work the stage
throws away."""

from benchmark.metrics import refine


def read(run):
    return refine.share(1)
