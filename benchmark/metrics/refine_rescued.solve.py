"""The share of the scenarios the refine stages re-solved that they
rescued (%): entered unconverged, converged in the stage, merged back."""

from benchmark.metrics import refine


def read(run):
    return refine.share(2)
