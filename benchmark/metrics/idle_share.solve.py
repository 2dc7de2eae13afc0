"""The card's idle share of solve calls (%): busy time per traced call over the
window's seconds per call outside the traced stretch."""

from benchmark.metrics import kernels


def read(run):
    return kernels.idle_percent(run)
