"""The fused kernel's share of its roofline over whole solve calls (%): the
least time of every solve stage a call makes (`counts.fused_bound`: the
operations at 67 TFLOP/s, or the bytes at 3.35 TB/s where more) over the
fused kernels' device time in the trace."""

from benchmark.metrics import kernels


def read(run):
    return kernels.fused_roofline(run)
