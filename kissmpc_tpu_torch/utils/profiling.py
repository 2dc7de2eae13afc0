"""Profiling: `torch.profiler` traces and the program's named spans.  Port
of `kissmpc_tpu/utils/profiling.py`.

`trace` captures the host and, where CUDA is present, the card around any
code, written as a Chrome trace for Perfetto or `chrome://tracing`.
`annotate` is the program's one span API: the node tick, the model step
and every `graph.run` open spans with it (PERF.md lists them), and each
span is a host event of whatever profiler records, so it lies on the same
clock as the device's kernels and copies.  While no profiler records,
`annotate` returns one shared null context and a span costs a check.
`block_until_ready` waits for a result's work on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .._tree import leaves

# The context of every span entered while no profiler records.
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU and, where CUDA is present, device trace:
    ``with trace('/tmp/mpc-trace'): step()``.  On exit the trace is written
    to ``log_dir/trace-<pid>-<ns>.json``; the context yields the profiler,
    whose ``key_averages()`` sums the trace by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A span named ``name`` (a context manager), nested under the span
    open around it: a host event of the running profiler, or, while none
    records, the shared null context.  The span is recorded as a plain
    host range, not as `torch.profiler.record_function`'s user annotation,
    which CUPTI mirrors on the card as a device event spanning the kernels
    launched inside: such an event would count as device work in every
    reading of busy time and kernels."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def block_until_ready(out):
    """Wait for the work behind ``out``: synchronize each CUDA device that
    holds one of its tensors (any nesting of named tuples, tuples, lists
    and dicts); tensors on the CPU are ready when returned."""
    devices = {x.device for x in leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)
    return out
