"""Device profiling helpers: `torch.profiler` integration.  Port of
`kissmpc_tpu/utils/profiling.py`.

Trace capture around solver calls, written as a Chrome trace for
inspection in Perfetto or `chrome://tracing`; named spans that show in that
trace beside the kernels they enclose; and a micro-benchmark utility that
separates the first call (on the card: the kernels' nvcc build and load)
from steady-state latency.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

from .._tree import leaves


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
    """Named span visible in `trace`'s output (a context manager)."""
    return torch.profiler.record_function(name)


def block_until_ready(out):
    """Wait for the work behind ``out``: synchronize each CUDA device that
    holds one of its tensors (any nesting of named tuples, tuples, lists
    and dicts); tensors on the CPU are ready when returned."""
    devices = {x.device for x in leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)
    return out


def measure(
    fn: Callable,
    *args,
    warmup: int = 1,
    reps: int = 5,
) -> Dict[str, float]:
    """First-call + steady-state timing of a function.

    Returns dict with ``compile_s`` (the first call; on the card it
    includes building and loading the kernels it launches) and ``best_s`` /
    ``mean_s`` over ``reps`` post-warmup calls.
    """
    t0 = time.perf_counter()
    block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0

    for _ in range(max(0, warmup - 1)):
        block_until_ready(fn(*args))

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "compile_s": compile_s,
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
    }
