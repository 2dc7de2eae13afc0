"""Profiler traces of a steady stretch of the window, read into plain
numbers.

Frozen from `chip_smoke.py::trace_kernels`, `marked_runs` and
`profile_call` at commit d587314: `torch.profiler` (CUPTI on the card)
records the stretch; a long spin kernel leads, since the profiler can lose
a trace's first kernels, and a short spin kernel (`torch.cuda._sleep`'s
`spin_kernel`) before each call marks where the call's device work begins,
so every segment between two markers is one whole call.
"""

from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

MARKER = "spin_kernel"
LEAD_CYCLES = 10_000_000  # a few ms of spin before the traced calls
MARK_CYCLES = 1000
# A spin longer than this is the lead (LEAD_CYCLES take milliseconds, a
# marker's MARK_CYCLES under a microsecond).
LEAD_SECONDS = 1e-3
# The host's calls that wait for the card.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cudaEventSynchronize")


class Event(NamedTuple):
    name: str
    start: float  # s, the profiler's clock
    end: float


class Trace(NamedTuple):
    """A traced stretch: device events (kernels, copies, fills; markers
    apart), the host's events, the segments (one list of device events per
    whole call) and the stretch's bounds on the profiler's clock."""

    device: list
    host: list
    segments: list
    start: float
    end: float


def begin():
    """Start a profile of the card and the host, and lead with a spin."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(LEAD_CYCLES)
    return prof


def warm():
    """Profile one small operation, so that the profiler's own start-up
    (CUPTI's, seconds on a first profile) falls in the set-up and not in
    the window."""
    import torch

    prof = begin()
    torch.ones(1, device="cuda").add_(1)
    finish(prof)


def mark():
    """The marker before a traced call."""
    import torch

    torch.cuda._sleep(MARK_CYCLES)


def finish(prof) -> Trace:
    """Close the stretch with a last marker, stop the profile and read it."""
    import torch

    mark()
    torch.cuda.synchronize()
    prof.stop()
    device, host = [], []
    for e in prof.events():
        ev = Event(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (device if e.device_type.name == "CUDA" else host).append(ev)
    device.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return split(device, host)


def split(device, host) -> Trace:
    """The Trace of device events sorted by start: the lead is the long
    spin (the profiler may have lost it), and every short spin after it
    marks the start of a call."""
    marks = [i for i, e in enumerate(device) if MARKER in e.name]
    leads = [i for i in marks if device[i].end - device[i].start > LEAD_SECONDS]
    cuts = [i for i in marks if i > (leads[-1] if leads else -1)]
    if len(cuts) < 2:
        return Trace([], host, [], 0.0, 0.0)
    segments = [device[a + 1:b] for a, b in zip(cuts, cuts[1:])]
    # The stretch runs from the first call's marker to the last marker.
    start, end = device[cuts[0]].start, device[cuts[-1]].start
    inside = [e for e in device[cuts[0]:cuts[-1]] if MARKER not in e.name]
    return Trace(inside, host, segments, start, end)


def busy_seconds(events) -> float:
    """Seconds in which at least one of ``events`` ran (their union)."""
    total, until = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.start):
        if e.end <= until:
            continue
        total += e.end - max(e.start, until)
        until = e.end
    return total


def is_kernel(e: Event) -> bool:
    return not e.name.startswith(("Memcpy", "Memset")) and MARKER not in e.name


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its return type, cut to ``width``."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def device_ops(trace: Trace, top: int = 10):
    """The device operations that took most time: [[name, seconds], ...]."""
    by_name = collections.Counter()
    for e in trace.device:
        by_name[short(e.name)] += e.end - e.start
    return [[name, s] for name, s in by_name.most_common(top)]


def idle_gaps(trace: Trace, top: int = 10):
    """The device's idle time in the stretch, by what the host was doing at
    the middle of each gap (the innermost host event there):
    [[name, seconds], ...], longest first."""
    gaps, until = [], trace.start
    for e in sorted(trace.device, key=lambda e: e.start):
        if e.start > until:
            gaps.append((until, e.start))
        until = max(until, e.end)
    if trace.end > until:
        gaps.append((until, trace.end))
    starts = [e.start for e in trace.host]
    by_name = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "(no host event)"
        i = bisect.bisect_right(starts, mid)
        for e in reversed(trace.host[max(0, i - 2000):i]):
            if e.end >= mid:
                name = e.name
                break
        by_name[name] += b - a
    return [[name, s] for name, s in by_name.most_common(top)]


def host_calls(trace: Trace, names) -> int:
    """How many host events of the stretch are named one of ``names``."""
    return sum(1 for e in trace.host
               if e.name in names and trace.start <= e.start <= trace.end)
