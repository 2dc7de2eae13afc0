"""The window's arithmetic: a rate over all the work and all the time of
the window, tails over every call, a stall included."""

import time

import numpy as np
import pytest

from benchmark import harness, traces


def test_percentile_matches_numpy():
    rng = np.random.default_rng(1)
    xs = list(rng.exponential(1.0, 997))
    for q in (50, 95, 99):
        assert harness.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)
    with pytest.raises(harness.BenchError):
        harness.percentile([], 95)


def test_rate_over_the_whole_window_and_tail_over_every_call():
    """A stall of one call in the window lowers the rate by its whole
    length and sits in the tail."""
    calls, stall = [], 0.12

    def step(i):
        t0 = time.perf_counter()
        time.sleep(stall if i == 5 else 0.002)
        calls.append(i)
        return time.perf_counter() - t0

    w = harness.run_window(step, 0.3)
    assert len(w.times) == len(calls) and w.seconds >= 0.3
    assert w.seconds >= sum(w.times)
    rate = len(calls) / w.seconds
    # A rate from the median call would ignore the stall; the window's does not.
    assert rate <= len(calls) / sum(w.times)
    assert rate < 0.8 / float(np.median(w.times))  # the stall is 40% of the window
    assert harness.percentile(w.times, 100) == pytest.approx(max(w.times))
    assert max(w.times) >= stall
    xs = sorted(w.times)
    assert harness.percentile(w.times, 99) > xs[-3]


def test_window_ends_with_the_first_call_past_its_length():
    w = harness.run_window(lambda i: (time.sleep(0.05), 0.05)[1], 0.12)
    assert len(w.times) == 3 and 0.12 <= w.seconds < 0.2


def test_busy_time_is_the_union_of_device_events():
    E = traces.Event
    events = [E("a", 0.0, 1.0), E("b", 0.5, 1.5), E("c", 2.0, 2.5), E("d", 2.1, 2.2)]
    assert traces.busy_seconds(events) == pytest.approx(2.0)


def test_idle_gaps_by_host_event():
    E = traces.Event
    trace = traces.Trace(device=[E("k1", 1.0, 2.0), E("k2", 3.0, 4.0)],
                         host=[E("outer", 0.0, 10.0), E("cudaStreamSynchronize", 2.1, 2.9)],
                         segments=[], start=0.5, end=5.0)
    gaps = dict(traces.idle_gaps(trace))
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.0)
    assert gaps["outer"] == pytest.approx(0.5 + 1.0)
    assert traces.device_ops(trace) == [["k1", 1.0], ["k2", 1.0]]
    assert traces.host_calls(trace, traces.SYNC_CALLS) == 1


def test_segments_follow_the_lead_whether_or_not_it_was_recorded():
    """Every short marker after the long lead spin starts a call; a trace
    that lost its lead still gives every call."""
    E = traces.Event
    calls = [E("spin_kernel", 0.010, 0.0100005), E("k1", 0.011, 0.012),
             E("spin_kernel", 0.013, 0.0130005), E("k2", 0.014, 0.016),
             E("spin_kernel", 0.017, 0.0170005)]
    led = traces.split([E("spin_kernel", 0.0, 0.005), E("before", 0.006, 0.007)] + calls, [])
    lost = traces.split(calls, [])
    assert led == lost
    assert [[e.name for e in s] for s in led.segments] == [["k1"], ["k2"]]
    assert (led.start, led.end) == (0.010, 0.017)
    assert [e.name for e in led.device] == ["k1", "k2"]
