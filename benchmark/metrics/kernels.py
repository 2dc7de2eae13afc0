"""What several readers share: the kernels of the traced stretch by name,
per whole call (the segments between markers)."""

from benchmark import counts, traces

FUSED = "ipm_fused_kernel"
SPLIT_LOOP = ("condense_kernel", "riccati_kernel", "step_kernel")


def named(events, *names):
    return [e for e in events if any(n in e.name for n in names)]


def seconds(events) -> float:
    return sum(e.end - e.start for e in events)


def busy_per_call(run):
    """The card's busy seconds per whole traced call, or None."""
    segments = run.window.trace.segments if run.window.trace else []
    if not segments:
        return None
    return sum(traces.busy_seconds(s) for s in segments) / len(segments)


def idle_percent(run):
    """The card's idle share of a call (%): its busy time in the traced
    calls over the window's seconds per call outside the traced stretch
    (the profiler's own host work, a millisecond a node tick, left out)."""
    busy = busy_per_call(run)
    _, period = run.window.untraced()
    if busy is None or period <= 0.0:
        return None
    return 100.0 * (1.0 - busy / period)


def per_call_ms(run, *names):
    """Device ms per whole call of the kernels named ``names``."""
    segments = run.window.trace.segments if run.window.trace else []
    if not segments:
        return None
    return 1e3 * sum(seconds(named(s, *names)) for s in segments) / len(segments)


def fused_roofline(run):
    """The fused kernel's share of its roofline over whole calls (%)."""
    segments = run.window.trace.segments if run.window.trace else []
    fused = sum(seconds(named(s, FUSED)) for s in segments)
    if not segments or fused <= 0.0:
        return None
    cfg = run.driver.cfg
    bound = sum(counts.fused_bound(cfg.horizon, cfg.max_obstacles, cfg.solver.ls_iters, b, it,
                                   cfg.solver.elastic_obstacles)[0]
                for b, it, _ in run.driver.stage_shapes())
    return 100.0 * bound * len(segments) / fused
