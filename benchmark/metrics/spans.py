"""Card-idle time inside the program's spans: the traced stretch's host
events of one name (the port opens them with
`kissmpc_tpu_torch.utils.profiling.annotate`), less their overlap with the
card's busy time, per whole call.  A program without such spans gives
None."""


def union(intervals) -> list:
    """Sorted, disjoint [start, end] pairs that cover ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """Seconds inside both of two lists that `union` gives."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def idle_ms(run, name: str):
    """The card's idle ms per whole traced call inside the spans named
    ``name`` (cut to the stretch; nested or overlapping ones count once),
    or None where the stretch holds no such span."""
    trace = run.window.trace
    if trace is None or not trace.segments:
        return None
    spans = union((max(e.start, trace.start), min(e.end, trace.end)) for e in trace.host
                  if e.name == name and e.start < trace.end and e.end > trace.start)
    if not spans:
        return None
    busy = union((e.start, e.end) for e in trace.device)
    inside = sum(b - a for a, b in spans)
    return 1e3 * (inside - overlap(spans, busy)) / len(trace.segments)
