"""The readers of the program's spans and counters: card-idle ms inside
spans of one name on a synthetic trace, worked out by hand, and the
refine shares from counts the program would report."""

import pytest

from benchmark import harness, traces
from benchmark.metrics import refine, spans

E = traces.Event


def _run(trace):
    window = harness.Window([1.0] * 4, 4.0, trace, 1, [1.0, 1.0])
    return harness.Run({}, {}, None, window)


def _trace():
    """Two calls in a stretch from 1.0 to 9.0 s.  Call 1: `call` 1.0-4.0
    with `read` 2.0-3.0 inside and a second `read` 2.5-3.5 over its end;
    call 2: `call` 5.0-9.5 (past the stretch's end), `read` 6.0-7.0.  The
    card is busy 0.5-1.5 (before the stretch: cut at 1.0), 2.2-2.4,
    3.2-3.6 and 2.3-2.6 (overlapping), 6.5-8.0."""
    device = [E("k0", 0.5, 1.5), E("k1", 2.2, 2.4), E("k2", 3.2, 3.6), E("k3", 2.3, 2.6),
              E("k4", 6.5, 8.0)]
    host = [E("call", 1.0, 4.0), E("read", 2.0, 3.0), E("read", 2.5, 3.5),
            E("aten::copy_", 2.1, 2.2), E("call", 5.0, 9.5), E("read", 6.0, 7.0),
            E("read", 0.0, 0.5)]
    return traces.Trace(device, host, [device[1:4], device[4:]], 1.0, 9.0)


def test_idle_inside_spans_per_call():
    run = _run(_trace())
    # call: 3.0 + 4.0 s inside the stretch, busy inside 0.5 (1.0-1.5)
    # + 0.4 (2.2-2.6) + 0.4 (3.2-3.6) + 1.5 (6.5-8.0) = 2.8: idle 4.2 s.
    assert spans.idle_ms(run, "call") == pytest.approx(1e3 * 4.2 / 2)
    # read: 2.0-3.5 once (1.5 s) and 6.0-7.0 (1.0 s); busy 0.4 + 0.3
    # (3.2-3.5) + 0.5 (6.5-7.0) = 1.2: idle 1.3 s.  The read before the
    # stretch counts nothing.
    assert spans.idle_ms(run, "read") == pytest.approx(1e3 * 1.3 / 2)


def test_no_span_or_no_stretch_reads_nothing():
    assert spans.idle_ms(_run(_trace()), "graph.replay") is None
    assert spans.idle_ms(_run(traces.Trace([], [E("call", 0.0, 1.0)], [], 0.0, 0.0)),
                         "call") is None
    assert spans.idle_ms(_run(None), "call") is None


def test_union_and_overlap():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [[0, 2.5], [3, 4]]
    assert spans.overlap([[0, 2], [3, 5]], [[1, 3.5], [4, 4.5], [6, 7]]) == pytest.approx(2.0)
    assert spans.overlap([], [[0, 1]]) == 0.0


@pytest.fixture
def counts(monkeypatch):
    from kissmpc_tpu_torch.solver import api

    def use(rows):
        monkeypatch.setattr(api, "refine_counts", lambda device=None: rows, raising=False)

    return use


def test_refine_shares_over_every_stage(counts):
    counts([[1024, 900, 700], [164, 160, 40]])
    assert refine.share(1) == pytest.approx(100.0 * 1060 / 1188)
    assert refine.share(2) == pytest.approx(100.0 * 740 / 1188)


def test_refine_shares_without_counts(counts, monkeypatch):
    counts([])
    assert refine.share(1) is None
    from kissmpc_tpu_torch.solver import api

    monkeypatch.delattr(api, "refine_counts")
    assert refine.share(2) is None
