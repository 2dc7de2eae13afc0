"""Traffic drivers, one file per kind, found by the `driver` of a cell's
file.  Each has `setup(ctx)`, which builds what the cell runs and warms
every shape it uses, and returns a driver with `step(i)` (one timed call,
its seconds), `trace_calls`, `result(window)` (attempted, failed and the
end-to-end metrics) and `check()` (the compared numbers)."""
