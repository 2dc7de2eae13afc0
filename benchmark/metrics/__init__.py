"""Per-layer metrics' readers, one file per metric, named as the metric.
Each has `read(run)` (`harness.Run`: the cell, its configuration, its
driver and the window with its traced stretch) and returns the metric's
value, or None where the stretch holds nothing to read."""
