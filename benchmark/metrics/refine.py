"""The refine stages' counts, which the port keeps on the device
(`kissmpc_tpu_torch.solver.api.refine_counts`: per stage, the scenarios
re-solved, those of them that entered unconverged and those rescued, over
every solve of the process, warm-up included).  A program without them
gives None."""


def share(column: int):
    """The sum of ``column`` (1: entered unconverged, 2: rescued) over the
    stages, over the scenarios they re-solved (%), or None."""
    from kissmpc_tpu_torch.solver import api

    counts = getattr(api, "refine_counts", None)
    rows = counts("cuda") if counts is not None else []
    resolved = sum(row[0] for row in rows)
    if resolved == 0:
        return None
    return 100.0 * sum(row[column] for row in rows) / resolved
