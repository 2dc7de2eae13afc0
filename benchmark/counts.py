"""Operation and byte counts of the fused IPM kernel, from shapes alone,
against the published peaks of one NVIDIA H100 SXM.

Frozen copies of `chip_smoke.py::fused_ops_per_iteration`,
`fused_ops_once`, `fused_bound` and `stage_shapes` at commit d587314, so
that later changes to the kernels leave the yardstick where it is.  A
roofline share is this least time over the measured kernel time; the card's
power limit is printed beside it, since the peaks assume 700 W.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fused_ops_per_iteration(n, k, ls_iters, elastic=False):
    """Operations of one IPM iteration per scenario, counted from the
    function as both implementations compute it.  Each add, multiply,
    compare-and-select, min, max, abs, division, sqrt, sin, cos and log
    counts as one operation and an FMA as two, so the bound is optimistic.
    Per pass: reduce 11 per box element, 22 per obstacle element; backward
    per stage 19 + 63 + 96 + 182, + 53 per obstacle; rollout 55 per stage;
    steps 24 per box element, 41 per obstacle element; merit per candidate
    80 per state, 69 per control, 47 per obstacle element; update 26 per
    box element, 45 per obstacle element, 10 per stage.  The elastic branch
    adds per obstacle element 21 + 40 + 6 - 14 + 9 per candidate + 2 - 14."""
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    ops = (
        11 * box + 22 * obst
        + (360 + 53 * k) * n + 96 + 53 * k
        + 55 * n
        + 24 * box + 41 * obst
        + ls_iters * (80 * t1 + 69 * n + 47 * obst)
        + 26 * box + 45 * obst + 6 * t1 + 4 * n
    )
    if elastic:
        ops += obst * (21 + 40 + 6 - 14 + ls_iters * 9 + 2 - 14)
    return ops


def fused_ops_once(n, k, elastic=False):
    """Init and diagnostics, once per solve: about three merit passes and
    two reductions; the elastic init merit adds 7 per obstacle element."""
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    ops = 3 * (80 * t1 + 69 * n + 47 * obst) + 2 * (11 * box + 22 * obst)
    return ops + (7 * obst if elastic else 0)


def fused_bound(n, k, ls_iters, batch, iterations, elastic=False):
    """The fused kernel's least time for ``batch`` scenarios and
    ``iterations``: (bound s, "bytes" or "operations", bytes, operations).
    Bytes: its inputs read once and its outputs written once (the iterate
    never leaves the chip)."""
    in_rows = 27 + 3 * (n + 1) + 2 * n + (4 * k + 2 * k + 1 if k else 0)
    out_rows = 3 * (n + 1) + 2 * n + 6
    n_bytes = 4 * (in_rows + out_rows) * batch + 4
    ops = batch * (iterations * fused_ops_per_iteration(n, k, ls_iters, elastic)
                   + fused_ops_once(n, k, elastic))
    bytes_s, ops_s = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations", n_bytes, ops


def stage_shapes(batch, iterations, refine_stages):
    """(B, iterations, mu_sigma) of every solve stage of a staged batched
    solve: the base solve, then each refine stage's share of the batch."""
    shapes = [(batch, iterations, None)]
    for frac, iters, mu_sigma in refine_stages:
        shapes.append((min(batch, max(1, int(round(batch * frac)))), iters, mu_sigma))
    return shapes
