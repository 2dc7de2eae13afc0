"""Batched global route planner: the Nav2 plan of each episode world.

A port of `kissmpc_tpu/planner.py`.  The reference's waypoints are a
decimated Nav2 global plan (`ros2interface.py:155-170`): a path that already
routes around the static map, handed to the MPC as a chain of free-space
hops.  The one-detour-point stand-in (`scenarios.route_waypoints`) has no
reachability guarantee and leaves episodes stuck in local traps the MPC
alone cannot escape.  This is the batched grid planner: per episode a square
occupancy grid over its static circles, an 8-neighbour min-plus value
iteration as whole-array passes over [B, G, G] planes in a Python loop
(every episode at once, with no host sync inside the loops), a
steepest-descent backtrack, and an arc-length resampling of each leg into a
fixed number of route points ([B, W*(P+1), 3], like the reference's stride-25
decimation).

There is no Pallas kernel behind it in the reference (`lax.fori_loop` and
`lax.scan`), so the port is plain PyTorch, on the device the caller names
(``device=None`` is the card).  On the card each of the two grid-field
programs, `_plan_fields` and `_bottleneck_fields`, runs as one CUDA graph
per grid and input shape (`solver/graph.py`), as the reference jits them;
the numpy preparation before them, and the resampling and the headings
after them, stay on the host, as in the reference.  What keeps the routes
equal to the reference's, where one ulp of a distance could change an
argmin: the relaxations use only exact operations (min, max) and single
additions; the clearance penalty is summed over the circles one plane at a
time in index order; the cell indices are int32, rounded half to even and
clamped; `sqrt2` and `_BIG` are the reference's float32 constants; the
backtrack's argmin takes the first minimum over the same offset order,
(0, 0) first.  And the grid frame and
penalty follow the reference's arithmetic as XLA compiles it: a division by
a constant is a multiplication by the constant's float32 reciprocal, and a
multiply-add is one fused operation (`_fma`).

Dynamic obstacles are ignored by construction (Nav2 plans against the
static map; predicted humans are the MPC's job).  Legs whose endpoints the
grid cannot connect fall back to straight-line resampling and are reported
per leg, so unreachable-by-construction episodes are measurable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._device import constant, resolve_device
from .solver import graph

_BIG = float(np.float32(1e9))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Clearance preference (Nav2's inflation layer): entering a cell within
# PREF_M of an inflated boundary costs up to PEN_W extra steps.
_PREF_M = 0.3
_PEN_W = 6.0
# Backtrack offsets, (0, 0) first: at the target the centre is the strict
# minimum, so the descent stays there once it arrives.
_OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
_NEIGHBOURS = ((0, 1, 1.0), (0, -1, 1.0), (1, 0, 1.0), (-1, 0, 1.0),
               (1, 1, _SQRT2), (1, -1, _SQRT2), (-1, 1, _SQRT2), (-1, -1, _SQRT2))


def _reciprocal(x: float) -> float:
    """The float32 reciprocal of float32(x), by which XLA replaces a
    division by the constant x."""
    return float(np.float32(1.0) / np.float32(x))


def _fma(a, b, c):
    """a * b + c in float32 with one rounding, as XLA's fused multiply-add
    gives it: the product is exact in float64, and the sum's rounding to
    float64 before float32 differs from one rounding only at an exact
    float32 half-way point."""
    return (a.double() * b.double() + c.double()).float()


def _grid_frame(points, need, G):
    """Per-episode square grid frame, shared by the route planner and the
    bottleneck-clearance probe so their frames can never drift apart.

    points [B, P, 2] must cover every location the caller will snap to the
    grid; need [B, K] is the inflated radius per circle (< 0 inactive).
    Returns (lo [B, 2], cell [B], gx [B, G, 1], gy [B, 1, G]): the grid's
    origin, its cell size and the cell centres' coordinates.  The
    reference returns the [B, K, G, G] distances to every circle as well;
    here each circle's plane is made where it is used (`_circle_distance`),
    so one [B, G, G] plane is alive at a time (the whole tensor is 3.6 GB
    at `lab_worlds`' B=4096, K=24, G=96) and the penalty's sum over the
    circles runs in index order.
    """
    pad = 0.6 + torch.where(need > 0, need, torch.zeros_like(need)).amax(dim=1)  # [B]
    lo = points.amin(dim=1) - pad[:, None]
    hi = points.amax(dim=1) + pad[:, None]
    span = (hi - lo).amax(dim=1)
    cell = span * _reciprocal(G - 1)
    ii = torch.arange(G, dtype=torch.float32, device=points.device)
    gx = _fma(ii[None, :, None], cell[:, None, None], lo[:, 0, None, None])
    gy = _fma(ii[None, None, :], cell[:, None, None], lo[:, 1, None, None])
    return lo, cell, gx, gy


def _circle_distance(gx, gy, centers, k):
    """Distance [B, G, G] from each cell centre to circle k's centre."""
    dx = gx - centers[:, k, 0, None, None]
    dy = gy - centers[:, k, 1, None, None]
    return torch.sqrt(dx * dx + dy * dy)


def _offsets(dev) -> torch.Tensor:
    """`_OFFSETS` as int32 [9, 2] made on ``dev`` (no host copy)."""
    return constant([v for o in _OFFSETS for v in o], torch.int32, dev).reshape(-1, 2)


def _cell_of(p, lo, cell, G):
    """Physical [B, 2] -> int32 cell [B, 2], rounded half to even, clamped."""
    return torch.round((p - lo) / cell[:, None]).to(torch.int32).clamp(0, G - 1)


def _plan_fields(starts, waypoints, centers, need, *, grid: int = 64, iters: int = 0,
                 backtrack_steps: int = 0):
    """All-legs Dijkstra and backtrack on the tensors' device.  Returns
    (paths, reach, lo, cell): paths [B, W, T, 2], the physical backtrack
    points per leg (pinned at the leg's target once reached); reach [B, W]
    bool, leg connectivity; the grid frame (lo [B, 2], cell [B])."""
    B, W, _ = waypoints.shape
    K = centers.shape[1]
    G = grid
    T = backtrack_steps or 3 * G
    n_iter = iters or 2 * G
    dev = starts.device

    pts = torch.cat([starts[:, None, :], waypoints], dim=1)
    lo, cell, gx, gy = _grid_frame(pts, need, G)

    # Hard-blocked: inside the true inflated radius (exactly the constraint
    # the MPC enforces, so any corridor it could thread stays open at grid
    # resolution); clearance is preferred through a soft per-cell cost,
    # summed over the circles one plane at a time in index order.
    blocked = torch.zeros((B, G, G), dtype=torch.bool, device=dev)
    pen = torch.zeros((B, G, G), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    inv_pref = torch.full((), _reciprocal(_PREF_M), dtype=torch.float32, device=dev)
    for k in range(K):
        dist = _circle_distance(gx, gy, centers, k)
        nk = need[:, k, None, None]
        active = nk > 0
        blocked |= (dist < nk) & active
        pref = torch.clamp(_fma(nk - dist, inv_pref, one), 0.0, 1.0)
        pen = pen + torch.where(active, pref, torch.zeros_like(dist))
    pen = _PEN_W * pen

    bidx = torch.arange(B, device=dev)
    offs = _offsets(dev)
    # Tensors, not Python numbers, on the right of the indexed assignments:
    # on the CPU a number there is lifted from the host (`lift_fresh`),
    # which the tests of the captured regions count as a host copy.
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    free = torch.zeros((), dtype=torch.bool, device=dev)
    # The value field with a border of _BIG: its interior is d, and the
    # shifted views of the border-padded plane are the neighbours.
    dp = torch.full((B, G + 2, G + 2), _BIG, dtype=torch.float32, device=dev)
    d = dp[:, 1:-1, 1:-1]
    best = torch.empty((B, G, G), dtype=torch.float32, device=dev)
    step = torch.empty_like(best)
    prev = starts
    paths, reach = [], []
    for w in range(W):
        tgt = waypoints[:, w, :]
        tc = _cell_of(tgt, lo, cell, G).long()
        sc = _cell_of(prev, lo, cell, G).long()
        d.fill_(_BIG)
        d[bidx, tc[:, 0], tc[:, 1]] = zero
        # Force-unblock the source and target cells: the generator clears
        # waypoints to about the same margin, and rounding must not seal a leg.
        ublk = blocked.clone()
        ublk[bidx, tc[:, 0], tc[:, 1]] = free
        ublk[bidx, sc[:, 0], sc[:, 1]] = free
        for _ in range(n_iter):
            best.fill_(_BIG)
            for di, dj, c in _NEIGHBOURS:
                torch.add(dp[:, 1 + di:1 + di + G, 1 + dj:1 + dj + G], c, out=step)
                torch.minimum(best, step, out=best)
            # Entry cost: the geometric step plus the entered cell's
            # clearance penalty (d stays a one-step Bellman fixed point, so
            # the argmin-descent backtrack ends at the target).
            torch.add(best, pen, out=best)
            torch.minimum(d, best, out=best)
            d.copy_(best.masked_fill_(ublk, _BIG))
        ok = d[bidx, sc[:, 0], sc[:, 1]] < _BIG / 2

        # Steepest-descent backtrack, source -> target, over cells.
        c = sc.to(torch.int32)
        leg = []
        for _ in range(T):
            cand = c[:, None, :] + offs[None]  # [B, 9, 2]
            vals = dp[bidx[:, None], 1 + cand[..., 0].long(), 1 + cand[..., 1].long()]
            c = cand[bidx, torch.argmin(vals, dim=1)]
            leg.append(_fma(c.to(torch.float32), cell[:, None], lo))
        # A leg counts as reachable only if the descent arrived within its
        # step budget: a truncated polyline would jump across unrouted space.
        reach.append(ok & (c == tc.to(torch.int32)).all(dim=1))
        paths.append(torch.stack(leg, dim=1))  # [B, T, 2]
        prev = tgt
    return torch.stack(paths, dim=1), torch.stack(reach, dim=1), lo, cell


def _as_tensor(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)


def _run(fields, dev, *arrays, **static):
    """``fields`` of the float32 arrays on ``dev`` with its static keyword
    arguments, through `graph.run` keyed by both."""
    key = (f"planner.{fields.__name__}", *sorted(static.items()))
    with torch.no_grad():
        return graph.run(key, functools.partial(fields, **static), dev,
                         *(_as_tensor(x, dev) for x in arrays))


def plan_waypoint_chain(
    starts: np.ndarray,  # [B, 3]
    waypoints: np.ndarray,  # [B, W, 3]
    centers: np.ndarray,  # [B, K, 2]
    radii: np.ndarray,  # [B, K]
    static_mask: np.ndarray,  # [B, K] bool
    inflation: float,
    *,
    points_per_leg: int = 3,
    grid: int = 64,
    device=None,
):
    """Routed chain [B, W*(P+1), 3] and per-leg reachability [B, W] (numpy).

    Each leg start -> w0 -> ... -> w_{W-1} contributes P arc-length-resampled
    route points from the grid-Dijkstra path plus the leg's own endpoint (so
    the original waypoints survive verbatim).  Headings point at the next
    chain point.  Unreachable legs resample the straight segment instead
    (and are flagged).  The grid fields run on ``device`` (None: the card).
    """
    dev = resolve_device(device)
    B, W, _ = waypoints.shape
    P = points_per_leg
    need = np.where(static_mask, radii + inflation, -1.0).astype(np.float32)
    paths, reach, _, _ = _run(_plan_fields, dev, starts[:, :2], waypoints[..., :2], centers,
                              need, grid=grid)
    paths = paths.cpu().numpy()  # [B, W, T, 2]
    reach = reach.cpu().numpy()  # [B, W]

    out = np.zeros((B, W * (P + 1), 3), np.float32)
    prev = starts[:, :2].astype(np.float32)
    for w in range(W):
        tgt = waypoints[:, w, :2].astype(np.float32)
        pw = paths[:, w]  # [B, T, 2]  (source -> ... -> target, then pinned)
        # straight-line fallback for unreachable legs
        fr = (np.arange(pw.shape[1], dtype=np.float32) / (pw.shape[1] - 1))
        straight = prev[:, None, :] + fr[None, :, None] * (
            (tgt - prev)[:, None, :]
        )
        pw = np.where(reach[:, w, None, None], pw, straight)
        # arclength resample at fractions (i+1)/(P+1)
        seg = np.linalg.norm(np.diff(pw, axis=1), axis=-1)  # [B, T-1]
        cum = np.concatenate(
            [np.zeros((B, 1), np.float32), np.cumsum(seg, axis=1)], axis=1
        )
        total = cum[:, -1]  # [B]
        for i in range(P):
            f = (i + 1) / (P + 1)
            target_len = f * total
            idx = np.minimum(
                (cum < target_len[:, None]).sum(axis=1), pw.shape[1] - 1
            )
            pt = pw[np.arange(B), idx]
            # degenerate legs (already at target): pin to the target
            pt = np.where(total[:, None] > 1e-6, pt, tgt)
            out[:, w * (P + 1) + i, :2] = pt
        out[:, w * (P + 1) + P, :] = waypoints[:, w]
        prev = tgt

    # Headings: route points aim at the next chain point; the original
    # waypoint rows keep their own theta.  A degenerate route point
    # (coincident with its successor) inherits its leg waypoint's theta.
    for j in range(W * (P + 1)):
        if j % (P + 1) == P:
            continue  # waypoint row
        d = out[:, j + 1, :2] - out[:, j, :2]
        leg_theta = out[:, (j // (P + 1)) * (P + 1) + P, 2]
        out[:, j, 2] = np.where(
            np.linalg.norm(d, axis=1) > 1e-6,
            np.arctan2(d[:, 1], d[:, 0]),
            leg_theta,
        )
    return out, reach


def _bottleneck_fields(starts, goals, centers, need, *, grid: int = 96, iters: int = 0):
    """Widest-path clearance: the best achievable bottleneck margin [B].

    w(cell) = max over paths cell -> goal of min over the path's cells of
    (distance to the nearest inflated disk), by max-min value iteration over
    the planner's grid.  w(start) is the margin of the most comfortable
    corridor that exists at all: if it is ~0, no global planner can hand
    the MPC a route that clears the constraint boundary.
    """
    B, K = starts.shape[0], centers.shape[1]
    G = grid
    n_iter = iters or 2 * G
    dev = starts.device

    lo, cell, gx, gy = _grid_frame(torch.stack([starts, goals], dim=1), need, G)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    clear = torch.full((B, G, G), float("inf"), dtype=torch.float32, device=dev)
    for k in range(K):
        nk = need[:, k, None, None]
        margin = _circle_distance(gx, gy, centers, k) - nk
        clear = torch.minimum(clear, torch.where(nk > 0, margin, inf))

    bidx = torch.arange(B, device=dev)
    gc = _cell_of(goals, lo, cell, G).long()
    sc = _cell_of(starts, lo, cell, G).long()
    wp = torch.full((B, G + 2, G + 2), float("-inf"), dtype=torch.float32, device=dev)
    w = wp[:, 1:-1, 1:-1]
    w[bidx, gc[:, 0], gc[:, 1]] = clear[bidx, gc[:, 0], gc[:, 1]]
    best = torch.empty((B, G, G), dtype=torch.float32, device=dev)
    step = torch.empty_like(best)
    for _ in range(n_iter):
        best.copy_(w)
        for di, dj, _c in _NEIGHBOURS:
            torch.minimum(wp[:, 1 + di:1 + di + G, 1 + dj:1 + dj + G], clear, out=step)
            torch.maximum(best, step, out=best)
        w.copy_(best)
    return w[bidx, sc[:, 0], sc[:, 1]]


def bottleneck_clearance(
    starts: np.ndarray,  # [B, >=2]
    goals: np.ndarray,  # [B, >=2]
    centers: np.ndarray,  # [B, K, 2]
    radii: np.ndarray,  # [B, K]
    static_mask: np.ndarray,  # [B, K]
    inflation: float,
    *,
    grid: int = 96,
    device=None,
) -> np.ndarray:
    """Best-corridor margin beyond r + inflation from each start to its goal
    (negative: every path must violate the inflated constraint), [B] numpy.
    The grid fields run on ``device`` (None: the card)."""
    dev = resolve_device(device)
    need = np.where(static_mask, radii + inflation, -1.0).astype(np.float32)
    w = _run(_bottleneck_fields, dev, starts[:, :2], goals[:, :2], centers, need, grid=grid)
    return w.cpu().numpy()
