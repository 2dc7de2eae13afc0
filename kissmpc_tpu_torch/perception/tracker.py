"""Multi-object track table, the persistence layer of perception: a port of
`kissmpc_tpu/perception/tracker.py`.

The reference delegates tracking to ultralytics' `model.track(persist=True)`
(`obstacle_handling/human_tracking.py:208-213`) and keys markers by track id
with explicit DELETE for vanished tracks (`:321-358`).  This is the
equivalent for any detector's centres: a fixed-size struct-of-arrays track
table with greedy nearest-neighbour association inside a gate, an
alpha-beta (g-h) filter for position and velocity, age and miss counters,
and an export to `ObstacleSet`, so that tracked humans become the solver's
dynamic obstacles.

Every leaf may carry leading batch axes (B independent tables).  The
reference's loops become batched whole-table passes with no host sync: the
greedy assignment is min(T, D) rounds of a flat argmin (the first index on
ties, as in the reference), and the spawn scan is a rank match of free
slots against unmatched detections that hands out track ids in slot order.
The filter's three multiply-adds are fused (`planner._fma`), as XLA fuses
them in the reference, so the tables come out equal to the reference's and
equal on the card and the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..obstacles import HUMAN_RADIUS, ObstacleSet
from ..planner import _fma


class TrackTable(NamedTuple):
    position: torch.Tensor  # [..., T, 2]
    velocity: torch.Tensor  # [..., T, 2]
    age: torch.Tensor  # [..., T] int32 ticks since birth
    misses: torch.Tensor  # [..., T] int32 consecutive unmatched ticks
    hits: torch.Tensor  # [..., T] int32 total matches
    active: torch.Tensor  # [..., T] bool
    next_id: torch.Tensor  # [...] int32 (monotone track id counter)
    track_id: torch.Tensor  # [..., T] int32


class TrackerConfig(NamedTuple):
    gate_distance: float = 0.8  # max association distance (m)
    alpha: float = 0.5  # position correction gain
    beta: float = 0.3  # velocity correction gain
    max_misses: int = 5  # retire after this many unmatched ticks
    min_hits: int = 2  # report only after this many matches


def init_tracks(capacity: int, dtype=torch.float32, *, batch: int | None = None,
                device=None) -> TrackTable:
    """An empty table of ``capacity`` slots; ``batch`` gives every leaf a
    leading [batch] axis.  ``device=None`` is the card."""
    dev = resolve_device(device)
    lead = () if batch is None else (batch,)
    T = capacity
    i32 = dict(dtype=torch.int32, device=dev)
    return TrackTable(
        position=torch.zeros(lead + (T, 2), dtype=dtype, device=dev),
        velocity=torch.zeros(lead + (T, 2), dtype=dtype, device=dev),
        age=torch.zeros(lead + (T,), **i32),
        misses=torch.zeros(lead + (T,), **i32),
        hits=torch.zeros(lead + (T,), **i32),
        active=torch.zeros(lead + (T,), dtype=torch.bool, device=dev),
        next_id=torch.zeros(lead, **i32),
        track_id=torch.full(lead + (T,), -1, **i32),
    )


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return m.to(torch.int32).argmax(-1)


def update(cfg: TrackerConfig, tracks: TrackTable, detections: torch.Tensor,
           det_mask: torch.Tensor, dt: float) -> TrackTable:
    """One tracker tick: predict, associate (greedy nearest neighbour inside
    the gate), correct, spawn, retire.  detections [..., D, 2] with validity
    [..., D]; their leading axes are the table's."""
    T = tracks.position.shape[-2]
    D = detections.shape[-2]
    lead = tracks.position.shape[:-2]
    dtype, dev = tracks.position.dtype, tracks.position.device
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)
    d_idx = torch.arange(D, dtype=torch.int32, device=dev)

    scalar = lambda x: torch.full((), x, dtype=dtype, device=dev)  # noqa: E731

    # Predict.
    pred = _fma(tracks.velocity, scalar(dt), tracks.position)

    # Pairwise distances track x detection, gated.
    diff = pred[..., :, None, :] - detections[..., None, :, :]
    dx, dy = diff[..., 0], diff[..., 1]
    dist = torch.sqrt(dx * dx + dy * dy + 1e-12)
    feasible = (tracks.active[..., :, None] & det_mask[..., None, :]
                & (dist <= cfg.gate_distance))
    INF = torch.full((), 1e9, dtype=dtype, device=dev)
    cost = torch.where(feasible, dist, INF)

    # Greedy one-to-one assignment: min(T, D) rounds of a global argmin.
    t_of_d = torch.full(lead + (D,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(T, D)):
        flat = cost.reshape(lead + (T * D,)).argmin(-1).to(torch.int32)
        t, d = flat // D, flat % D
        ok = cost.reshape(lead + (T * D,)).gather(-1, flat[..., None].long())[..., 0] < INF
        row = (t_idx == t[..., None]) & ok[..., None]  # [..., T]
        col = (d_idx == d[..., None]) & ok[..., None]  # [..., D]
        t_of_d = torch.where(col, t[..., None], t_of_d)
        cost = torch.where(row[..., :, None] | col[..., None, :], INF, cost)
    matched_d = t_of_d >= 0
    # d_of_t: the inverse mapping (-1 = unmatched track).
    hit = t_of_d[..., None, :] == t_idx[:, None]  # [..., T, D]
    d_of_t = torch.where(hit.any(-1), _first_true(hit), -1)
    matched_t = d_of_t >= 0

    # Correct matched tracks (alpha-beta filter).
    det_for_t = detections.gather(
        -2, torch.clamp(d_of_t, 0, D - 1).long()[..., None].expand(lead + (T, 2)))
    residual = det_for_t - pred
    m2 = matched_t[..., None]
    new_pos = torch.where(m2, _fma(scalar(cfg.alpha), residual, pred), pred)
    new_vel = torch.where(m2, _fma(scalar(cfg.beta / dt), residual, tracks.velocity),
                          tracks.velocity)

    misses = torch.where(matched_t, 0, tracks.misses + 1)
    hits = tracks.hits + matched_t.to(torch.int32)
    age = tracks.age + 1
    active = tracks.active & (misses <= cfg.max_misses)

    # Spawn tracks for unmatched detections into free slots: the r-th free
    # slot (in slot order) takes the r-th unmatched detection, and ids are
    # handed out in slot order.
    unmatched_d = det_mask & ~matched_d
    free_slot = ~active
    slot_rank = torch.cumsum(free_slot.to(torch.int32), -1) - 1
    det_rank = torch.cumsum(unmatched_d.to(torch.int32), -1) - 1
    want = unmatched_d[..., None, :] & (det_rank[..., None, :] == slot_rank[..., :, None])
    spawn = free_slot & want.any(-1)  # [..., T]
    d_new = _first_true(want)
    det_new = detections.gather(-2, d_new.long()[..., None].expand(lead + (T, 2)))
    s2 = spawn[..., None]
    new_pos = torch.where(s2, det_new, new_pos)
    new_vel = torch.where(s2, torch.zeros((), dtype=dtype, device=dev), new_vel)
    active = active | spawn
    misses = torch.where(spawn, 0, misses)
    hits = torch.where(spawn, 1, hits)
    age = torch.where(spawn, 0, age)
    track_id = torch.where(spawn, tracks.next_id[..., None] + slot_rank, tracks.track_id)
    next_id = tracks.next_id + spawn.sum(-1).to(torch.int32)

    return TrackTable(position=new_pos, velocity=new_vel, age=age, misses=misses, hits=hits,
                      active=active, next_id=next_id, track_id=track_id.to(torch.int32))


def confirmed(cfg: TrackerConfig, tracks: TrackTable) -> torch.Tensor:
    """[..., T] bool: tracks stable enough to report (min_hits reached)."""
    return tracks.active & (tracks.hits >= cfg.min_hits)


def to_obstacles(cfg: TrackerConfig, tracks: TrackTable,
                 radius: float = HUMAN_RADIUS) -> ObstacleSet:
    """Confirmed tracks -> dynamic ObstacleSet for the solver ([..., T]
    leaves).

    Heading and speed come from the filtered velocity (the reference's
    `DynamicObstacle` carries orientation + linear velocity,
    `obstacle_handling/dynamic_obstacle.py:8`)."""
    ok = confirmed(cfg, tracks)
    vx, vy = tracks.velocity[..., 0], tracks.velocity[..., 1]
    speed = torch.sqrt(vx * vx + vy * vy)
    heading = torch.atan2(vy, vx)
    zero = torch.zeros_like(speed)
    dtype = tracks.position.dtype
    return ObstacleSet(
        position=tracks.position,
        radius=torch.full_like(speed, radius),
        orientation=torch.where(ok, heading, zero).to(dtype),
        linear_velocity=torch.where(ok, speed, zero).to(dtype),
        angular_velocity=zero.to(dtype),
        active=ok.to(dtype),
    )
