"""Benchmark scenario pools and episode worlds (torch builders over the
reference's sampling).

`sample_endpoints`, `sample_obstacle_field` and `route_waypoints` are copies
of the numpy code in `kissmpc_tpu/scenarios.py` (the port imports nothing of
the JAX package), so one seed gives bit-identical geometry in both packages.
`free_problems`, `obstacle_problems` and `episode_worlds` build the batches
with the port's own builders.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

# Reference inflation: robot radius 0.3 + 0.1 margin (`mpc/agent.py:149`).
DEFAULT_INFLATION = 0.4


def sample_endpoints(cfg, batch: int, rng: np.random.Generator):
    """Random receding-horizon (start, goal) pairs: goals within ~1.2x the
    horizon's reachable range."""
    starts = np.concatenate(
        [rng.uniform(-2, 2, (batch, 2)), rng.uniform(-3.1, 3.1, (batch, 1))],
        axis=1,
    ).astype(np.float32)
    reach = cfg.horizon * cfg.time_step * 0.5  # v_max = 0.5
    r = rng.uniform(0.1, 1.2 * reach, (batch, 1))
    ang = rng.uniform(-np.pi, np.pi, (batch, 1))
    goals = np.concatenate(
        [
            starts[:, 0:1] + r * np.cos(ang),
            starts[:, 1:2] + r * np.sin(ang),
            rng.uniform(-3.1, 3.1, (batch, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    return starts, goals


def sample_obstacle_field(
    starts: np.ndarray,  # [B, 3]
    goals: np.ndarray,  # [B, 3]
    k: int,
    rng: np.random.Generator,
    *,
    n_dynamic: int = 0,
    inflation: float = DEFAULT_INFLATION,
    radius_range=(0.15, 0.45),
    lateral_sigma: float = 0.35,
    endpoint_margin: float = 0.12,
    clear_points=(),
):
    """Sample K circles per scenario straddling the start->goal segment.

    Returns (centers [B,K,2], radii [B,K], orientation [B,K], v [B,K]) with
    both endpoints outside every inflated circle (the start push runs last:
    a pinned start inside an obstacle is an infeasible NLP), and moving
    obstacles whose track would sweep the start redirected away from it.
    """
    B = starts.shape[0]
    seg = goals[:, :2] - starts[:, :2]
    seg_len = np.maximum(np.linalg.norm(seg, axis=1, keepdims=True), 1e-6)
    d_hat = seg / seg_len
    perp = np.stack([-d_hat[:, 1], d_hat[:, 0]], axis=1)

    frac = rng.uniform(0.2, 0.9, (B, k)).astype(np.float32)
    lat = rng.normal(0.0, lateral_sigma, (B, k)).astype(np.float32)
    centers = (
        starts[:, None, :2]
        + frac[..., None] * seg[:, None, :]
        + lat[..., None] * perp[:, None, :]
    ).astype(np.float32)
    radii = rng.uniform(*radius_range, (B, k)).astype(np.float32)

    need = radii + inflation + endpoint_margin
    points = [goals[:, :2]] + [np.asarray(p)[:, :2] for p in clear_points]
    for _ in range(3 + 2 * bool(len(clear_points))):
        for p in points + [starts[:, :2]]:
            d = centers - p[:, None, :]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            push = np.maximum(need - dist, 0.0)
            centers = centers + d / dist[..., None] * push[..., None]

    orientation = rng.uniform(-np.pi, np.pi, (B, k)).astype(np.float32)
    v = np.zeros((B, k), np.float32)
    if n_dynamic > 0:
        v[:, :n_dynamic] = rng.uniform(0.3, 1.0, (B, n_dynamic))
        rel = centers - starts[:, None, :2]
        u = np.stack([np.cos(orientation), np.sin(orientation)], axis=-1)
        t_star = np.clip(-np.sum(rel * u, axis=-1), 0.0, None)
        closest = np.linalg.norm(rel + t_star[..., None] * u, axis=-1)
        sweep = (v > 0) & (closest < radii + inflation + endpoint_margin)
        away = np.arctan2(rel[..., 1], rel[..., 0]).astype(np.float32)
        orientation = np.where(sweep, away, orientation)
    return centers, radii, orientation, v


def free_problems(cfg, batch: int, *, seed: int = 0, dtype=torch.float32,
                  device=None):
    """Batched obstacle-free Problems."""
    from .solver.problem import default_problem

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    starts, goals = sample_endpoints(cfg, batch, rng)
    return default_problem(cfg, starts, goals, dtype=dtype, device=dev)


def obstacle_problems(
    cfg,
    batch: int,
    *,
    seed: int = 0,
    n_dynamic: int = 2,
    inflation: float = DEFAULT_INFLATION,
    dtype=torch.float32,
    device=None,
):
    """Batched obstacle-laden Problems through the production build path:
    sensor top-K selection, constant-velocity tracks at the plan's own dt,
    warm-start repair and feasible completion."""
    from .obstacles.obstacles import ObstacleSet
    from .solver.problem import problem_with_obstacles

    dev = resolve_device(device)
    K = cfg.max_obstacles
    if K <= 0:
        raise ValueError("obstacle_problems needs cfg.max_obstacles > 0")
    rng = np.random.default_rng(seed)
    starts, goals = sample_endpoints(cfg, batch, rng)
    centers, radii, orientation, v = sample_obstacle_field(
        starts, goals, K, rng, n_dynamic=n_dynamic, inflation=inflation
    )
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    obs = ObstacleSet(
        position=t(centers),
        radius=t(radii),
        orientation=t(orientation),
        linear_velocity=t(v),
        angular_velocity=torch.zeros((batch, K), dtype=dtype, device=dev),
        active=torch.ones((batch, K), dtype=dtype, device=dev),
    )
    return problem_with_obstacles(
        cfg, t(starts), t(goals), obs,
        sensor_radius=5.0,
        prediction_dt=cfg.time_step,
        inflation_radius=inflation,
        dtype=dtype,
        device=dev,
    )


def route_waypoints(
    starts: np.ndarray,  # [B, 3]
    waypoints: np.ndarray,  # [B, W, 3]
    centers: np.ndarray,  # [B, K, 2]
    radii: np.ndarray,  # [B, K]
    static_mask: np.ndarray,  # [B, K] bool: only static circles are routed
    inflation: float,
    margin: float = 0.25,
):
    """Insert one detour point per leg around the worst blocking static
    circle (a coarse stand-in for the reference's global plan): the foot of
    the perpendicular pushed out to radius + inflation + margin, or the leg's
    midpoint where nothing blocks, giving [B, 2W, 3]; then every routed
    point is projected out of every static disk."""
    B, W, _ = waypoints.shape
    out = np.zeros((B, 2 * W, 3), waypoints.dtype)
    prev = starts[:, :2]
    need = radii + inflation  # [B, K]
    for w in range(W):
        q = waypoints[:, w, :2]
        d = q - prev  # [B, 2]
        L2 = np.maximum(np.sum(d * d, axis=1, keepdims=True), 1e-9)
        t = np.clip(
            np.einsum("bkd,bd->bk", centers - prev[:, None, :], d) / L2,
            0.0, 1.0,
        )  # [B, K]
        foot = prev[:, None, :] + t[..., None] * d[:, None, :]  # [B, K, 2]
        away = foot - centers  # [B, K, 2]
        dist = np.linalg.norm(away, axis=-1)  # [B, K]
        depth = np.where(static_mask, need - dist, -np.inf)
        k = np.argmax(depth, axis=1)  # worst blocker per episode
        bi = np.arange(B)
        blocked = depth[bi, k] > 0.0
        a = away[bi, k]
        an = np.linalg.norm(a, axis=1, keepdims=True)
        # Dead-center fallback: go perpendicular-left of the leg.
        left = np.stack([-d[:, 1], d[:, 0]], axis=1) / np.sqrt(L2)
        a_hat = np.where(an > 1e-6, a / np.maximum(an, 1e-9), left)
        detour = centers[bi, k] + a_hat * (
            (need[bi, k] + margin)[:, None]
        )
        mid = 0.5 * (prev + q)
        pt = np.where(blocked[:, None], detour, mid)
        heading = np.arctan2(q[:, 1] - pt[:, 1], q[:, 0] - pt[:, 0])
        out[:, 2 * w, :2] = pt
        out[:, 2 * w, 2] = heading
        out[:, 2 * w + 1] = waypoints[:, w]
        prev = q
    # Inserted points can land inside other circles: push every routed
    # point out of every static disk, summed over all the disks it violates
    # (worst-only pushes cycle inside overlapping disks).
    for _ in range(6):
        for w in range(2 * W):
            p = out[:, w, :2]
            d = p[:, None, :] - centers  # [B, K, 2]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            depth = np.where(
                static_mask, need + margin * 0.5 - dist, -np.inf
            )
            push = np.maximum(depth, 0.0)  # [B, K]
            out[:, w, :2] = p + np.sum(
                d / dist[..., None] * push[..., None], axis=1
            )
    return out


def episode_worlds(
    cfg,
    batch: int,
    *,
    n_waypoints: int = 3,
    seed: int = 0,
    n_dynamic: int = 2,
    inflation: float = DEFAULT_INFLATION,
    route_around_obstacles: bool = False,
    router: str = "detour",
    dtype=torch.float32,
    device=None,
):
    """Batched receding-horizon episode worlds (the fleet-episode bench's):
    per episode a start pose, a chain of ``n_waypoints`` reachable hops and
    an obstacle field seeded along the first leg and cleared off every hop.

    Returns ``(env: EnvState[B], obstacles: ObstacleSet[B, K])`` for
    `environment.fleet_step`.  ``route_around_obstacles`` inserts a detour
    point per leg (`route_waypoints`); ``router="grid"``, the reference's
    batched grid planner (`kissmpc_tpu/planner.py`), is not ported yet.
    """
    from .environment import init_env
    from .obstacles.obstacles import ObstacleSet, empty

    dev = resolve_device(device)
    K = cfg.max_obstacles
    rng = np.random.default_rng(seed)
    starts, first_goal = sample_endpoints(cfg, batch, rng)
    # Waypoint chain: first hop = sampled goal, further hops random steps of
    # comparable length (a decimated global plan).
    hop_len = cfg.horizon * cfg.time_step * 0.5
    hops = [first_goal]
    for _ in range(n_waypoints - 1):
        r = rng.uniform(0.3 * hop_len, 1.0 * hop_len, (batch, 1))
        ang = rng.uniform(-np.pi, np.pi, (batch, 1))
        prev = hops[-1]
        hops.append(
            np.concatenate(
                [prev[:, 0:1] + r * np.cos(ang), prev[:, 1:2] + r * np.sin(ang),
                 rng.uniform(-3.1, 3.1, (batch, 1))],
                axis=1,
            ).astype(np.float32)
        )
    waypoints = np.stack(hops, axis=1)  # [B, W, 3]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    if K > 0:
        centers, radii, orientation, v = sample_obstacle_field(
            starts, first_goal, K, rng, n_dynamic=n_dynamic,
            inflation=inflation, clear_points=hops[1:],
        )
        obstacles = ObstacleSet(
            position=t(centers),
            radius=t(radii),
            orientation=t(orientation),
            linear_velocity=t(v),
            angular_velocity=torch.zeros((batch, K), dtype=dtype, device=dev),
            active=torch.ones((batch, K), dtype=dtype, device=dev),
        )
        if route_around_obstacles:
            if router == "grid":
                raise NotImplementedError(
                    'router="grid" needs the batched grid planner '
                    "(kissmpc_tpu/planner.py), which a later slice ports; "
                    'use router="detour"'
                )
            waypoints = route_waypoints(starts, waypoints, centers, radii, v == 0.0, inflation)
    else:
        obstacles = ObstacleSet(*(x.expand((batch,) + x.shape) for x in empty(0, dtype, dev)))
    return init_env(cfg, t(starts), t(waypoints), dtype=dtype, device=dev), obstacles
