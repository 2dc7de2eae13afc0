"""Benchmark scenario pools and episode worlds (torch builders over the
reference's sampling).

`sample_endpoints`, `sample_obstacle_field` and `route_waypoints` are copies
of the numpy code in `kissmpc_tpu/scenarios.py` (the port imports nothing of
the JAX package), so one seed gives bit-identical geometry in both packages.
`free_problems`, `obstacle_problems`, `episode_worlds` and `lab_worlds` build
the batches with the port's own builders; the grid router and `lab_worlds`
plan with the port's batched grid planner (`planner.py`).
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


def waypoint_hops(cfg, first_goal: np.ndarray, n_waypoints: int, rng: np.random.Generator):
    """An episode's waypoint chain [B, n_waypoints, 3]: the first hop is the
    sampled goal, each further hop a random step of comparable length (a
    decimated global plan), drawn as `kissmpc_tpu/scenarios.py` draws it."""
    batch = first_goal.shape[0]
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
    return np.stack(hops, axis=1)


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
    warm-start repair and feasible completion.  The sampling runs in numpy
    on the host; the build is one program through `graph.run` (the
    reference jits it, `kissmpc_tpu/scenarios.py:182`): one CUDA graph per
    (config, inflation, dtype and batch) on the card, replayed for a second
    pool of that shape."""
    from .obstacles.obstacles import ObstacleSet
    from .solver import graph
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

    def build(s, g, *o):
        return problem_with_obstacles(
            cfg, s, g, ObstacleSet(*o),
            sensor_radius=5.0,
            prediction_dt=cfg.time_step,
            inflation_radius=inflation,
            dtype=dtype,
            device=dev,
        )

    return graph.run(("scenarios.obstacle_problems", cfg, inflation, dtype), build, dev,
                     t(starts), t(goals), *obs)


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
    points_per_leg: int = 3,
    planner_grid: int = 64,
    return_info: bool = False,
    dtype=torch.float32,
    device=None,
):
    """Batched receding-horizon episode worlds (the fleet-episode bench's):
    per episode a start pose, a chain of ``n_waypoints`` reachable hops and
    an obstacle field seeded along the first leg and cleared off every hop.

    Returns ``(env: EnvState[B], obstacles: ObstacleSet[B, K])`` for
    `environment.fleet_step`.  ``route_around_obstacles`` routes the chain
    around the static circles: ``router="grid"`` with the batched grid
    planner (`planner.plan_waypoint_chain`: ``points_per_leg`` route points
    per leg plus the waypoint, on a ``planner_grid``-cell grid, run on
    ``device``), any other router with one detour point per leg
    (`route_waypoints`).  With ``return_info=True`` a third element is
    ``{"leg_reachable": [B, W'] bool}`` per routed leg: the grid router's
    connectivity, all True on every other path (K == 0 included).
    """
    from .environment import init_env
    from .obstacles.obstacles import ObstacleSet, empty

    dev = resolve_device(device)
    K = cfg.max_obstacles
    rng = np.random.default_rng(seed)
    starts, first_goal = sample_endpoints(cfg, batch, rng)
    leg_reach = None  # the grid router's [B, W] connectivity; else all True
    waypoints = waypoint_hops(cfg, first_goal, n_waypoints, rng)  # [B, W, 3]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    if K > 0:
        centers, radii, orientation, v = sample_obstacle_field(
            starts, first_goal, K, rng, n_dynamic=n_dynamic,
            inflation=inflation, clear_points=list(waypoints[:, 1:].swapaxes(0, 1)),
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
                from .planner import plan_waypoint_chain

                waypoints, leg_reach = plan_waypoint_chain(
                    starts, waypoints, centers, radii, v == 0.0, inflation,
                    points_per_leg=points_per_leg, grid=planner_grid, device=dev,
                )
            else:
                waypoints = route_waypoints(starts, waypoints, centers, radii, v == 0.0,
                                            inflation)
    else:
        obstacles = ObstacleSet(*(x.expand((batch,) + x.shape) for x in empty(0, dtype, dev)))
    env = init_env(cfg, t(starts), t(waypoints), dtype=dtype, device=dev)
    if return_info:
        if leg_reach is None:
            leg_reach = np.ones((batch, waypoints.shape[1]), bool)
        return env, obstacles, {"leg_reachable": leg_reach}
    return env, obstacles


def lab_worlds(
    cfg,
    batch: int,
    *,
    map_path,
    resolution: float = 0.05,
    seed: int = 0,
    goal_range=(2.0, 4.5),
    circles_per_episode: int = 24,
    max_circles: int = 400,
    inflation: float = DEFAULT_INFLATION,
    points_per_leg: int = 3,
    planner_grid: int = 96,
    n_dynamic: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Batched episode worlds on an occupancy map (the reference's own
    operating envelope, `mpc/environment.py:39-80` and
    `obstacle_handling/static_obstacle.py`), as `kissmpc_tpu/scenarios.py`'s
    `lab_worlds` builds them from the same ``map_path``, which is required
    here (the reference's default path belongs to one machine).

    Packs the map (a PGM, ``resolution`` meters per pixel) into circles,
    samples start/goal pairs in free space (clearance > inflation + 0.25 m,
    goal distance in ``goal_range``), routes each episode with the batched
    grid planner on ``device``, and hands each episode its
    ``circles_per_episode`` circles nearest the segment's midpoint; the
    per-tick sensor top-K selects the solver's K from these.
    ``n_dynamic`` adds that many walking humans per episode (r = 0.3,
    constant velocity 0.3-1.0 m/s near the route), appended after the
    static circles; humans whose straight-line track would sweep the pinned
    start are redirected radially away.  Advance them with
    `obstacles.advance` each tick.

    Returns ``(env: EnvState[B], obstacles: ObstacleSet[B, M + n_dynamic],
    info)`` with ``info["extent"]`` the map extent in meters,
    ``info["leg_reachable"]`` the router's per-leg connectivity and
    ``info["n_circles"]`` the circles the map packed into.  Map frames are
    large: pass AgentParams ``state_bounds`` that cover the extent.
    """
    from .environment import init_env
    from .obstacles.mapping import circles_to_world, pack_circles, read_pgm
    from .obstacles.obstacles import ObstacleSet
    from .planner import plan_waypoint_chain

    dev = resolve_device(device)
    img = read_pgm(map_path)
    centers_px, radii_px = pack_circles(
        img, min_radius=3.0, max_circles=max_circles
    )
    centers, radii = circles_to_world(
        centers_px, radii_px, resolution=resolution,
        map_height_px=img.shape[0],
    )
    rng = np.random.default_rng(seed)
    extent = np.array([img.shape[1], img.shape[0]]) * resolution

    def clearances(P):
        d = np.linalg.norm(
            P[:, None, :] - centers[None], axis=-1
        ) - radii
        return d.min(axis=1)

    pool = rng.uniform([0.5, 0.5], extent - 0.5, size=(120000, 2))
    pool = pool[clearances(pool) > inflation + 0.25]
    if len(pool) < 1000:
        raise ValueError("free-space pool too small for this map")

    starts_xy = np.zeros((batch, 2), np.float32)
    goals_xy = np.zeros((batch, 2), np.float32)
    n_done = 0
    while n_done < batch:
        s = pool[rng.integers(0, len(pool), batch)]
        g = pool[rng.integers(0, len(pool), batch)]
        d = np.linalg.norm(s - g, axis=1)
        ok = (d > goal_range[0]) & (d < goal_range[1])
        take = min(batch - n_done, int(ok.sum()))
        starts_xy[n_done:n_done + take] = s[ok][:take]
        goals_xy[n_done:n_done + take] = g[ok][:take]
        n_done += take

    starts = np.concatenate(
        [starts_xy, rng.uniform(-np.pi, np.pi, (batch, 1))], axis=1
    ).astype(np.float32)
    goals = np.concatenate(
        [goals_xy, rng.uniform(-np.pi, np.pi, (batch, 1))], axis=1
    ).astype(np.float32)

    M = circles_per_episode
    mid = 0.5 * (starts_xy + goals_xy)
    d_mid = np.linalg.norm(
        mid[:, None, :] - centers[None], axis=-1
    ) - radii
    idx = np.argsort(d_mid, axis=1)[:, :M]
    ep_centers = centers[idx].astype(np.float32)
    ep_radii = radii[idx].astype(np.float32)

    waypoints, leg_reach = plan_waypoint_chain(
        starts, goals[:, None, :], ep_centers, ep_radii,
        np.ones((batch, M), bool), inflation,
        points_per_leg=points_per_leg, grid=planner_grid, device=dev,
    )
    all_centers = ep_centers
    all_radii = ep_radii
    orientation = np.zeros((batch, M), np.float32)
    lin_v = np.zeros((batch, M), np.float32)
    if n_dynamic > 0:
        D = n_dynamic
        HUMAN_R = 0.3  # `obstacle_handling/dynamic_obstacle.py:9`
        frac = rng.uniform(0.3, 0.7, (batch, D)).astype(np.float32)
        seg = goals_xy - starts_xy
        lat = rng.uniform(0.5, 1.5, (batch, D)).astype(np.float32)
        lat *= rng.choice([-1.0, 1.0], (batch, D)).astype(np.float32)
        perp = np.stack([-seg[:, 1], seg[:, 0]], axis=1)
        perp /= np.maximum(np.linalg.norm(perp, axis=1, keepdims=True), 1e-6)
        h_pos = (
            starts_xy[:, None, :]
            + frac[..., None] * seg[:, None, :]
            + lat[..., None] * perp[:, None, :]
        ).astype(np.float32)
        # push clear of goal then start (start last: the pinned initial
        # state inside an inflated human is infeasible by construction)
        need = HUMAN_R + inflation + 0.12
        for p in (goals_xy, starts_xy):
            d = h_pos - p[:, None, :]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            push = np.maximum(need - dist, 0.0)
            h_pos = h_pos + d / dist[..., None] * push[..., None]
        h_ori = rng.uniform(-np.pi, np.pi, (batch, D)).astype(np.float32)
        h_v = rng.uniform(0.3, 1.0, (batch, D)).astype(np.float32)
        # redirect tracks that would sweep the pinned start
        rel = h_pos - starts_xy[:, None, :]
        u = np.stack([np.cos(h_ori), np.sin(h_ori)], axis=-1)
        t_star = np.clip(-np.sum(rel * u, axis=-1), 0.0, None)
        closest = np.linalg.norm(rel + t_star[..., None] * u, axis=-1)
        sweep = closest < need
        away = np.arctan2(rel[..., 1], rel[..., 0]).astype(np.float32)
        h_ori = np.where(sweep, away, h_ori)
        all_centers = np.concatenate([ep_centers, h_pos], axis=1)
        all_radii = np.concatenate(
            [ep_radii, np.full((batch, D), HUMAN_R, np.float32)], axis=1
        )
        orientation = np.concatenate([orientation, h_ori], axis=1)
        lin_v = np.concatenate([lin_v, h_v], axis=1)
    MT = M + n_dynamic
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    obstacles = ObstacleSet(
        position=t(all_centers),
        radius=t(all_radii),
        orientation=t(orientation),
        linear_velocity=t(lin_v),
        angular_velocity=torch.zeros((batch, MT), dtype=dtype, device=dev),
        active=torch.ones((batch, MT), dtype=dtype, device=dev),
    )
    env = init_env(cfg, t(starts), t(waypoints), dtype=dtype, device=dev)
    info = {
        "extent": extent,
        "leg_reachable": np.asarray(leg_reach),
        "n_circles": int(len(radii)),
    }
    return env, obstacles, info
