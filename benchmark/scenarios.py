"""The scenario generator: raw scenarios drawn from a seed in numpy, handed
alike to the port and to the plain reference.

`sample_endpoints` and `sample_obstacle_field` are frozen copies of
`kissmpc_tpu_torch/scenarios.py` at commit d587314 (themselves copies of
the JAX package's numpy sampling).  `pool` draws a whole pool in a few
bulk calls.
"""

from __future__ import annotations

import numpy as np

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


def pool(horizon: int, time_step: float, size: int, k: int, n_dynamic: int, inflation: float,
         seed: int):
    """A pool of ``size`` raw scenarios from ``seed``: (starts [P, 3], goals
    [P, 3], centers [P, K, 2], radii [P, K], orientation [P, K], v [P, K]),
    float32, as `scenarios.obstacle_problems` draws its pool."""
    rng = np.random.default_rng(seed)

    class _Cfg:
        pass

    cfg = _Cfg()
    cfg.horizon, cfg.time_step = horizon, time_step
    starts, goals = sample_endpoints(cfg, size, rng)
    field = sample_obstacle_field(starts, goals, k, rng, n_dynamic=n_dynamic, inflation=inflation)
    return (starts, goals) + tuple(np.asarray(x, np.float32) for x in field)
