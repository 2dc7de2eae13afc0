"""Obstacle populations as struct-of-arrays torch tensors.

Port of `kissmpc_tpu/obstacles/obstacles.py` (see there for the repairs
relative to the reference).  Every field of an `ObstacleSet` shares leading
dims ``[..., K]``; a batch of populations carries a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device

# Reference defaults (`obstacle_handling/dynamic_obstacle.py:8-9,21`).
HUMAN_RADIUS = 0.3
PREDICTION_DT = 0.1


class ObstacleSet(NamedTuple):
    """Fixed-size population of circular obstacles; ``active`` masks padding."""

    position: torch.Tensor  # [..., K, 2]
    radius: torch.Tensor  # [..., K]
    orientation: torch.Tensor  # [..., K]  heading (radians)
    linear_velocity: torch.Tensor  # [..., K]
    angular_velocity: torch.Tensor  # [..., K]
    active: torch.Tensor  # [..., K]  1.0 = real, 0.0 = padding

    @property
    def size(self) -> int:
        return self.position.shape[-2]


def to_device(obs: ObstacleSet | None, device) -> ObstacleSet | None:
    """Every field moved to ``device``; None stays None."""
    return None if obs is None else ObstacleSet(*(x.to(device) for x in obs))


def empty(max_obstacles: int, dtype=torch.float32, device=None) -> ObstacleSet:
    dev = resolve_device(device)
    z = torch.zeros((max_obstacles,), dtype=dtype, device=dev)
    return ObstacleSet(
        position=torch.zeros((max_obstacles, 2), dtype=dtype, device=dev),
        radius=z,
        orientation=z,
        linear_velocity=z,
        angular_velocity=z,
        active=z,
    )


def _padded(x, n, full):
    out = full.clone()
    out[:n] = x
    return out


def static_set(centers, radii, max_obstacles=None, dtype=torch.float32,
               device=None) -> ObstacleSet:
    """Build a (padded) static obstacle population from circle arrays."""
    dev = resolve_device(device)
    centers = torch.as_tensor(centers, dtype=dtype, device=dev).reshape(-1, 2)
    radii = torch.as_tensor(radii, dtype=dtype, device=dev).reshape(-1)
    n = centers.shape[0]
    K = max_obstacles if max_obstacles is not None else n
    if n > K:
        raise ValueError(f"{n} obstacles > capacity {K}")
    out = empty(K, dtype, dev)
    return out._replace(
        position=_padded(centers, n, out.position),
        radius=_padded(radii, n, out.radius),
        active=(torch.arange(K, device=dev) < n).to(dtype),
    )


def dynamic_set(
    positions,
    orientations,
    linear_velocities,
    angular_velocities=None,
    radius=HUMAN_RADIUS,
    max_obstacles=None,
    dtype=torch.float32,
    device=None,
) -> ObstacleSet:
    """Build a (padded) dynamic-obstacle population (reference humans:
    radius 0.3, `obstacle_handling/dynamic_obstacle.py:8-9`)."""
    dev = resolve_device(device)
    positions = torch.as_tensor(positions, dtype=dtype, device=dev).reshape(-1, 2)
    n = positions.shape[0]

    def vec(x):
        return torch.as_tensor(x, dtype=dtype, device=dev).broadcast_to((n,))

    angular = vec(0.0 if angular_velocities is None else angular_velocities)
    K = max_obstacles if max_obstacles is not None else n
    if n > K:
        raise ValueError(f"{n} obstacles > capacity {K}")
    out = empty(K, dtype, dev)
    return out._replace(
        position=_padded(positions, n, out.position),
        radius=_padded(vec(radius), n, out.radius),
        orientation=_padded(vec(orientations), n, out.orientation),
        linear_velocity=_padded(vec(linear_velocities), n, out.linear_velocity),
        angular_velocity=_padded(angular, n, out.angular_velocity),
        active=(torch.arange(K, device=dev) < n).to(dtype),
    )


def distance_to_point(obs: ObstacleSet, point) -> torch.Tensor:
    """Signed surface distance |p - c| - r per obstacle ([..., K]); inactive
    slots report +inf."""
    p = torch.as_tensor(point, dtype=obs.position.dtype,
                        device=obs.position.device)[..., :2]
    d = torch.linalg.vector_norm(obs.position - p.unsqueeze(-2), dim=-1) - obs.radius
    return torch.where(obs.active > 0.5, d, torch.full_like(d, float("inf")))


def predict_tracks(obs: ObstacleSet, horizon: int, dt: float = PREDICTION_DT):
    """Constant-velocity unicycle forward prediction -> centers [..., K, N, 2].

    Column t is the position after t prediction steps (column 0 = current
    position), in the reference's closed form (prefix sum of per-step
    displacements).
    """
    j = torch.arange(horizon, dtype=obs.position.dtype, device=obs.position.device)
    theta_j = obs.orientation[..., None] + obs.angular_velocity[..., None] * dt * j
    step = (obs.linear_velocity * dt)[..., None, None] * torch.stack(
        [torch.cos(theta_j), torch.sin(theta_j)], dim=-1
    )  # [..., K, N, 2]
    cs = torch.cumsum(step[..., :-1, :], dim=-2)
    return obs.position[..., None, :] + torch.cat(
        [torch.zeros_like(step[..., :1, :]), cs], dim=-2
    )


def advance(obs: ObstacleSet, dt: float) -> ObstacleSet:
    """One world-clock step of the constant-velocity unicycle obstacle model
    (the closed-loop counterpart of `predict_tracks`): move by v*dt along
    the heading, then turn by w*dt.  Inactive slots don't move."""
    act = obs.active > 0.5
    move = torch.stack(
        [obs.linear_velocity * torch.cos(obs.orientation) * dt,
         obs.linear_velocity * torch.sin(obs.orientation) * dt],
        dim=-1,
    )
    zero = torch.zeros((), dtype=obs.position.dtype, device=obs.position.device)
    return obs._replace(
        position=obs.position + torch.where(act[..., None], move, zero),
        orientation=obs.orientation + torch.where(act, obs.angular_velocity * dt, zero),
    )


def clearance_to_point(obs: ObstacleSet, point, robot_radius: float = 0.0):
    """True physical clearance min_k |p - c_k| - r_k - r_robot ([...])."""
    d = distance_to_point(obs, point) - robot_radius
    return torch.amin(d, dim=-1)


def select_nearest(obs: ObstacleSet, point, sensor_radius: float, k: int) -> ObstacleSet:
    """Top-k nearest active obstacles within the sensor radius, as a
    fixed-size masked set.

    The order matches `jax.lax.top_k`: by distance, ties to the lower slot
    index (a stable descending sort of the negated distance).
    """
    d = distance_to_point(obs, point)  # inf for inactive
    neg = torch.where(torch.isfinite(d), -d, torch.full_like(d, float("-inf")))
    idx = torch.sort(neg, dim=-1, descending=True, stable=True).indices[..., :k]

    def take(x):
        if x.dim() == idx.dim():
            return torch.gather(x, -1, idx)
        return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))

    chosen = ObstacleSet(*(take(x) for x in obs))
    within = distance_to_point(chosen, point) <= sensor_radius
    return chosen._replace(active=chosen.active * within.to(chosen.active.dtype))
