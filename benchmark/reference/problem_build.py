"""Frozen copy of `kissmpc_tpu_torch/ops/problem_build.py` at commit d587314
(`build_plain` only).

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""
from __future__ import annotations

import torch

from ._device import resolve_device
from .obstacles import ObstacleSet
from .problem import (
    COMPLETION_THRESHOLD, SENSOR_RADIUS, Problem, complete_warm_start, default_problem,
    repair_warm_start,
)

# `solver/problem.py::repair_warm_start`'s margin and passes, as the build uses them.
REPAIR_MARGIN = 0.02
REPAIR_PASSES = 3


def build_plain(cfg, initial_state, goal_state, obstacles: ObstacleSet, *,
                sensor_radius: float = SENSOR_RADIUS, prediction_dt: float | None = None,
                repair_warm_start_states: bool = True, complete_warm_start_states: bool = True,
                completion_threshold: float = COMPLETION_THRESHOLD, **kwargs) -> Problem:
    """`solver/problem.py::problem_with_obstacles` as plain PyTorch: sensor
    top-K filter, constant-velocity track prediction, `default_problem`'s
    rows, warm-start repair, and the feasibility rollout where the repair
    moved the warm start by more than ``completion_threshold``.  The plain
    version of the build kernel."""
    from . import obstacles as obs_mod

    dtype = kwargs.get("dtype", torch.float32)
    dev = resolve_device(kwargs.get("device"))
    initial_state = torch.as_tensor(initial_state, dtype=dtype, device=dev).reshape(-1, 3)
    nearest = obs_mod.select_nearest(
        obstacles, initial_state[:, :2], sensor_radius, cfg.max_obstacles
    )
    dt = obs_mod.PREDICTION_DT if prediction_dt is None else prediction_dt
    tracks = obs_mod.predict_tracks(nearest, cfg.horizon, dt)
    problem = default_problem(
        cfg,
        initial_state,
        goal_state,
        obstacle_centers=tracks,
        obstacle_radii=nearest.radius,
        obstacle_mask=nearest.active,
        **kwargs,
    )
    if cfg.max_obstacles == 0 or not (
        repair_warm_start_states or complete_warm_start_states
    ):
        return problem
    if repair_warm_start_states:
        repaired = repair_warm_start(
            problem.warm_states,
            problem.obstacle_centers,
            problem.obstacle_radii,
            problem.obstacle_mask,
            problem.inflation_radius,
            margin=REPAIR_MARGIN,
            passes=REPAIR_PASSES,
        )
    else:
        repaired = problem.warm_states
    if not complete_warm_start_states:
        return problem._replace(warm_states=repaired)
    if repair_warm_start_states:
        moved = torch.amax(torch.abs(repaired - problem.warm_states), dim=(1, 2))
    else:
        diff = problem.warm_states[:, 1:, None, :2] - problem.obstacle_centers.transpose(1, 2)
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, N, K]
        intrusion = (
            problem.obstacle_radii[:, None, :]
            + problem.inflation_radius[:, None, None]
            - dist
        )
        moved = torch.amax(
            torch.where(
                problem.obstacle_mask[:, None, :] > 0.5,
                intrusion,
                torch.zeros_like(intrusion),
            ),
            dim=(1, 2),
        )
    rolled_states, rolled_controls = complete_warm_start(
        repaired,
        problem.initial_state,
        problem.control_lower,
        problem.control_upper,
        problem.obstacle_centers,
        problem.obstacle_radii,
        problem.obstacle_mask,
        problem.inflation_radius,
        cfg.time_step,
    )
    roll = moved > completion_threshold
    return problem._replace(
        warm_states=torch.where(roll[:, None, None], rolled_states, repaired),
        warm_controls=torch.where(
            roll[:, None, None], rolled_controls, problem.warm_controls
        ),
    )
