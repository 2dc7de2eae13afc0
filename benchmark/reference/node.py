"""The single-robot node's tick as plain PyTorch: the robot's problem from
the odometry pose, the goal and the obstacle set, its split IPM solve, and
the waypoint advance.

Written for the benchmark after `kissmpc_tpu_torch/io/model.py::Model.step`
at commit d587314, on the reference's frozen build (`problem.py`) and
split solve (`ipm.solve_plain`).  With a fresh odometry pose every tick the
node resets its warm start to the pose tiled over the horizon and zero
controls (`io/pubsub.py::ControlLoop.tick`), so a tick is a function of
its pose, its goal and its obstacle set.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ipm
from .obstacles import ObstacleSet
from .problem import problem_with_obstacles

GOAL_RADIUS = 0.5  # AgentParams.goal_radius
INFLATION_MARGIN = 0.1  # AgentParams.inflation_margin


def ticks(cfg, config: dict, poses, goals, obstacles: ObstacleSet, dtype, device="cpu"):
    """T ticks at once, each from its own pose [T, 3], goal [T, 3] and
    obstacle set ([T, K_all] leaves): the ticks share nothing, so they
    are solved as one batch.  Returns (problems, solution)."""
    N = cfg.horizon
    start = torch.as_tensor(np.asarray(poses, np.float64), dtype=dtype, device=device)
    T = start.shape[0]
    (vl, vu), (wl, wu) = config["control_bounds"]
    problem = problem_with_obstacles(
        cfg, start,
        torch.as_tensor(np.asarray(goals, np.float64), dtype=dtype, device=device),
        ObstacleSet(*(torch.as_tensor(x, dtype=dtype, device=device) for x in obstacles)),
        sensor_radius=float(config["sensor_radius"]),
        control_bounds=((float(vl), float(vu)), (float(wl), float(wu))),
        state_bounds=tuple(float(b) for b in config["state_bounds"]),
        inflation_radius=float(config["radius"]) + INFLATION_MARGIN,
        warm_states=start[:, None, :].expand(T, N + 1, 3).contiguous(),
        warm_controls=torch.zeros((T, N, 2), dtype=dtype, device=device),
        dtype=dtype, device=device,
    )
    return problem, ipm.solve_plain(cfg, problem)


def at_goal(state, goal, radius: float) -> bool:
    """The node's goal test on the plan's second state."""
    d = float(np.linalg.norm(np.asarray(state[:2]) - np.asarray(goal[:2]))) - radius
    return d - GOAL_RADIUS <= 0.0
