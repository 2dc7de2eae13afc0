"""Receding-horizon agent, batch-major (torch).

Port of `kissmpc_tpu/agent.py` (see there for the reference semantics it
keeps: ``state`` is column 1 of the last plan, commanded velocities latch
U[0], the plan is the next warm start, ``at_goal`` is the surface distance
to the goal within ``goal_radius``, inflation = radius + 0.1).  Every leaf
of an `AgentState` carries a leading batch axis B, where the reference
vmaps a single agent; a single agent is a batch of one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ._device import resolve_device
from .config import MPCConfig
from .obstacles import ObstacleSet, empty
from .obstacles import to_device as obstacles_to
from .solver.api import make_solver
from .solver.problem import Diagnostics, Problem, Solution, problem_with_obstacles


@dataclasses.dataclass(frozen=True)
class AgentParams:
    """Static agent parameters: a field-for-field copy of the reference's
    (defaults `mpc/agent.py:92-106`; the reference documents each)."""

    radius: float = 0.3
    sensor_radius: float = 5.0
    goal_radius: float = 0.5
    inflation_margin: float = 0.1  # added to radius (`mpc/agent.py:149`)
    control_bounds: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (-0.2, 0.5),
        (-0.5, 0.5),
    )
    state_bounds: Tuple[float, float] = (-20.0, 20.0)
    # A solve whose feasibility residual is above this (or NaN) is treated
    # as failed, and the previous plan, shifted by one step, is kept.
    fallback_feasibility: float = 1e-2
    # Prediction step of dynamic-obstacle tracks; None is the reference's
    # hardcoded 0.1 s.
    prediction_dt: Optional[float] = None
    # Re-roll the repaired warm start through the dynamics where the repair
    # moved it (fleet loops that trust their warm starts turn it off).
    complete_warm_starts: bool = True
    # A non-final waypoint not reached within this many consecutive ticks is
    # skipped (0 disables; see environment._advance_waypoint).
    stall_skip_ticks: int = 0

    @property
    def inflation_radius(self) -> float:
        return self.radius + self.inflation_margin


class AgentState(NamedTuple):
    """Everything the reference `Agent` mutates, for B agents."""

    states_matrix: torch.Tensor  # [B, N+1, 3] last plan / warm start
    controls_matrix: torch.Tensor  # [B, N, 2]
    linear_velocity: torch.Tensor  # [B] commanded v (U[0, 0])
    angular_velocity: torch.Tensor  # [B] commanded omega
    goal_state: torch.Tensor  # [B, 3]
    initial_state: torch.Tensor  # [B, 3] odometry-corrected pose


def to_device(agent: AgentState, device) -> AgentState:
    return AgentState(*(x.to(device) for x in agent))


def init_agent(cfg: MPCConfig, initial_state, goal_state=None, dtype=torch.float32,
               device=None) -> AgentState:
    """Fresh agents: plans tiled from the initial states, zero controls; the
    goal defaults to the initial state (`mpc/agent.py:39-43,59-60`).
    ``initial_state`` is [B, 3] or one [3] row."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(initial_state, dtype=dtype, device=dev).reshape(-1, 3)
    B = x0.shape[0]
    goal = x0 if goal_state is None else torch.as_tensor(
        goal_state, dtype=dtype, device=dev).broadcast_to((B, 3))
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    return AgentState(
        states_matrix=x0[:, None, :].expand(B, cfg.horizon + 1, 3).contiguous(),
        controls_matrix=torch.zeros((B, cfg.horizon, 2), dtype=dtype, device=dev),
        linear_velocity=zero,
        angular_velocity=zero,
        goal_state=goal.contiguous(),
        initial_state=x0,
    )


def current_state(agent: AgentState) -> torch.Tensor:
    """Reference `Agent.state`: column 1 of the last plan ([B, 3])."""
    return agent.states_matrix[:, 1]


def position(agent: AgentState) -> torch.Tensor:
    return current_state(agent)[:, :2]


def at_goal(params: AgentParams, agent: AgentState) -> torch.Tensor:
    """Surface distance to the goal <= goal_radius ([B] bool)."""
    d = torch.linalg.vector_norm(position(agent) - agent.goal_state[:, :2], dim=-1)
    return d - params.radius - params.goal_radius <= 0.0


def update_goal(agent: AgentState, goal) -> AgentState:
    g = agent.goal_state
    return agent._replace(
        goal_state=torch.as_tensor(goal, dtype=g.dtype, device=g.device).broadcast_to(g.shape)
    )


def reset(cfg: MPCConfig, agent: AgentState, matrices_only: bool = False,
          to_initial_state: bool = True) -> AgentState:
    """`mpc/agent.py:82-90`: re-tile the plans, zero the controls; a full
    reset also zeroes the commanded velocities."""
    base = agent.initial_state if to_initial_state else current_state(agent)
    new = agent._replace(
        states_matrix=base[:, None, :].expand(-1, cfg.horizon + 1, 3).contiguous(),
        controls_matrix=torch.zeros_like(agent.controls_matrix),
    )
    if not matrices_only:
        zero = torch.zeros_like(agent.linear_velocity)
        new = new._replace(linear_velocity=zero, angular_velocity=zero)
    return new


def build_problem(cfg: MPCConfig, params: AgentParams, agent: AgentState,
                  obstacles: Optional[ObstacleSet] = None,
                  state_override=False) -> Problem:
    """The tick's Problems: sensor filter, track prediction, warm-start
    repair and completion (`mpc/agent.py:139-152`).  ``obstacles`` has
    leaves [B, K_all] or, shared by every agent, [K_all].
    ``state_override`` (a bool or a [B] bool tensor) plans from
    ``initial_state`` instead of the advanced plan column."""
    B = agent.states_matrix.shape[0]
    dtype, dev = agent.states_matrix.dtype, agent.states_matrix.device
    if isinstance(state_override, torch.Tensor):
        start = torch.where(state_override[:, None], agent.initial_state, current_state(agent))
    else:
        start = agent.initial_state if state_override else current_state(agent)
    if obstacles is None:
        obstacles = empty(cfg.max_obstacles, dtype, dev)
    if obstacles.position.dim() == 2:
        obstacles = ObstacleSet(*(x.expand((B,) + x.shape) for x in obstacles))
    return problem_with_obstacles(
        cfg,
        start,
        agent.goal_state,
        obstacles,
        sensor_radius=params.sensor_radius,
        prediction_dt=params.prediction_dt,
        control_bounds=params.control_bounds,
        state_bounds=params.state_bounds,
        inflation_radius=params.inflation_radius,
        warm_states=agent.states_matrix,
        warm_controls=agent.controls_matrix,
        complete_warm_start_states=params.complete_warm_starts,
        dtype=dtype,
        device=dev,
    )


def apply_solution(params: AgentParams, agent: AgentState,
                   sol: Solution) -> Tuple[AgentState, Diagnostics]:
    """Post-solve update with the failure policy: a solve whose feasibility
    residual is unusable falls back to the previous plan shifted by one
    step.  The gate is NaN-safe: ``~(feas <= thresh)`` puts a NaN on the
    fallback side."""
    bad = ~(sol.diagnostics.kkt_feasibility <= params.fallback_feasibility)
    shifted_states = torch.cat([agent.states_matrix[:, 1:], agent.states_matrix[:, -1:]], dim=1)
    shifted_controls = torch.cat(
        [agent.controls_matrix[:, 1:], torch.zeros_like(agent.controls_matrix[:, -1:])], dim=1
    )
    b3 = bad[:, None, None]
    states = torch.where(b3, shifted_states, sol.states)
    controls = torch.where(b3, shifted_controls, sol.controls)
    new = agent._replace(
        states_matrix=states,
        controls_matrix=controls,
        linear_velocity=controls[:, 0, 0],
        angular_velocity=controls[:, 0, 1],
    )
    return new, sol.diagnostics


def step(cfg: MPCConfig, params: AgentParams, agent: AgentState,
         obstacles: Optional[ObstacleSet] = None, state_override=False, *,
         device=None) -> Tuple[AgentState, Diagnostics]:
    """One receding-horizon tick (`EgoAgent.step`, `mpc/agent.py:130-155`)
    for every agent of the batch, solved by `make_solver` (the split IPM) as
    the reference's `agent.step` uses `ipm.solve`.  Fleets batch the tick
    through `environment.fleet_step` (the configured backend, with
    refinement).  ``device=None`` runs on the card; the state is moved
    there."""
    dev = resolve_device(device)
    agent = to_device(agent, dev)
    problem = build_problem(cfg, params, agent, obstacles_to(obstacles, dev), state_override)
    return apply_solution(params, agent, make_solver(cfg, device=dev)(problem))
