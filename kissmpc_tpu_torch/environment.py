"""Waypoint-following episode loop, batch-major (torch).

Port of `kissmpc_tpu/environment.py`: an `EnvState` holds B episodes (a
batch of agents, each with its waypoint chain [W, 3], index and stall
counter), where the reference vmaps a single episode.  `step` runs one tick
through the agent's split solve, `fleet_step` one tick through one
`solve_batch` call (the configured backend, with refinement: the reference's
production path), and `run_episode` loops `step` in Python where the
reference uses `lax.scan`, stacking the `StepInfo`s time-major.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import agent as agent_mod
from ._device import resolve_device
from .agent import AgentParams, AgentState
from .config import MPCConfig
from .obstacles import ObstacleSet
from .obstacles import to_device as obstacles_to
from .solver.api import solve_batch
from .solver.problem import Diagnostics


class EnvState(NamedTuple):
    agent: AgentState
    waypoint_index: torch.Tensor  # [B] int64
    waypoints: torch.Tensor  # [B, W, 3]
    # ticks since the waypoint index last advanced (the stall-skip policy)
    stall_ticks: torch.Tensor  # [B] int64


class StepInfo(NamedTuple):
    diagnostics: Diagnostics
    # reached the current OR a later waypoint this tick (skip-ahead)
    at_goal: torch.Tensor
    final_goal_reached: torch.Tensor  # the last waypoint itself was reached
    waypoint_index: torch.Tensor


def to_device(env: EnvState, device) -> EnvState:
    return EnvState(agent_mod.to_device(env.agent, device), env.waypoint_index.to(device),
                    env.waypoints.to(device), env.stall_ticks.to(device))


def init_env(cfg: MPCConfig, initial_state, waypoints, dtype=torch.float32,
             device=None) -> EnvState:
    """B episodes from initial states [B, 3] and waypoint chains [B, W, 3]
    (one [3] / [W, 3] is a batch of one); each agent's goal is its first
    waypoint."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(initial_state, dtype=dtype, device=dev).reshape(-1, 3)
    B = x0.shape[0]
    wps = torch.as_tensor(waypoints, dtype=dtype, device=dev)
    wps = wps.reshape(B, -1, 3) if wps.dim() == 3 else wps.reshape(-1, 3).expand(B, -1, 3)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    return EnvState(
        agent=agent_mod.init_agent(cfg, x0, goal_state=wps[:, 0], dtype=dtype, device=dev),
        waypoint_index=zero,
        waypoints=wps.contiguous(),
        stall_ticks=zero,
    )


def current_waypoint(env: EnvState) -> torch.Tensor:
    W = env.waypoints.shape[1]
    idx = torch.clamp(env.waypoint_index, 0, W - 1)
    return env.waypoints[torch.arange(idx.shape[0], device=idx.device), idx]


def final_goal_reached(params: AgentParams, env: EnvState) -> torch.Tensor:
    is_last = env.waypoint_index >= env.waypoints.shape[1] - 1
    return is_last & agent_mod.at_goal(params, env.agent)


def _advance_waypoint(params: AgentParams, env: EnvState, new_agent: AgentState,
                      diag) -> Tuple[EnvState, StepInfo]:
    """Post-solve waypoint bookkeeping (`mpc/environment.py:77-80`), with
    the reference's two policies beyond advance-on-reach:

    * skip-ahead: reaching ANY not-yet-visited waypoint advances the index
      past the furthest one reached;
    * stall-skip (``params.stall_skip_ticks > 0``): a non-final waypoint
      not reached for that many consecutive ticks is skipped; the final one
      never is.
    """
    W = env.waypoints.shape[1]
    pos = agent_mod.position(new_agent)
    d = torch.linalg.vector_norm(env.waypoints[..., :2] - pos[:, None], dim=-1) - params.radius
    idx_row = torch.arange(W, device=d.device)
    hit = (d <= params.goal_radius) & (idx_row >= env.waypoint_index[:, None])
    furthest = torch.amax(torch.where(hit, idx_row, torch.full_like(hit, -1, dtype=idx_row.dtype)),
                          dim=1)
    reached = furthest >= 0
    new_index = torch.where(reached, torch.clamp(furthest + 1, max=W - 1), env.waypoint_index)
    final_reached = hit[:, W - 1]
    advanced = new_index > env.waypoint_index
    stall = torch.where(advanced, torch.zeros_like(env.stall_ticks), env.stall_ticks + 1)
    if params.stall_skip_ticks:
        skip = (stall >= params.stall_skip_ticks) & (new_index < W - 1) & ~final_reached
        new_index = new_index + skip.to(new_index.dtype)
        stall = torch.where(skip, torch.zeros_like(stall), stall)
    rows = torch.arange(new_index.shape[0], device=new_index.device)
    new_env = EnvState(
        agent=new_agent._replace(
            goal_state=env.waypoints[rows, torch.clamp(new_index, 0, W - 1)]),
        waypoint_index=new_index,
        waypoints=env.waypoints,
        stall_ticks=stall,
    )
    info = StepInfo(diagnostics=diag, at_goal=reached, final_goal_reached=final_reached,
                    waypoint_index=new_index)
    return new_env, info


def step(cfg: MPCConfig, params: AgentParams, env: EnvState,
         obstacles: Optional[ObstacleSet] = None, *,
         device=None) -> Tuple[EnvState, StepInfo]:
    """One environment tick (`mpc/environment.py:39-80`): the agents' split
    solves, then the waypoint bookkeeping.  ``obstacles`` has leaves
    [B, K_all] or, shared, [K_all].  ``device=None`` runs on the card."""
    dev = resolve_device(device)
    env = to_device(env, dev)
    new_agent, diag = agent_mod.step(cfg, params, env.agent, obstacles, device=dev)
    return _advance_waypoint(params, env, new_agent, diag)


def fleet_step(cfg: MPCConfig, params: AgentParams, env: EnvState,
               obstacles: Optional[ObstacleSet] = None, *,
               device=None) -> Tuple[EnvState, StepInfo]:
    """One tick of B episodes with their B solves as one `solve_batch`
    call: the configured backend (the fused kernel by default) with staged
    refinement, between the batched problem construction and the batched
    bookkeeping.  The reference's production fleet path
    (`kissmpc_tpu/environment.py:168-200`).  ``device=None`` runs on the
    card; the state is moved there."""
    dev = resolve_device(device)
    env = to_device(env, dev)
    problems = agent_mod.build_problem(cfg, params, env.agent, obstacles_to(obstacles, dev))
    sol = solve_batch(cfg, problems, device=dev)
    new_agent, diag = agent_mod.apply_solution(params, env.agent, sol)
    return _advance_waypoint(params, env, new_agent, diag)


def run_episode(cfg: MPCConfig, params: AgentParams, env: EnvState, num_steps: int,
                obstacles: Optional[ObstacleSet] = None, *,
                device=None) -> Tuple[EnvState, StepInfo]:
    """Roll ``num_steps`` ticks of `step`; the StepInfo leaves come back
    stacked time-major ([num_steps, B])."""
    dev = resolve_device(device)
    infos = []
    for _ in range(num_steps):
        env, info = step(cfg, params, env, obstacles, device=dev)
        infos.append(info)
    stack = lambda xs: torch.stack(list(xs), dim=0)
    return env, StepInfo(
        diagnostics=Diagnostics(*(stack(f) for f in zip(*(i.diagnostics for i in infos)))),
        at_goal=stack(i.at_goal for i in infos),
        final_goal_reached=stack(i.final_goal_reached for i in infos),
        waypoint_index=stack(i.waypoint_index for i in infos),
    )
