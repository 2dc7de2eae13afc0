"""Frozen copy of `kissmpc_tpu_torch/solver/problem.py` at commit d587314
(`problem_with_obstacles` builds by the plain `build_plain`).

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._device import constant, resolve_device
from .config import MPCConfig

# `default_problem`'s bounds (`EgoAgent`'s, `mpc/agent.py:104-105`): the
# control box ((v_lb, v_ub), (omega_lb, omega_ub)) and the state box on x
# (and y).  `problem_with_obstacles`' sensor radius and completion
# threshold.  The build kernel's card path takes its defaults from here.
CONTROL_BOUNDS = ((-0.2, 0.5), (-0.5, 0.5))
STATE_BOUNDS = (-20.0, 20.0)
SENSOR_RADIUS = 5.0
COMPLETION_THRESHOLD = 0.05


class Problem(NamedTuple):
    """A batch of MPC scenarios (leading axis B on every leaf)."""

    initial_state: torch.Tensor  # [B, 3]
    goal_state: torch.Tensor  # [B, 3]
    control_lower: torch.Tensor  # [B, 2]  (v_lb, omega_lb)
    control_upper: torch.Tensor  # [B, 2]
    state_lower: torch.Tensor  # [B, 3]  (+-inf for unbounded rows)
    state_upper: torch.Tensor  # [B, 3]
    obstacle_centers: torch.Tensor  # [B, K, N, 2] per-timestep tracks
    obstacle_radii: torch.Tensor  # [B, K]
    obstacle_mask: torch.Tensor  # [B, K]  1.0 = real, 0.0 = padding
    inflation_radius: torch.Tensor  # [B]
    warm_states: torch.Tensor  # [B, N+1, 3]
    warm_controls: torch.Tensor  # [B, N, 2]


class Diagnostics(NamedTuple):
    """Per-scenario solver diagnostics ([B] each)."""

    converged: torch.Tensor  # bool: final KKT residuals below tolerance
    kkt_stationarity: torch.Tensor
    kkt_feasibility: torch.Tensor
    kkt_complementarity: torch.Tensor
    final_cost: torch.Tensor
    final_mu: torch.Tensor


class Solution(NamedTuple):
    states: torch.Tensor  # [B, N+1, 3]
    controls: torch.Tensor  # [B, N, 2]
    diagnostics: Diagnostics


def gather(problem: Problem, idx) -> Problem:
    """Rows ``idx`` of every leaf."""
    return Problem(*(x[idx] for x in problem))


def to_device(problem: Problem, device) -> Problem:
    return Problem(*(x.to(device) for x in problem))


def _one_hot(index: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """``one_hot(index, K).to(dtype)`` without `one_hot`'s check of the index
    range, which reads the indices back to the host."""
    return (index[..., None] == torch.arange(K, device=index.device)).to(dtype)


def repair_warm_start(
    warm_states: torch.Tensor,  # [B, N+1, 3]
    obstacle_centers: torch.Tensor,  # [B, K, N, 2]
    obstacle_radii: torch.Tensor,  # [B, K]
    obstacle_mask: torch.Tensor,  # [B, K]
    inflation_radius: torch.Tensor,  # [B]
    margin: float = 0.02,
    passes: int = 3,
) -> torch.Tensor:
    """Project warm-start states out of obstacle interiors by a lateral push
    (radial where the trajectory has no tangent); see the reference
    docstring for why the push is lateral."""
    states = warm_states.clone()
    dtype = states.dtype
    needed = obstacle_radii[:, None, :] + inflation_radius[:, None, None] + margin
    eps = 1e-9
    centers = obstacle_centers.transpose(1, 2)  # [B, N, K, 2]
    active = obstacle_mask[:, None, :] > 0.5
    K = obstacle_radii.shape[1]
    right = constant((1.0, 0.0), dtype, states.device)

    for _ in range(passes):
        p = states[:, 1:, :2]  # [B, N, 2]
        diff = p[:, :, None, :] - centers  # [B, N, K, 2]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, N, K]
        push = torch.where(
            active, torch.clamp(needed - dist, min=0.0), torch.zeros_like(dist)
        )
        onehot = _one_hot(torch.argmax(push, dim=-1), K, dtype)  # [B, N, K]
        push_star = torch.sum(push * onehot, dim=-1)
        diff_star = torch.sum(diff * onehot[..., None], dim=-2)
        dist_star = torch.clamp(torch.sum(dist * onehot, dim=-1), min=eps)
        needed_star = torch.sum(needed.expand(dist.shape) * onehot, dim=-1)
        n = torch.where(
            dist_star[..., None] > 1e-6, diff_star / dist_star[..., None], right
        )

        p_prev = torch.cat([states[:, 0:1, :2], p[:, :-1]], dim=1)
        p_next = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
        t = p_next - p_prev
        t_norm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
        have_t = t_norm[..., 0] > 1e-9
        t_hat = t / torch.clamp(t_norm, min=eps)
        lateral = torch.stack([-t_hat[..., 1], t_hat[..., 0]], dim=-1)
        a_signed = torch.sum(diff_star * lateral, dim=-1)
        lateral = torch.where(a_signed[..., None] < 0, -lateral, lateral)
        a = torch.abs(a_signed)
        d_lat = -a + torch.sqrt(
            torch.clamp(a * a + needed_star**2 - dist_star**2, min=0.0)
        )
        direction = torch.where(have_t[..., None], lateral, n)
        magnitude = torch.where(have_t, d_lat, push_star)
        magnitude = torch.where(push_star > 0, magnitude, torch.zeros_like(magnitude))
        states[:, 1:, :2] = p + direction * magnitude[..., None]
    return states


def complete_warm_start(
    warm_states: torch.Tensor,  # [B, N+1, 3] target path
    initial_state: torch.Tensor,  # [B, 3]
    control_lower: torch.Tensor,  # [B, 2]
    control_upper: torch.Tensor,  # [B, 2]
    obstacle_centers: torch.Tensor,  # [B, K, N, 2]
    obstacle_radii: torch.Tensor,  # [B, K]
    obstacle_mask: torch.Tensor,  # [B, K]
    inflation_radius: torch.Tensor,  # [B]
    dt,
):
    """Re-roll a repaired path through the real dynamics with a
    collision-gated tracking controller (wall-following around blocking
    disks), so the warm start is feasible by construction.  The reference's
    `lax.scan` over the horizon is a loop over N here.
    Returns (states [B, N+1, 3], controls [B, N, 2]).
    """
    dtype = warm_states.dtype
    inf = float("inf")
    v_lb = torch.clamp(control_lower[:, 0], min=0.0)
    v_ub = control_upper[:, 0]
    w_lb, w_ub = control_lower[:, 1], control_upper[:, 1]
    R = torch.where(
        obstacle_mask > 0.5,
        obstacle_radii + inflation_radius[:, None],
        torch.full_like(obstacle_radii, -inf),
    )  # [B, K]
    finite_R = torch.isfinite(R)
    K = obstacle_radii.shape[1]
    x0 = initial_state.to(dtype)
    state = x0
    rows, controls = [x0], []
    for t in range(warm_states.shape[1] - 1):
        q = warm_states[:, t + 1, :2]
        p, th = state[:, :2], state[:, 2]
        to_q = q - p
        dist_q = torch.sqrt(torch.sum(to_q * to_q, dim=-1) + 1e-18)
        phi = torch.where(dist_q > 1e-6, torch.atan2(to_q[:, 1], to_q[:, 0]), th)
        e = torch.atan2(torch.sin(phi - th), torch.cos(phi - th))
        v_des = torch.clamp(dist_q / dt * torch.clamp(torch.cos(e), min=0.0), v_lb, v_ub)
        if K == 0:
            cap_min = torch.full_like(v_des, inf)
            phi_eff = phi
        else:
            u = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)  # [B, 2]
            rel = p[:, None, :] - obstacle_centers[:, :, t, :]  # [B, K, 2]
            a = dt * dt
            b = 2.0 * dt * torch.sum(rel * u[:, None, :], dim=-1)
            c0 = torch.sum(rel * rel, dim=-1) - R * R
            disc = b * b - 4.0 * a * c0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            v1 = (-b - sq) / (2.0 * a)
            v2 = (-b + sq) / (2.0 * a)
            inf_t = torch.full_like(v1, inf)
            cap_out = torch.where(
                (disc > 0.0) & (v2 > 0.0), torch.clamp(v1, min=0.0), inf_t
            )
            cap = torch.where(
                c0 < 0.0, torch.where(b > 0.0, inf_t, torch.zeros_like(v1)), cap_out
            )
            cap = torch.where(finite_R, cap, inf_t)
            cap_min = torch.amin(cap, dim=-1)

            k_blk = torch.argmin(cap, dim=-1)
            rel_b = torch.gather(rel, 1, k_blk[:, None, None].expand(-1, 1, 2))[:, 0]
            rel_n = torch.sqrt(torch.sum(rel_b * rel_b, dim=-1) + 1e-18)
            tang = torch.stack([-rel_b[:, 1], rel_b[:, 0]], dim=-1) / rel_n[:, None]
            left = torch.stack([-to_q[:, 1], to_q[:, 0]], dim=-1)
            score = torch.sum(tang * to_q, dim=-1) + 1e-6 * torch.sum(tang * left, dim=-1)
            tang = torch.where(score[:, None] < 0.0, -tang, tang)
            blocked = cap_min < v_des
            phi_eff = torch.where(blocked, torch.atan2(tang[:, 1], tang[:, 0]), phi)
        e_eff = torch.atan2(torch.sin(phi_eff - th), torch.cos(phi_eff - th))
        om = torch.clamp(e_eff / dt, w_lb, w_ub)
        v = torch.clamp(
            torch.minimum(v_des, cap_min), v_lb, torch.minimum(v_ub, cap_min)
        )
        v = torch.clamp(v, min=0.0)
        controls.append(torch.stack([v, om], dim=-1))
        state = torch.stack(
            [
                p[:, 0] + v * torch.cos(th) * dt,
                p[:, 1] + v * torch.sin(th) * dt,
                th + om * dt,
            ],
            dim=-1,
        )
        rows.append(state)
    return torch.stack(rows, dim=1), torch.stack(controls, dim=1)


def _batch_of(x, shape, dtype, device) -> torch.Tensor:
    """``x`` as a tensor of ``shape`` (leading batch axis), broadcasting.
    A Python number, or a tuple or list of them, is made on the device
    (`_device.constant`), not copied from the host."""
    if isinstance(x, (int, float)):
        return torch.full(shape, x, dtype=dtype, device=device)
    if isinstance(x, (tuple, list)) and all(isinstance(v, (int, float)) for v in x):
        x = constant(x, dtype, device)
    return torch.as_tensor(x, dtype=dtype, device=device).broadcast_to(shape).contiguous()


def default_problem(
    cfg: MPCConfig,
    initial_state,
    goal_state,
    *,
    control_bounds=CONTROL_BOUNDS,
    state_bounds=STATE_BOUNDS,
    obstacle_centers=None,
    obstacle_radii=None,
    obstacle_mask=None,
    inflation_radius=0.0,
    warm_states=None,
    warm_controls=None,
    dtype=torch.float32,
    device=None,
) -> Problem:
    """Build a batch of Problems with reference-default bounds.

    ``initial_state`` / ``goal_state`` are [B, 3] (a single [3] row is a
    batch of one).  ``obstacle_centers`` is [B, K, N, 2] tracks or [B, K, 2]
    constant centers; ``obstacle_radii`` / ``obstacle_mask`` [B, K];
    ``inflation_radius`` a scalar or [B]; ``warm_states`` [B, N+1, 3] and
    ``warm_controls`` [B, N, 2].  Bounds follow `EgoAgent` defaults
    (`mpc/agent.py:104-105`), the state box applies to x (and y iff
    ``cfg.bound_y``).
    """
    dev = resolve_device(device)
    N, K = cfg.horizon, cfg.max_obstacles
    initial_state = torch.as_tensor(initial_state, dtype=dtype, device=dev)
    initial_state = initial_state.reshape(-1, 3).contiguous()
    B = initial_state.shape[0]
    goal_state = _batch_of(goal_state, (B, 3), dtype, dev)
    (v_lb, v_ub), (w_lb, w_ub) = control_bounds
    lo, hi = state_bounds
    inf = float("inf")
    row = lambda vals: _batch_of(vals, (B, len(vals)), dtype, dev)

    if obstacle_centers is None:
        obstacle_centers = torch.zeros((B, K, N, 2), dtype=dtype, device=dev)
    else:
        obstacle_centers = torch.as_tensor(obstacle_centers, dtype=dtype, device=dev)
        if obstacle_centers.dim() == 3:  # [B, K, 2] constant centers -> tracks
            obstacle_centers = obstacle_centers[:, :, None, :].expand(B, K, N, 2)
        obstacle_centers = obstacle_centers.contiguous()
    if obstacle_radii is None:
        obstacle_radii = torch.zeros((B, K), dtype=dtype, device=dev)
    if obstacle_mask is None:
        obstacle_mask = torch.ones((B, K), dtype=dtype, device=dev)
    if warm_states is None:
        # Reference warm start: current state tiled across the horizon
        # (`mpc/agent.py:59,82-90`).
        warm_states = initial_state[:, None, :].expand(B, N + 1, 3)
    if warm_controls is None:
        warm_controls = torch.zeros((B, N, 2), dtype=dtype, device=dev)

    return Problem(
        initial_state=initial_state,
        goal_state=goal_state,
        control_lower=row([v_lb, w_lb]),
        control_upper=row([v_ub, w_ub]),
        state_lower=row([lo, lo if cfg.bound_y else -inf, -inf]),
        state_upper=row([hi, hi if cfg.bound_y else inf, inf]),
        obstacle_centers=obstacle_centers,
        obstacle_radii=_batch_of(obstacle_radii, (B, K), dtype, dev),
        obstacle_mask=_batch_of(obstacle_mask, (B, K), dtype, dev),
        inflation_radius=_batch_of(inflation_radius, (B,), dtype, dev),
        warm_states=_batch_of(warm_states, (B, N + 1, 3), dtype, dev),
        warm_controls=_batch_of(warm_controls, (B, N, 2), dtype, dev),
    )


def problem_with_obstacles(
    cfg: MPCConfig,
    initial_state,
    goal_state,
    obstacles,
    *,
    sensor_radius: float = SENSOR_RADIUS,
    prediction_dt: float | None = None,
    repair_warm_start_states: bool = True,
    complete_warm_start_states: bool = True,
    completion_threshold: float = COMPLETION_THRESHOLD,
    **kwargs,
) -> Problem:
    """Build a batch of Problems from a batched `ObstacleSet` ([B, K_all]
    leaves, or a shared set broadcast to B): sensor top-K filter,
    constant-velocity track prediction, warm-start repair, and the
    feasibility rollout where the repair moved the warm start by more than
    ``completion_threshold`` (see the reference docstring for why the
    threshold matters).  ``kwargs`` are `default_problem`'s (bounds,
    inflation, warm start, dtype, device).  On the card one launch of the
    build kernel (`ops/problem_build.py::build_cuda`), on the CPU its plain
    version `build_plain`, by ``device`` as the other wrappers decide.
    """
    from . import problem_build

    return problem_build.build_plain(
        cfg, initial_state, goal_state, obstacles,
        sensor_radius=sensor_radius,
        prediction_dt=prediction_dt,
        repair_warm_start_states=repair_warm_start_states,
        complete_warm_start_states=complete_warm_start_states,
        completion_threshold=completion_threshold,
        **kwargs,
    )
