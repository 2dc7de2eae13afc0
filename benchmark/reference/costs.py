"""Frozen copy of `kissmpc_tpu_torch/models/costs.py` at commit d587314.

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""

from __future__ import annotations

import functools

import torch

from ._device import constant
from .config import CostConfig


def _goal_mask(cfg: CostConfig, horizon: int, like: torch.Tensor) -> torch.Tensor:
    """Per-state-row inclusion mask for the goal cost, rows t = 0..N."""
    t = torch.arange(horizon + 1, device=like.device)
    if cfg.goal_cost_mode == "exclude_terminal":
        mask = (t >= 1) & (t <= horizon - 1)
    else:
        mask = t >= 1
    return mask.to(like.dtype)


@functools.lru_cache(maxsize=None)
def _weights_on(weights: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The goal weights on ``device``, made once per (weights, dtype,
    device) and never freed: a captured CUDA graph reads them in place."""
    return constant(weights, dtype, device)


def _weights(cfg: CostConfig, like: torch.Tensor) -> torch.Tensor:
    return _weights_on(tuple(cfg.goal_weights), like.dtype, like.device)


def total_cost(
    cfg: CostConfig, states: torch.Tensor, controls: torch.Tensor, goal: torch.Tensor
) -> torch.Tensor:
    """Objective per scenario: [...]."""
    horizon = controls.shape[-2]
    w = _weights(cfg, states)
    mask = _goal_mask(cfg, horizon, states)
    err = states - goal.unsqueeze(-2)
    goal_cost = torch.sum(mask[:, None] * (err * err) * w, dim=(-2, -1))

    v = controls[..., 0]
    omega = controls[..., 1]
    neg_v = torch.clamp(v, max=0.0)
    if cfg.reverse_penalty_mode == "squared":
        reverse_cost = cfg.negative_velocity_weight * torch.sum(neg_v * neg_v, dim=-1)
    else:
        reverse_cost = cfg.negative_velocity_weight * torch.sum(neg_v, dim=-1)
    pos_v = torch.clamp(v, min=0.0)
    forward_cost = cfg.positive_velocity_weight * torch.sum(pos_v * pos_v, dim=-1)
    angular_cost = cfg.angular_velocity_weight * torch.sum(omega * omega, dim=-1)
    return goal_cost + reverse_cost + forward_cost + angular_cost


def stage_gradients(
    cfg: CostConfig, states: torch.Tensor, controls: torch.Tensor, goal: torch.Tensor
):
    """Exact cost gradients: (gx [..., N+1, 3], gu [..., N, 2])."""
    horizon = controls.shape[-2]
    w = _weights(cfg, states)
    mask = _goal_mask(cfg, horizon, states)
    gx = 2.0 * mask[:, None] * w * (states - goal.unsqueeze(-2))

    v = controls[..., 0]
    omega = controls[..., 1]
    if cfg.reverse_penalty_mode == "squared":
        dv = 2.0 * cfg.negative_velocity_weight * torch.clamp(v, max=0.0)
    else:
        dv = cfg.negative_velocity_weight * (v < 0.0).to(states.dtype)
    dv = dv + 2.0 * cfg.positive_velocity_weight * torch.clamp(v, min=0.0)
    domega = 2.0 * cfg.angular_velocity_weight * omega
    gu = torch.stack([dv, domega], dim=-1)
    return gx, gu


def stage_hessians(cfg: CostConfig, states: torch.Tensor, controls: torch.Tensor):
    """Exact (generalized) diagonal Hessian blocks.

    Returns (Hx [..., N+1, 3], Hu [..., N, 2]), the diagonals of d2/dx2 and
    d2/du2; the reverse penalty's generalized second derivative is 2*w^- on
    {v < 0}.
    """
    horizon = controls.shape[-2]
    dtype = states.dtype
    w = _weights(cfg, states)
    mask = _goal_mask(cfg, horizon, states)
    Hx = (2.0 * mask[:, None] * w).expand(states.shape)

    v = controls[..., 0]
    neg = (v < 0.0).to(dtype)
    pos = (v > 0.0).to(dtype)
    if cfg.reverse_penalty_mode == "squared":
        hv = 2.0 * cfg.negative_velocity_weight * neg
    else:
        hv = torch.zeros_like(v)
    hv = hv + 2.0 * cfg.positive_velocity_weight * pos
    homega = torch.full_like(v, 2.0 * cfg.angular_velocity_weight)
    Hu = torch.stack([hv, homega], dim=-1)
    return Hx, Hu
