"""Frozen copy of `kissmpc_tpu_torch/models/unicycle.py` at commit d587314.

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""

from __future__ import annotations

import torch

NUM_STATES = 3
NUM_CONTROLS = 2


def step(state: torch.Tensor, control: torch.Tensor, dt) -> torch.Tensor:
    """One forward-Euler step.  state: [..., 3], control: [..., 2]."""
    x, y, theta = state[..., 0], state[..., 1], state[..., 2]
    v, omega = control[..., 0], control[..., 1]
    return torch.stack(
        [
            x + v * torch.cos(theta) * dt,
            y + v * torch.sin(theta) * dt,
            theta + omega * dt,
        ],
        dim=-1,
    )


def rollout(initial_state: torch.Tensor, controls: torch.Tensor, dt) -> torch.Tensor:
    """initial_state: [..., 3]; controls: [..., N, 2] -> states [..., N+1, 3]
    with the initial state as row 0 (a loop over N in place of `lax.scan`)."""
    rows = [initial_state]
    for t in range(controls.shape[-2]):
        rows.append(step(rows[-1], controls[..., t, :], dt))
    return torch.stack(rows, dim=-2)


def defects(states: torch.Tensor, controls: torch.Tensor, dt) -> torch.Tensor:
    """Multiple-shooting defects d_t = f(x_t, u_t) - x_{t+1}: [..., N, 3]."""
    return step(states[..., :-1, :], controls, dt) - states[..., 1:, :]


def linearize(states: torch.Tensor, controls: torch.Tensor, dt):
    """Closed-form Jacobians of `step` along a trajectory.

    Returns (A [..., N, 3, 3], B [..., N, 3, 2]).
    """
    theta = states[..., :-1, 2]
    v = controls[..., 0]
    c, s = torch.cos(theta), torch.sin(theta)
    zeros = torch.zeros_like(theta)
    ones = torch.ones_like(theta)
    A = torch.stack(
        [
            torch.stack([ones, zeros, -v * s * dt], dim=-1),
            torch.stack([zeros, ones, v * c * dt], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    B = torch.stack(
        [
            torch.stack([c * dt, zeros], dim=-1),
            torch.stack([s * dt, zeros], dim=-1),
            torch.stack([zeros, ones * dt], dim=-1),
        ],
        dim=-2,
    )
    return A, B
