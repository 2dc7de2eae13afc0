"""Static configuration for the PyTorch/CUDA port of the MPC engine.

A field-for-field copy of `kissmpc_tpu/config.py` (same names, same
defaults): the port imports nothing of the JAX package, so it keeps its own
copy of this framework-free module, and the tests hold the two against each
other.  The reference documents each field and the measurements behind its
default; those measurements were taken on a TPU and are not this port's.

Semantic switches where the reference code and its README differ:

* ``goal_cost_mode``: ``"full"`` sums goal tracking over states 1..N (the
  README), ``"exclude_terminal"`` over 1..N-1 (the committed code).
* ``reverse_penalty_mode``: ``"squared"`` (README, default) or ``"linear"``.
* ``bound_y``: box bounds on x and y (README, default) or x only.

Fields the port reads differently from the JAX package:

* ``solve_backend``: ``"fused"`` (the default) runs the whole IPM as one
  hand-written CUDA kernel per solve stage (`ops/ipm_fused.py`,
  `csrc/ipm_fused.cu`) for float32 problems; float64 problems take
  ``"split"``, the torch IPM loop around the CUDA Riccati kernel.
* ``lqr_backend``: the port picks the Riccati engine from the tensors'
  device (CUDA kernel on the card, plain torch on the CPU) and accepts only
  ``"auto"``.
* ``mehrotra``: ``"pc"`` and ``"soc"`` run on the split path; the fused
  backend raises ValueError for them (the reference ignores the flag
  there), and any other string raises ValueError.
* ``fused_block``, ``fused_sublanes``: TPU tile settings of the reference's
  Pallas kernel.  Nothing on the card reads them; they never changed a
  result in the reference either.  ``fused_affine_tracks`` is read by the
  fused kernel: tracks travel as (start, per-step delta) pairs, with a
  per-scenario certificate that they are affine.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

GoalCostMode = Literal["full", "exclude_terminal"]
ReversePenaltyMode = Literal["squared", "linear"]


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Cost weights.  Defaults follow `mpc/optimizer.py:57-60`."""

    goal_weights: Tuple[float, float, float] = (100.0, 100.0, 50.0)
    negative_velocity_weight: float = 300.0
    angular_velocity_weight: float = 10.0
    # Commented out in the reference (`mpc/optimizer.py:85-89`); off.
    positive_velocity_weight: float = 0.0
    goal_cost_mode: GoalCostMode = "full"
    reverse_penalty_mode: ReversePenaltyMode = "squared"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Interior-point SQP settings: a fixed number of outer iterations with
    an adaptive barrier, in the role IPOPT plays in the reference
    (`mpc/optimizer.py:344-354`)."""

    iterations: int = 40
    # Adaptive barrier mu_j = clip(sigma * mean(s * nu), mu_min, mu_init).
    mu_init: float = 1.0
    mu_sigma: float = 0.2
    mu_min: float = 1e-9
    # Predictor-corrector mode: "off", "pc" or "soc" (split backend only).
    mehrotra: str = "off"
    # Per-scenario adaptive centering cap (0 disables): sigma grows 1.5x
    # toward max(mu_sigma_max, mu_sigma) on throttled steps outside the
    # Newton regime and decays 0.9x back to mu_sigma on healthy ones.
    mu_sigma_max: float = 0.0
    # Fraction-to-boundary coefficient for slack/dual steps.
    tau: float = 0.995
    # Line search candidates alpha in {1, bt, bt^2, ...}; the all-rejected
    # fallback executes the deepest one, so a short ladder keeps progress.
    ls_iters: int = 2
    ls_backtrack: float = 0.5
    # l1 merit penalty floor for the equality residuals.
    merit_penalty: float = 1e3
    # Levenberg regularization on the Quu / Qxx diagonals.
    reg: float = 1e-8
    slack_floor: float = 1e-12
    # Exact curvature of the obstacle distance constraint in the Hessian.
    obstacle_curvature: bool = True
    # Elastic obstacle constraints c + e - s = 0, e >= 0, with the penalty
    # elastic_penalty * e (both backends).
    elastic_obstacles: bool = False
    elastic_penalty: float = 1e4
    # KKT tolerance used only to report convergence.
    kkt_tol: float = 1e-6
    # Newton-KKT engine selection; the port accepts "auto" only.
    lqr_backend: str = "auto"
    # Batched-solve strategy: "fused" (one CUDA kernel per solve stage) or
    # "split" (torch IPM loop around the Riccati kernel).
    solve_backend: str = "fused"
    fused_block: int = 0
    fused_affine_tracks: bool = False
    fused_sublanes: int = 0
    # Legacy single-stage second-chance refinement (0.0 disables).
    refine_fraction: float = 0.0
    refine_iterations: int = 64
    # Staged refinement: ((fraction, iterations, mu_sigma), ...), each stage
    # re-solving the still-non-converged tail of the previous one.
    refine_stages: tuple = ()


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Full static problem + solver description: horizon ``N``
    (`mpc/agent.py:100` default 50) and obstacle capacity ``max_obstacles``
    (K, padded and masked) fix every tensor shape of a solve."""

    horizon: int = 50
    time_step: float = 0.041
    max_obstacles: int = 0
    cost: CostConfig = dataclasses.field(default_factory=CostConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    bound_y: bool = True

    @property
    def num_states(self) -> int:
        return 3

    @property
    def num_controls(self) -> int:
        return 2

    def replace(self, **kw) -> "MPCConfig":
        return dataclasses.replace(self, **kw)


# Deployment preset used by the reference ROS node (`ros2interface.py:28-38`).
ROS_DEPLOYMENT = MPCConfig(horizon=7, time_step=0.8)

# Research preset matching `EgoAgent` defaults (`mpc/agent.py:99-106`).
RESEARCH = MPCConfig(horizon=50, time_step=0.041)
