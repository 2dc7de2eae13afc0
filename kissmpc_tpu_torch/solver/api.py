"""Public solve API: batched solve with staged tail refinement (torch).

Port of `kissmpc_tpu/solver/api.py`.  PyTorch runs eagerly, so
`make_solver` and `make_batch_solver` return plain closures over the config;
`solve_batch` runs the configured backend and then each refinement stage,
`make_solver` the split IPM (`ipm.solve`) alone.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .._device import resolve_device
from ..config import MPCConfig
from ..ops.ipm_fused import solve_batch_fused
from . import ipm
from .problem import Diagnostics, Problem, Solution, gather, to_device


def _check_lqr_backend(cfg: MPCConfig) -> None:
    if cfg.solver.lqr_backend != "auto":
        raise ValueError(
            "the port picks the Riccati engine from the tensors' device; "
            f"lqr_backend must be 'auto', got {cfg.solver.lqr_backend!r}"
        )


def make_solver(cfg: MPCConfig, *, device=None):
    """Solver closed over the config: Problem -> Solution by the split IPM,
    with no refinement, as the reference's single-scenario `make_solver`
    runs `ipm.solve`.  The port's builders make a single scenario as a batch
    of one, and any batch works.  ``device=None`` runs on the card; the
    problems are moved there."""
    _check_lqr_backend(cfg)
    dev = resolve_device(device)

    def solve(problem: Problem) -> Solution:
        return ipm.solve(cfg, to_device(problem, dev))

    return solve


def _dispatch(cfg: MPCConfig, problems: Problem, *,
              iterations: int | None = None,
              mu_sigma=None) -> Solution:
    """Backend dispatch for one batched solve (no refinement).

    ``iterations`` / ``mu_sigma`` are per-call schedule overrides (refine
    stages).  "fused" with float32 problems goes to the fused IPM kernel
    (`ops/ipm_fused.solve_batch_fused`, which runs its plain version for
    CPU tensors), taking both as runtime inputs; ``mu_sigma`` may be a
    per-scenario [B] tensor there.  float64 problems take the split path, as
    the reference sends f64 to its jnp path.  "split" is the torch IPM loop
    around the Riccati kernel, with the overrides folded into the config.
    """
    sc = cfg.solver
    if sc.elastic_obstacles and sc.mehrotra != "off":
        raise ValueError(
            "mehrotra predictor-corrector does not support "
            "elastic_obstacles (the elastic condensation has no affine/"
            "corrector split); disable one of the two flags"
        )
    if sc.solve_backend == "fused" and sc.mehrotra != "off":
        raise ValueError(
            "the fused backend has no predictor-corrector; use mehrotra='off' "
            "(the reference ignores the flag there)"
        )
    if sc.solve_backend == "fused" and problems.initial_state.dtype == torch.float32:
        return solve_batch_fused(cfg, problems, iterations=iterations, mu_sigma=mu_sigma)
    if sc.solve_backend not in ("fused", "split"):
        raise ValueError(f"unknown solve_backend {sc.solve_backend!r}")
    _check_lqr_backend(cfg)
    if iterations is not None or mu_sigma is not None:
        if mu_sigma is not None and getattr(mu_sigma, "ndim", 0):
            raise ValueError(
                "per-scenario mu_sigma arrays are supported by the fused "
                "backend only; the split path folds mu_sigma into the "
                "config (pass a scalar)"
            )
        cfg = cfg.replace(
            solver=dataclasses.replace(
                sc,
                iterations=sc.iterations if iterations is None else iterations,
                mu_sigma=sc.mu_sigma if mu_sigma is None else float(mu_sigma),
            )
        )
    return ipm.solve(cfg, problems)


def _refine_stages(cfg: MPCConfig):
    """Normalized refinement plan: ((fraction, iterations, mu_sigma), ...)."""
    if cfg.solver.refine_stages:
        return tuple(
            (float(f), int(it), float(ms)) for f, it, ms in cfg.solver.refine_stages
        )
    if cfg.solver.refine_fraction > 0.0:
        return (
            (
                cfg.solver.refine_fraction,
                cfg.solver.refine_iterations,
                cfg.solver.mu_sigma,
            ),
        )
    return ()


def _merge(full: torch.Tensor, new: torch.Tensor, take: torch.Tensor, idx):
    t = take.reshape(take.shape + (1,) * (new.dim() - 1))
    out = full.clone()
    out[idx] = torch.where(t, new, full[idx])
    return out


def solve_batch(cfg: MPCConfig, problems: Problem, *, device=None) -> Solution:
    """Batched solve with staged second-chance refinement.

    Each stage gathers the worst ``fraction`` of the batch by convergence
    (non-converged first, ties in batch order as `jax.lax.top_k` breaks
    them), re-solves it warm-started from the current iterates for the
    stage's ``iterations`` at its ``mu_sigma``, and merges back wherever the
    re-solve converged and the running solution had not.  Untouched
    scenarios come back bit-identical.

    ``device=None`` runs on the card; the problems are moved there.
    """
    dev = resolve_device(device)
    problems = to_device(problems, dev)
    sol = _dispatch(cfg, problems)
    B = problems.initial_state.shape[0]
    for frac, iters, mu_sigma in _refine_stages(cfg):
        n = min(B, max(1, int(round(B * frac))))
        score = 1.0 - sol.diagnostics.converged.to(torch.float32)
        idx = torch.sort(score, descending=True, stable=True).indices[:n]
        sub = gather(problems, idx)._replace(
            warm_states=sol.states[idx], warm_controls=sol.controls[idx]
        )
        sol2 = _dispatch(cfg, sub, iterations=iters, mu_sigma=mu_sigma)
        take = sol2.diagnostics.converged & ~sol.diagnostics.converged[idx]
        sol = Solution(
            states=_merge(sol.states, sol2.states, take, idx),
            controls=_merge(sol.controls, sol2.controls, take, idx),
            diagnostics=Diagnostics(
                *(_merge(f, g, take, idx)
                  for f, g in zip(sol.diagnostics, sol2.diagnostics))
            ),
        )
    return sol


def make_batch_solver(cfg: MPCConfig, *, device=None):
    """Batched solver closed over the config: Problem [B] -> Solution [B]."""
    return functools.partial(solve_batch, cfg, device=device)
