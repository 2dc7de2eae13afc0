"""Public solve API: batched solve with staged tail refinement (torch).

Port of `kissmpc_tpu/solver/api.py`.  `make_solver` runs the split IPM
(`ipm.solve`) alone and `make_batch_solver` runs `solve_batch`, each on the
card as one CUDA graph per problem shape (`graph.py`), the counterpart of
the reference's `jax.jit`; `solve_batch` itself runs the configured backend
and then each refinement stage eagerly, as the reference's does outside
`jit`.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..config import MPCConfig
from ..ops.ipm_fused import solve_batch_fused
from . import graph, ipm
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
    of one, and any batch works.  ``device=None`` runs on the card, where
    the solve is captured into a CUDA graph at the first call for each
    shape and replayed after it (`graph.run`); the problems are moved
    there."""
    _check_lqr_backend(cfg)
    dev = resolve_device(device)

    def program(*leaves) -> Solution:
        return ipm.solve(cfg, Problem(*leaves))

    def solve(problem: Problem) -> Solution:
        return graph.run(("make_solver", cfg), program, dev, *problem)

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
    the reference sends f64 to its jnp path.  "split" is `ipm.solve` (on
    the card the condensation, Riccati and step kernels per iteration),
    with the overrides folded into the config.
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


# (device, number of stages) -> int64 [stages, 3]: per stage position, the
# re-solved scenarios that entered it converged, those that entered it
# unconverged, and those it rescued, summed over every `solve_batch` with
# that many stages.
_REFINE_COUNTS: dict = {}


def _stage_counts(device: torch.device, stages: int) -> torch.Tensor:
    """The refine counts of ``stages`` stages on ``device``, made at the
    first such solve, which `graph.run` runs before it captures one."""
    key = (device, stages)
    if key not in _REFINE_COUNTS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("solve_batch's refine counts must be made outside a "
                               "capture: run the solve once before capturing it")
        _REFINE_COUNTS[key] = torch.zeros((stages, 3), dtype=torch.int64, device=device)
    return _REFINE_COUNTS[key]


def refine_counts(device=None) -> list:
    """Per refine stage position, ``[re-solved, entered unconverged,
    rescued]``: the sums over every `solve_batch` on ``device`` since the
    process began, eager calls and replays of captured ones alike, as host
    numbers (reading them waits for the device, so read them after the
    work).  Empty where no solve on the device had a stage."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rows: list = []
    for (where, _), counts in _REFINE_COUNTS.items():
        if where != dev:
            continue
        for s, (converged, unconverged, rescued) in enumerate(counts.tolist()):
            if s == len(rows):
                rows.append([0, 0, 0])
            row = rows[s]
            row[0] += converged + unconverged
            row[1] += unconverged
            row[2] += rescued
    return rows


def solve_batch(cfg: MPCConfig, problems: Problem, *, device=None) -> Solution:
    """Batched solve with staged second-chance refinement.

    Each stage gathers the worst ``fraction`` of the batch by convergence
    (non-converged first, ties in batch order as `jax.lax.top_k` breaks
    them), re-solves it warm-started from the current iterates for the
    stage's ``iterations`` at its ``mu_sigma``, and merges back wherever the
    re-solve converged and the running solution had not.  Untouched
    scenarios come back bit-identical.  Each stage adds what it re-solved,
    how many of those entered unconverged and how many it rescued to the
    device's refine counts (`refine_counts`), with no host sync.

    ``device=None`` runs on the card; the problems are moved there.
    """
    dev = resolve_device(device)
    problems = to_device(problems, dev)
    sol = _dispatch(cfg, problems)
    B = problems.initial_state.shape[0]
    stages = _refine_stages(cfg)
    if stages:
        counts = _stage_counts(problems.initial_state.device, len(stages))
    for s, (frac, iters, mu_sigma) in enumerate(stages):
        n = min(B, max(1, int(round(B * frac))))
        score = 1.0 - sol.diagnostics.converged.to(torch.float32)
        idx = torch.sort(score, descending=True, stable=True).indices[:n]
        sub = gather(problems, idx)._replace(
            warm_states=sol.states[idx], warm_controls=sol.controls[idx]
        )
        sol2 = _dispatch(cfg, sub, iterations=iters, mu_sigma=mu_sigma)
        # Per re-solved scenario: entered converged, entered unconverged,
        # rescued (`take`); their sums go to the stage's row of the counts.
        flags = torch.empty((n, 3), dtype=torch.bool, device=idx.device)
        torch.index_select(sol.diagnostics.converged, 0, idx, out=flags[:, 0])
        torch.logical_not(flags[:, 0], out=flags[:, 1])
        take = torch.logical_and(sol2.diagnostics.converged, flags[:, 1], out=flags[:, 2])
        counts[s].add_(flags.sum(0))
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
    """Batched solver closed over the config: Problem [B] -> Solution [B],
    `solve_batch` with either backend and its refinement stages.
    ``device=None`` runs on the card, where the solve is captured into a
    CUDA graph at the first call for each shape and replayed after it
    (`graph.run`; the stages' batches follow from B alone); the problems
    are moved there."""
    dev = resolve_device(device)

    def program(*leaves) -> Solution:
        return solve_batch(cfg, Problem(*leaves), device=dev)

    def solve(problems: Problem) -> Solution:
        return graph.run(("make_batch_solver", cfg), program, dev, *problems)

    return solve
