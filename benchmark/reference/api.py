"""The staged batched solve and the backend dispatch as plain PyTorch.

Frozen from `kissmpc_tpu_torch/solver/api.py::solve_batch`, `_dispatch`,
`_refine_stages` and `_merge` at commit d587314: the fused backend runs the
plain version of the fused kernel (`ipm_fused.solve_batch_fused_plain`),
the split backend the plain split solve (`ipm.solve_plain`).  Unlike the
port, the dtype is the problems' own, bfloat16 included: the control of
the benchmark's comparison runs this reference one precision below the
configuration's.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ipm
from .config import MPCConfig
from .ipm_fused import solve_batch_fused_plain
from .problem import Diagnostics, Problem, Solution, gather


def dispatch(cfg: MPCConfig, problems: Problem, *, iterations=None, mu_sigma=None) -> Solution:
    """One batched solve of the configured backend, no refinement."""
    sc = cfg.solver
    if sc.solve_backend == "fused":
        return solve_batch_fused_plain(cfg, problems, iterations=iterations, mu_sigma=mu_sigma)
    if sc.solve_backend != "split":
        raise ValueError(f"unknown solve_backend {sc.solve_backend!r}")
    if iterations is not None or mu_sigma is not None:
        cfg = cfg.replace(solver=dataclasses.replace(
            sc,
            iterations=sc.iterations if iterations is None else iterations,
            mu_sigma=sc.mu_sigma if mu_sigma is None else float(mu_sigma),
        ))
    return ipm.solve_plain(cfg, problems)


def refine_stages(cfg: MPCConfig):
    """((fraction, iterations, mu_sigma), ...)."""
    if cfg.solver.refine_stages:
        return tuple((float(f), int(it), float(ms)) for f, it, ms in cfg.solver.refine_stages)
    if cfg.solver.refine_fraction > 0.0:
        return ((cfg.solver.refine_fraction, cfg.solver.refine_iterations, cfg.solver.mu_sigma),)
    return ()


def _merge(full, new, take, idx):
    t = take.reshape(take.shape + (1,) * (new.dim() - 1))
    out = full.clone()
    out[idx] = torch.where(t, new, full[idx])
    return out


def solve_batch(cfg: MPCConfig, problems: Problem) -> Solution:
    """The batched solve with staged refinement: each stage re-solves the
    worst ``fraction`` of the batch by convergence (non-converged first,
    ties in batch order), warm-started from the current iterates, and
    merges back where the re-solve converged and the running solution had
    not."""
    sol = dispatch(cfg, problems)
    B = problems.initial_state.shape[0]
    for frac, iters, mu_sigma in refine_stages(cfg):
        n = min(B, max(1, int(round(B * frac))))
        score = 1.0 - sol.diagnostics.converged.to(torch.float32)
        idx = torch.sort(score, descending=True, stable=True).indices[:n]
        sub = gather(problems, idx)._replace(warm_states=sol.states[idx],
                                             warm_controls=sol.controls[idx])
        sol2 = dispatch(cfg, sub, iterations=iters, mu_sigma=mu_sigma)
        take = sol2.diagnostics.converged & ~sol.diagnostics.converged[idx]
        sol = Solution(
            states=_merge(sol.states, sol2.states, take, idx),
            controls=_merge(sol.controls, sol2.controls, take, idx),
            diagnostics=Diagnostics(*(_merge(f, g, take, idx)
                                      for f, g in zip(sol.diagnostics, sol2.diagnostics))),
        )
    return sol
