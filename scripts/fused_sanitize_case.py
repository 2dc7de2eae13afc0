#!/usr/bin/env python3
"""A small fused-kernel run for CUDA's compute-sanitizer, on one NVIDIA GPU.

    compute-sanitizer --tool racecheck python3 scripts/fused_sanitize_case.py
    compute-sanitizer --tool memcheck python3 scripts/fused_sanitize_case.py

Runs `solve_batch_fused` at B=64, N=12, K=2 (affine tracks) for 3
iterations, the hard and the elastic instantiation, plus a ragged B=37
(warps past the batch leave early), synchronises, and checks the results
are finite.  The sanitizer's report is the result; this script adds none.
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch

    from kissmpc_tpu_torch import MPCConfig
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.scenarios import obstacle_problems

    if not torch.cuda.is_available():
        raise SystemExit("fused_sanitize_case: CUDA is not available")
    for elastic in (False, True):
        cfg = MPCConfig(horizon=12, time_step=0.1, max_obstacles=2)
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, mu_sigma_max=0.7, fused_affine_tracks=True, elastic_obstacles=elastic))
        for batch in (64, 37):
            problems = obstacle_problems(cfg, batch, seed=5, n_dynamic=1, device="cuda")
            sol = solve_batch_fused(cfg, problems, iterations=3)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(sol.states).all()):
                raise SystemExit(f"fused_sanitize_case: non-finite states (elastic={elastic})")
            print(f"elastic={elastic} B={batch}: 3 iterations, states finite", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
