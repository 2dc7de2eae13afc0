#!/usr/bin/env python3
"""How many converged flags round-off alone changes at a refine stage's
batch, beside the fused kernel's own disagreement, on one NVIDIA GPU.

    python3 scripts/fused_flag_noise.py

chip_smoke.py's phase 4 lets the kernel's converged flags differ from the
plain version's on max(1% of the batch, twice the plain version's own flag
changes under a one-ulp nudge of x0, up or down).  At B=164 (the last
refine stage of the K=8 cells) those counts are a few scenarios.  This
script counts, at N=50, B=164, 32 iterations, float32, the flags that other
round-off changes on the same problems: the plain version on the CPU
against the plain version on the card (other summation orders), and the
kernel compiled without FMA contraction (``--fmad=false``, into a temporary
directory) against the kernel as built; beside the kernel's own flips
against the plain version and the nudges'.  Each count is split into the
scenarios that converge only on the first side and only on the second.
Cases: the card tests' problems (seed 5, one dynamic obstacle) at K=8 with
affine and tabulated tracks, hard and elastic, and the refine batch of
chip_smoke.py's pool (seed 0, two dynamic; its first 164) for k8_dyn2 and
k8_dyn2_elastic.  Prints one line per case, then one JSON line.
"""

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCH = 164


def no_fma_library(tmp):
    """The kernel built with --fmad=false into ``tmp``."""
    from kissmpc_tpu_torch.ops import _build, ipm_fused

    flags = _build.NVCC_FLAGS
    _build.NVCC_FLAGS = (*flags, "--fmad=false")
    try:
        return ipm_fused.bind(_build.load(ipm_fused.SOURCE, "ipm_fused_nofma", build_dir=tmp))
    finally:
        _build.NVCC_FLAGS = flags


def split(a, b):
    """[flags that differ, converged on a only, converged on b only]."""
    d = a != b
    return [int(d.sum()), int((d & a).sum()), int((d & b).sum())]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_flag_noise: CUDA is not available")

    import chip_smoke as cs
    from fused_gate_faults import kernel_library
    from kissmpc_tpu_torch import MPCConfig
    from kissmpc_tpu_torch.ops.ipm_fused import _library, solve_batch_fused, solve_batch_fused_plain
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    def test_case(affine, elastic):
        cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, iterations=32, mu_sigma_max=0.7, fused_affine_tracks=affine,
            elastic_obstacles=elastic))
        return cfg, obstacle_problems(cfg, BATCH, seed=5, n_dynamic=1, device="cuda")

    cfgs = cs.configs("fused")
    pool = gather(obstacle_problems(cfgs["k8_dyn2"], cs.POOL, seed=0, n_dynamic=2),
                  torch.arange(BATCH, device="cuda"))
    cases = {
        "tests, K=8 affine": test_case(True, False),
        "tests, K=8 tabulated": test_case(False, False),
        "tests, K=8 affine elastic": test_case(True, True),
        "k8_dyn2 refine batch": (cfgs["k8_dyn2"], pool),
        "k8_dyn2_elastic refine batch": (cfgs["k8_dyn2_elastic"], pool),
    }
    _library()  # the kernel as built, before the other build
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        nofma = no_fma_library(Path(tmp))
        for name, (cfg, pr) in cases.items():
            iters = cs.FUSED_ITERATIONS
            plain = solve_batch_fused_plain(cfg, pr, iterations=iters).diagnostics.converged
            kernel = solve_batch_fused(cfg, pr, iterations=iters).diagnostics.converged
            with kernel_library(nofma):
                kernel_nofma = solve_batch_fused(cfg, pr, iterations=iters).diagnostics.converged
            cpu = solve_batch_fused_plain(cfg, Problem(*(x.cpu() for x in pr)),
                                          iterations=iters).diagnostics.converged.cuda()
            x0, nudges = pr.initial_state, []
            for toward in (np.inf, -np.inf):
                nudged = pr._replace(initial_state=torch.nextafter(x0, torch.full_like(x0, toward)))
                nudges.append(split(solve_batch_fused_plain(cfg, nudged, iterations=iters)
                                    .diagnostics.converged, plain))
            r = {"converged_plain": int(plain.sum()), "converged_kernel": int(kernel.sum()),
                 "kernel_vs_plain": split(kernel, plain), "nudges_vs_plain": nudges,
                 "plain_cpu_vs_card": split(cpu, plain),
                 "kernel_no_fma_vs_kernel": split(kernel_nofma, kernel),
                 "kernel_no_fma_vs_plain": split(kernel_nofma, plain)}
            out[name] = r
            print(f"{name} (B={BATCH}, {iters} it.): converged plain {r['converged_plain']}, "
                  f"kernel {r['converged_kernel']}; flags that differ [all, first side only, "
                  f"second only]: kernel vs plain {r['kernel_vs_plain']}; x0 nudged up, down vs "
                  f"plain {nudges}; plain on the CPU vs on the card {r['plain_cpu_vs_card']}; "
                  f"kernel without FMA vs kernel {r['kernel_no_fma_vs_kernel']}, vs plain "
                  f"{r['kernel_no_fma_vs_plain']}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
