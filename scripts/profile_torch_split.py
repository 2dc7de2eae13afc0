#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_split.py [--batch 8192]

Runs `kissmpc_tpu_torch.solve_batch` ("split" backend) once per benchmark
configuration (obstacle-free, and K=8 with 2 dynamic tracks; N=50, f32,
32 iterations plus the staged refinement of bench.py) under
`torch.profiler`, after one warm-up call, and prints one JSON line per
configuration: the call's wall time, the device's busy time (sum of kernel
times on the one stream) and idle share, the number of kernel launches,
and the kernels that take the most device time.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_split: CUDA is not available")

    from kissmpc_tpu_torch import MPCConfig, solve_batch
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems

    def make(K, stages, **solver):
        cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=K)
        return cfg.replace(solver=dataclasses.replace(
            cfg.solver, iterations=32, refine_stages=stages,
            solve_backend="split", **solver))

    cells = {
        "free": (make(0, ((0.05, 64, 0.2),)), free_problems),
        "k8_dyn2": (make(8, ((0.125, 64, 0.2), (0.04, 96, 0.7), (0.02, 128, 0.5)),
                         mu_sigma_max=0.7),
                    lambda c, b, seed: obstacle_problems(c, b, seed=seed, n_dynamic=2)),
    }
    for name, (cfg, build) in cells.items():
        problems = build(cfg, args.batch, seed=1)
        solve_batch(cfg, problems)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_batch(cfg, problems)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
        print(json.dumps({
            "cell": name,
            "batch": args.batch,
            "device": torch.cuda.get_device_name(0),
            "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": len(kernels),
            "top_kernels": [
                {"name": k[:80], "ms": ms, "launches": n} for k, (ms, n) in top
            ],
        }), flush=True)


if __name__ == "__main__":
    main()
