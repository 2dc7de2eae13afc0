#!/usr/bin/env python3
"""Where the time of the port's split path goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_split.py [--batch 8192]
        [--cells node,make_solver,solve_batch,batch_solver,fleet] [--replays 0]

Each cell runs once as a warm-up and once under `torch.profiler`, eagerly
(`graph.eager()`: every kernel launched by the host, as the CUDA graphs
capture them):

- ``node``: one tick of the single-robot node, `io.Model` at its defaults
  (N=7, planning dt 0.8, 40 iterations, float32) with 4 obstacle slots and
  two walkers ahead of the robot;
- ``make_solver``: one `make_solver` call on the benchmark's K=8 cell with
  2 dynamic tracks on the "split" backend (N=50, float32, 32 iterations) at
  ``--batch`` scenarios;
- ``solve_batch``: one "split" `solve_batch` call per benchmark
  configuration (obstacle-free and K=8, with bench.py's refine stages);
- ``batch_solver``: one "split" `make_batch_solver` call on the K=8 cell
  with bench.py's refine stages, at ``--batch`` scenarios;
- ``fleet``: one closed-loop fleet tick, chip_smoke.py's phase 7 (B=4096,
  grid worlds, the default fused backend, one problem build per tick),
  on the first tick's state at every call.

The script wraps the split IPM's functions from outside, by replacing the
attributes of `kissmpc_tpu_torch.solver.ipm` with `record_function` ranges
around them (the program itself carries no tracing), and splits each
call's kernels and device milliseconds by the innermost range that
launched them: the problem build (`ops/problem_build.py::build_cuda`, its
kernel; on a tree without it, the tick outside `ipm.solve`,
"outside_solve"), init (`init_cuda`, its kernel and the first mu; or
`_init_state`), mu (`_adaptive_mu`, `_mean_complementarity`, on a tree
whose init and diagnostics are plain PyTorch), condensation
(`condense_cuda`, or `_build_lqr` where the tree has it), Riccati
(`solve_lqr_cuda`), step (`step_cuda`), the rest of an iteration
(`_iteration` outside those: on a tree without `step_cuda` it holds the
whole step, on one with it the Mehrotra glue), diagnostics
(`diagnostics_cuda`, or `_diagnostics`) and the rest of the solve.  Run
it from another tree's root (a copy of the script in its `scripts/`) to
profile that tree: the ranges it lacks are skipped.  It prints one JSON line per
cell: the card, the call's wall ms, the card's busy ms and idle share, the
kernel count, the split, and the kernels that take the most device time.
With ``--replays R`` each cell then runs as its CUDA graph: the first call
(warm-up and capture) timed, then R replays, each timed by the host clock
around a synchronize, p50 and p99, and one more replay under the
profiler (its kernels, busy ms and wall ms) (the node's, `make_solver`'s,
`make_batch_solver`'s and the fleet tick's graphs; `solve_batch` has none
and is skipped).
"""

import argparse
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# Range label -> the attributes it wraps, "module:name" (those the tree has;
# `solver.ipm` calls each through its module).
RANGES = {
    "build": ("ops.problem_build:build_cuda",),
    "solve": ("solver.ipm:solve",),
    "init": ("ops.ipm_split:init_cuda", "solver.ipm:_init_state"),
    "mu": ("solver.ipm:_adaptive_mu", "solver.ipm:_mean_complementarity"),
    "iteration_rest": ("solver.ipm:_iteration",),
    "condensation": ("ops.ipm_split:condense_cuda", "solver.ipm:_build_lqr"),
    "riccati": ("solver.ipm:solve_lqr_cuda",),
    "step": ("ops.ipm_split:step_cuda",),
    "diagnostics": ("ops.ipm_split:diagnostics_cuda", "solver.ipm:_diagnostics"),
}
PREFIX = "split::"
# The profiler does not always link a kernel launched through ctypes to
# the range around its launch; such kernels go to their range by name.
BY_NAME = {"riccati_kernel": "riccati", "condense_kernel": "condensation",
           "step_kernel": "step", "build_kernel": "build", "init_kernel": "init",
           "diagnostics_kernel": "diagnostics"}


def wrap_ipm():
    """Replace each function of RANGES in `solver.ipm` by one that runs it
    inside a `record_function` range named after its label."""
    from torch.profiler import record_function

    import importlib

    def ranged(label, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return inner

    for label, names in RANGES.items():
        for where in names:
            module, name = where.split(":")
            try:
                module = importlib.import_module(f"kissmpc_tpu_torch.{module}")
            except ImportError:
                continue
            if hasattr(module, name):
                setattr(module, name, ranged(label, getattr(module, name)))


def is_kernel(evt):
    import torch

    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.name.startswith(("Memcpy", "Memset", PREFIX)))


def split_by_range(prof, total_label="call"):
    """Kernels and device ms of the profile by the innermost range around
    their launch; launches outside every range go to ``total_label``, and
    kernels the profiler linked to no launch go by name (BY_NAME), else to
    "unlinked"."""
    import collections

    import torch

    out = collections.defaultdict(lambda: [0, 0.0])
    linked = collections.Counter()

    def visit(evt, label):
        if evt.name.startswith(PREFIX):
            label = evt.name[len(PREFIX):]
        for k in evt.kernels:
            if not k.name.startswith(("Memcpy", "Memset")):
                out[label][0] += 1
                out[label][1] += k.duration / 1e3
                linked[k.name] += 1
        for child in evt.cpu_children:
            visit(child, label)

    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU and evt.cpu_parent is None:
            visit(evt, total_label)
    for evt in prof.events():
        if is_kernel(evt):
            if linked[evt.name] > 0:
                linked[evt.name] -= 1
                continue
            label = next((v for k, v in BY_NAME.items() if k in evt.name), "unlinked")
            out[label][0] += 1
            out[label][1] += evt.device_time_total / 1e3
    return {k: {"kernels": n, "ms": ms} for k, (n, ms) in sorted(out.items())}


def profiled(fn, top):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if is_kernel(e)]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels": len(kernels),
            "split": split_by_range(prof, "outside_solve"),
            "top_kernels": [{"name": k[:80], "ms": ms, "launches": n}
                            for k, (ms, n) in ranked]}


def replay_kernels(fn, top):
    """One replay (``fn`` already captured) under the profiler: its wall ms,
    the card's busy ms and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if is_kernel(e)]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "device_busy_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "top_kernels": [{"name": k[:80], "ms": ms, "launches": n}
                            for k, (ms, n) in ranked]}


def replayed(fn, replays):
    """The first captured call's ms, and p50 / p99 of ``replays`` replays."""
    import numpy as np
    import torch

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    first = timed()
    ms = [timed() for _ in range(replays)]
    return {"first_call_ms": first, "replays": replays, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def node_cell():
    """One eager tick of the node (io.Model, 4 obstacle slots, two walkers)."""
    import torch

    from kissmpc_tpu_torch.io import Model
    from kissmpc_tpu_torch.obstacles import dynamic_set

    model = Model(max_obstacles=4, waypoints=((1.5, 0.4, 0.0), (3.0, 0.0, 0.0)), device="cuda")
    model.set_obstacles(dynamic_set([[1.2, 0.3], [2.0, -0.4]], [3.1, 1.6], [0.4, 0.3],
                                    max_obstacles=4, device="cpu"))
    return model.step, f"io.Model N={model.cfg.horizon}, {model.cfg.solver.iterations} " \
        f"iterations, B=1, {torch.float32}"


def k8_config(stages):
    from kissmpc_tpu_torch import MPCConfig

    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, refine_stages=stages, solve_backend="split",
        mu_sigma_max=0.7, fused_affine_tracks=True))


def make_solver_cell(batch):
    from kissmpc_tpu_torch import make_solver
    from kissmpc_tpu_torch.scenarios import obstacle_problems

    cfg = k8_config(())
    problems = obstacle_problems(cfg, batch, seed=1, n_dynamic=2)
    solve = make_solver(cfg)
    return (lambda: solve(problems)), f"make_solver k8_dyn2 split N=50 B={batch}, 32 iterations"


def solve_batch_cells(batch):
    from kissmpc_tpu_torch import MPCConfig, solve_batch
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems

    free = MPCConfig(horizon=50, time_step=0.041)
    free = free.replace(solver=dataclasses.replace(
        free.solver, iterations=32, refine_stages=((0.05, 64, 0.2),), solve_backend="split"))
    k8 = k8_config(((0.125, 64, 0.2), (0.04, 96, 0.7), (0.02, 128, 0.5)))
    pf = free_problems(free, batch, seed=1)
    pk = obstacle_problems(k8, batch, seed=1, n_dynamic=2)
    return {"solve_batch_free": ((lambda: solve_batch(free, pf)),
                                 f"solve_batch free split N=50 B={batch}"),
            "solve_batch_k8_dyn2": ((lambda: solve_batch(k8, pk)),
                                    f"solve_batch k8_dyn2 split N=50 B={batch}")}


def batch_solver_cell(batch):
    """One split `make_batch_solver` call on the K=8 cell with its refine
    stages (a graph on the card, the stages' gathers and merges inside)."""
    from kissmpc_tpu_torch import make_batch_solver
    from kissmpc_tpu_torch.scenarios import obstacle_problems

    cfg = k8_config(((0.125, 64, 0.2), (0.04, 96, 0.7), (0.02, 128, 0.5)))
    problems = obstacle_problems(cfg, batch, seed=1, n_dynamic=2)
    solve = make_batch_solver(cfg)
    return (lambda: solve(problems)), f"make_batch_solver k8_dyn2 split N=50 B={batch}"


def fleet_cell():
    """One closed-loop fleet tick of chip_smoke.py's phase 7 (B=4096, grid
    worlds, fused backend; `fleet_step` and `obstacles.advance` as one
    program), on the first tick's state every call."""
    import chip_smoke

    cfg, params = chip_smoke.fleet_config()
    env, obstacles, _ = chip_smoke.fleet_worlds(cfg, chip_smoke.FLEET_BATCH, 0, "cuda")
    return (lambda: chip_smoke.fleet_tick(cfg, params, env, obstacles, "cuda")), \
        f"fleet tick B={chip_smoke.FLEET_BATCH} N={cfg.horizon}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--cells", default="node,make_solver")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--replays", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_split: CUDA is not available")
    from kissmpc_tpu_torch.solver import graph

    wrap_ipm()
    wanted = args.cells.split(",")
    cells = {}
    if "node" in wanted:
        cells["node"] = node_cell()
    if "make_solver" in wanted:
        cells["make_solver"] = make_solver_cell(args.batch)
    if "solve_batch" in wanted:
        cells.update(solve_batch_cells(args.batch))
    if "batch_solver" in wanted:
        cells["batch_solver"] = batch_solver_cell(args.batch)
    if "fleet" in wanted:
        cells["fleet"] = fleet_cell()
    card = torch.cuda.get_device_name(0)
    for name, (fn, what) in cells.items():
        with graph.eager():
            fn()
            out = profiled(fn, args.top)
        if args.replays and not name.startswith("solve_batch"):
            out["replays"] = replayed(fn, args.replays)
            out["replay_profile"] = replay_kernels(fn, args.top)
        print(json.dumps({"cell": name, "what": what, "device": card, **out}), flush=True)


if __name__ == "__main__":
    main()
