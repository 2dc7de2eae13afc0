#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`kissmpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. build the three CUDA libraries from `kissmpc_tpu_torch/csrc/` (one nvcc
   per source, all started together) and print each ptxas register/spill
   line; for the fused kernel's instance of each configuration, its
   registers, local bytes, dynamic shared memory per block and the
   scenarios resident per SM (`ops/ipm_fused.py::occupancy`); the same for
   the Riccati kernel in float32 and float64 at B=8192 and 164 (its two
   chunk lengths), with its lanes and scenarios per block
   (`ops/riccati.py::occupancy`);
2. hold the Riccati kernel against its plain PyTorch version (`ops/lqr.py`)
   on the card, dx, du and the gains K, k, on LQR data from a real IPM
   iterate of the K=8 benchmark batch (N=50): float32 at B=8192 and at the
   refine stages' batches 1024, 410, 328, 164, float64 at B=8192 and 164,
   each output of each scenario within its own tolerance (`riccati_gate`:
   f32 1e-4 of its scale plus four times the plain version's own
   f32-vs-f64 gap there, f64 1e-9 of its scale;
   `scripts/riccati_gate_faults.py` shows planted faults failing it); time
   each by `kernel_ms` (20 launches captured in a CUDA graph between one
   event pair) beside its bound, and once at B=8192 as before, one call
   per event pair with the wrapper's host work inside;
3. the trip-count probe: counts 0, 7 and then 31 read from device memory
   by one loaded library; the results must be exactly those counts; timed
   at 31 trips and at 0 (its launch floor) by `kernel_ms`, beside
   `torch.add(x, iters)`, the one PyTorch call of the same function, whose
   result must equal the kernel's exactly;
4. hold the fused IPM kernel against its plain version on the card at
   B=8192, N=50, float32, for both benchmark configurations and for
   k8_dyn2_elastic (k8_dyn2 with elastic obstacle constraints, the kernel's
   elastic branch): at one iteration within 1e-4 of the solution's scale
   plus twice the plain version's own f32-vs-f64 gap; at 32 iterations
   converged flags differ on at most 1% of scenarios, or on twice as many
   as the plain version's own flags change under a one-ulp perturbation of
   the initial states (up and down, the larger) if that is more (the flag
   noise floor, which planted faults of the elastic branch exceed; at 32
   iterations 17% of elastic scenarios are still unconverged, many at the
   threshold), and 95% of the scenarios converged on both agree within
   1e-3 (free) / 2e-3 (K=8, both branches); the same gates at B=164, the
   last refine stage's batch, for the K=8 cells; time each at 32
   iterations (`kernel_ms`, 5 calls per event pair), and, one call per
   event pair as a solve stage makes it, the kernel alone at every solve
   stage's (B, iterations)
   of the three cells and of the fleet loop, beside the recorded time of
   the earlier one-thread-per-scenario kernel there;
5. drive the main path, `solve_batch` with the default ("fused") backend, at
   the benchmark's configurations (`bench.py`): N=50, B=8192, float32,
   32 IPM iterations plus staged refinement, obstacle-free and K=8 circles
   with 2 dynamic tracks, and k8_dyn2_elastic.  One warm-up and 5 timed
   calls each, on distinct batches drawn from a pool of 16384.  Every call
   launches the fused kernel once per solve stage and the Riccati kernel
   never.  Then the same for the "split" backend (free and K=8), whose
   Riccati launches must equal the IPM iterations run, and one call each of
   split with mehrotra "pc" and "soc" on the free configuration, whose
   Riccati launches must equal twice the iterations run;
6. check 64 scenarios of each configuration against the port's CPU path:
   the fused kernel against its plain version on the CPU in float32, the
   split path in float64 and float32, and in float64 the split path with
   elastic obstacles and with mehrotra "pc" and "soc";
7. the closed loop: `environment.fleet_step` plus `obstacles.advance` per
   tick at the configuration of `scripts/bench_fleet_episodes.py` (N=50,
   K=8, 32 iterations plus two refine stages, B=4096 episode worlds routed
   by the "grid" router, the batched grid planner on a 96-cell grid with 3
   route points per leg, 50 ticks), 3 fused launches per tick, each
   launch timed by CUDA events to give the fused stages' share of a tick;
   the world build's time and its fraction of reachable legs; one replan
   from the current poses at the middle tick (as the bench's, timed, and
   left out of the tick latencies); a short loop on "detour" worlds for
   that router's tick time beside it; then 64 episodes x 5 ticks on the
   card and on the CPU port, whose waypoint indices must match on 95% of
   episode-ticks and whose executed states must agree within 1e-3 on 95%
   of them;
8. the planner: `plan_waypoint_chain` and `bottleneck_clearance` timed at
   the fleet's B=4096 on the card, then 64 episodes on the card and on the
   CPU port: leg reachability equal, route points within 1e-4 m and
   clearances within 1e-5 m on at least 63 of 64 episodes (the log names
   any that differ);
9. `lab_worlds` on a synthetic 820 x 1520 px P5 map written from a seed
   into a temporary directory (rrc_lab's ~41 x 76 m at 0.05 m per pixel):
   B=4096 worlds built on the card and timed, and 64 episodes on the card
   against the CPU port as in phase 8;
10. the kernels' horizon limits: the fused kernel at its longest horizon
   (`ops/ipm_fused.py::max_horizon`, one warp per block) for K=0 and K=8,
   B=64, held to phase 4's one-iteration gate after 3 iterations and
   timed; one step more raises ValueError before any launch; the Riccati
   kernel one step above its longest on-chip horizon (the global-gains
   instance) and at N=2000, float32 and float64, B=9 and 1025, by phase
   2's gate, timed at N=2000;
11. the perception-in-the-loop fleet tick of
   `scripts/bench_perception_tick.py` at its default size: B=2048 episode
   worlds (grid router, 2 waypoints), N=50, K=8 solver slots, 32 iterations
   plus two refine stages; 2048 perception pipelines (projection, DBSCAN,
   tracker of 4 slots) fed one frame of the port's synthetic walk per tick
   (61 frames at 0.1 s, P=128, M=1, 48x64), their tracked humans offset
   to each episode's start and joined to its static circles; the
   solver-only and perception variants alternate in chunks of 8 ticks
   (56 timed ticks each after one at frame 0), 3 fused launches per tick;
   tick p50 and p99 of each and their difference, converged fraction and
   tracked total; the perception step's CUDA-event time and DBSCAN's share
   of it, and its kernels by the profiler; gates: at the last tick exactly
   B confirmed tracks, each within 0.25 m of the walk's ground truth,
   converged >= 0.90 in both variants; then 64 pipelines x 10 frames on the
   card and on the CPU port: found flags, DBSCAN labels and track ids
   equal, centres and track positions within 1e-5 m on at least 63;
12. the single-robot node: `io.Model` at the node's defaults (N=7,
   planning dt 0.8, 40 iterations) with 4 obstacle slots, driven by
   `io.pubsub.ControlLoop` for 50 ticks (odometry every tick, the walk's
   tracked humans from `io.frames.replay_session` every 10); tick p50 and
   p99 against the 10 ms period of the node's 100 Hz timer; Riccati
   launches per tick (must equal the iterations run) and their CUDA-event
   share of a tick; gates: the first 10 ticks' commands within 1e-3 of the
   CPU port's on the same inputs, and the kernel against its plain version
   by phase 2's gate on one tick's LQR data (B=1, N=7);
13. the data-parallel fleet (`parallel.fleet`) over a one-rank NCCL group
   from an in-process store: `make_fleet_solver` on the K=8 cell at B=8192
   bitwise equal to `solve_batch` and its `FleetMetrics` equal to that
   call's diagnostics', its collectives per call, p50 of 5 calls beside
   `solve_batch`'s; `make_fleet_env_stepper` for 10 ticks at B=4096 (grid
   worlds) with its EnvState bitwise equal to `fleet_step`'s every tick,
   both ticks' p50; `multihost.health_check` True within its timeout;
14. the associative-scan LQR (`ops/lqr_pt.py`) against the Riccati kernel
   on phase 2's data (N=50, B=8192, float32 and float64) and phase 10's
   (N=2000, B=1025, float64 and float32): on phase 2's data each
   scenario's KKT residual within 1e-3 (f32) / 1e-6 (f64) of its data's
   scale, dx and du against the kernel's output reported (there the
   sequential solve is not the more accurate one); at N=2000 in float64 dx
   and du within phase 2's per-scenario limits against the kernel's
   output, in float32 reported (not conditioned for the method); each timed
   beside the kernel, the backward scan apart from the forward recovery,
   and one call's kernels at N=2000 counted by the profiler;
15. the CLI on the card: `demo --ticks 60`, `map` and `lab --batch 256
   --ticks 50` on phase 9's synthetic map (written again from its seed),
   each returning 0; one fleet tick (B=4096) in `utils.profiling.trace`
   with an `annotate("fleet_tick")` span, whose trace must name the span
   and the fused kernel; `measure` on `solve_batch` (K=8, B=8192); a
   `FleetCheckpoint` of the fleet's EnvState saved, restored onto the card
   bitwise, and its next tick bitwise equal to the uninterrupted one.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N = 50
BATCH = 8192
POOL = 16384
CALLS = 5
# Staged tail refinement of the benchmark (bench.py:36-37).
STAGES_FREE = ((0.05, 64, 0.2),)
STAGES_OBST = ((0.125, 64, 0.2), (0.04, 96, 0.7), (0.02, 128, 0.5))
# H100 SXM data-sheet peaks: HBM bytes/s,
# float32 and float64 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
# Floating-point operations of one Riccati step per scenario, counted from
# the function as one thread computes it (an FMA is two): backward sweep
# 395, forward rollout 50.  What csrc/riccati.cu computes twice across the
# lanes of a scenario (B'PB and the inverse) is its own cost.
RICCATI_FLOPS_PER_STEP = 445
# Batches the split path hands the Riccati kernel: the base solve and the
# refine stages of the free (410) and K=8 (1024, 328, 164) cells.
RICCATI_BATCHES = (8192, 1024, 410, 328, 164)
RICCATI_F64_BATCHES = (8192, 164)
FUSED_ITERATIONS = 32
PROBE_TRIPS = (0, 7, 31)
# Closed loop of scripts/bench_fleet_episodes.py:81-120, cut to 50 ticks,
# its worlds routed by the grid planner as the bench routes them (:114-120)
# and replanned once from the current poses at the middle tick (:200-215).
FLEET_BATCH = 4096
FLEET_TICKS = 50
FLEET_STAGES = ((0.125, 64, 0.2), (0.02, 96, 0.7))
FLEET_CHECK = (64, 5)  # episodes x ticks held against the CPU port
FLEET_PLANNER_GRID = 96
FLEET_POINTS_PER_LEG = 3
DETOUR_TICKS = 10  # the short loop on "detour" worlds, for its tick time
# Phases 8 and 9: episodes planned on the card and on the CPU port, at
# least PLANNER_AGREE of them within the tolerances.
PLANNER_CHECK = 64
PLANNER_AGREE = 63
PLANNER_POINT_TOL = 1e-4  # m
PLANNER_CLEAR_TOL = 1e-5  # m
LAB_BATCH = 4096
LAB_MAP_PX = (820, 1520)  # rows, columns: ~41 x 76 m at 0.05 m per pixel
# Phase 10: the Riccati kernel's long horizons (N above the on-chip limit
# is added per dtype) and batches, and the fused kernel's edge batch.
RICCATI_LONG_N = 2000
RICCATI_LONG_BATCHES = (9, 1025)
EDGE_BATCH = 64
EDGE_ITERATIONS = 3
# Phase 11: the perception-in-the-loop fleet tick of
# scripts/bench_perception_tick.py:25-160 at its default size: B episodes,
# the walk of FRAMES_DT, TRACK_CAPACITY tracker slots, PERCEPTION_TICKS ticks
# with the two variants alternating in chunks of PERCEPTION_CHUNK.
PERCEPTION_BATCH = 2048
PERCEPTION_TICKS = 60
PERCEPTION_CHUNK = 8
PERCEPTION_STAGES = ((0.125, 64, 0.2), (0.02, 96, 0.7))
PERCEPTION_OFFSET = (1.2, 0.0)  # the walk crosses ~1.5 m ahead of each robot
TRACK_CAPACITY = 4
FRAMES_DT = 0.1
TRACK_TRUTH_TOL = 0.25  # m, tests/test_perception.py:449-455
PERCEPTION_CHECK = (64, 10)  # pipelines x frames held against the CPU port
PERCEPTION_AGREE = 63
PERCEPTION_TOL = 1e-5  # m, centres and track positions
# Phase 12: the single-robot node (io.Model at its defaults, N=7, planning
# dt 0.8, 40 iterations, with 4 obstacle slots) through io.pubsub's
# ControlLoop at the reference node's 100 Hz (kissmpc_tpu/io/ros2.py:95,145).
NODE_TICKS = 50
NODE_PERIOD_MS = 10.0
NODE_CHECK_TICKS = 10
NODE_CMD_TOL = 1e-3
NODE_FIRST_FRAME = 20  # the walker is confirmed and ahead of the robot
NODE_PLAN = ((1.5, 0.4, 0.0), (3.0, 0.0, 0.0))
# Phase 4 also holds the kernel to its plain version at the last refine
# stage's batch of the K=8 cells.
REFINE_CHECK_BATCH = 164
# Phase 13: the data-parallel fleet over a one-rank NCCL group.
DP_CALLS = 5
DP_TICKS = 10
GROUP_TIMEOUT_S = 120.0
# Phase 14: the associative-scan LQR.  Each scenario's KKT residual
# (`ops/lqr.py::kkt_residual`) relative to its data's largest magnitude, on
# phase 2's data.  Sound solves sit far below the limits (on an H100: f32
# 7.8e-6, f64 8.7e-10, the Riccati kernel 1.9e-6, 3.3e-8; on the scenarios
# of `scripts/lqr_pt_accuracy.py --batch 8192`: 1.3e-6, 1.8e-10), planted
# faults far above (its `--faults`: 0.24 or more).
LQR_PT_KKT_REL = {"float32": 1e-3, "float64": 1e-6}
# Phase 15: the CLI and the utils.
DEMO_TICKS = 60
CLI_LAB_BATCH = 256
CLI_LAB_TICKS = 50
# The earlier fused kernel (one thread per scenario, iterate in global
# scratch) at each solve stage, (B, iterations): ms, CUDA events around the
# wrapper's call, NVIDIA H100 80GB HBM3 at 700 W (recorded in PERF.md).
THREAD_KERNEL_STAGE_MS = {
    "free": {(8192, 32): 40.59, (410, 64): 55.30},
    "k8_dyn2": {(8192, 32): 105.01, (1024, 64): 112.63, (328, 96): 198.48, (164, 128): 255.72},
    "k8_dyn2_elastic": {(8192, 32): 120.90, (1024, 64): 151.41, (328, 96): 240.09,
                        (164, 128): 311.81},
    "fleet_b4096": {(4096, 32): 64.42, (512, 64): 112.13, (82, 96): 190.44},
}


def fused_ops_per_iteration(n, k, ls_iters, elastic=False):
    """Operations of one IPM iteration per scenario, counted from the
    function, as both implementations (the TPU kernel and
    csrc/ipm_fused.cu) compute it: what one of them recomputes, or spends
    on moving data between lanes, is its own cost.  Each add, multiply,
    compare-and-select, min, max, abs, division, sqrt, sin, cos and log
    counts as one operation and an FMA as two, so the bound is optimistic:
    the card spends several instructions on each division and
    transcendental.  Per pass:

    reduce     11 per box element, 22 per obstacle element (its geometry,
               16, included);
    backward   per stage 19 (linearisation with sin, cos) + 63 (control
               condensation) + 96 (state condensation) + 182 (Riccati step
               and adjoint) + 53 per obstacle;
    rollout    55 per stage;
    steps      24 per box element, 41 per obstacle element;
    merit      per candidate: 80 per state, 69 per control (defects with
               sin, cos; costs; log barrier), 47 per obstacle element;
    update     26 per box element, 45 per obstacle element, 10 per stage.

    The elastic branch adds, per obstacle element, with its step counted
    once per iteration as the function needs it (both kernels compute it
    once and reuse it): +21 in the condensation (the elastic gradient in
    place of the hard one); its coefficients (el_coef, 23) and eliminated step
    (el_step, 17) once; +6 for the third fraction to the boundary (on e);
    +9 per merit candidate (trial e, its log, rho_e * e, the
    consistency's e); +2 in the update (the e step); less the hard slack
    and dual steps it replaces (14 in the steps pass, 14 in the update).
    """
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    ops = (
        11 * box + 22 * obst
        + (360 + 53 * k) * n + 96 + 53 * k
        + 55 * n
        + 24 * box + 41 * obst
        + ls_iters * (80 * t1 + 69 * n + 47 * obst)
        + 26 * box + 45 * obst + 6 * t1 + 4 * n
    )
    if elastic:
        ops += obst * (21 + 40 + 6 - 14 + ls_iters * 9 + 2 - 14)
    return ops


def fused_ops_once(n, k, elastic=False):
    """Init and diagnostics, once per solve: about three merit passes and
    two reductions (see fused_ops_per_iteration); the elastic init merit
    adds log e, rho_e * e and e in the consistency (7 per obstacle element)."""
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    ops = 3 * (80 * t1 + 69 * n + 47 * obst) + 2 * (11 * box + 22 * obst)
    return ops + (7 * obst if elastic else 0)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def kernel_ms(fn, reps, warmup=2, graph=False, windows=3):
    """Device time of one call of ``fn`` with the host left out: ``reps``
    calls enqueued back to back between one pair of CUDA events, over
    ``reps``; the median of ``windows`` such pairs.  Without ``graph`` the
    host's work in each call (a wrapper's checks, allocations and ctypes
    call) overlaps the device's work on the calls before it, which holds for
    calls of a millisecond or more.  With ``graph`` the ``reps`` calls are
    captured once into a CUDA graph and the events bracket its replay, so a
    kernel shorter than its wrapper's host work (tens of microseconds) is
    timed alone too; ``fn`` must not synchronise.  Every call reads the same
    inputs, so L2 keeps what fits in its 50 MB: the real case in the split
    loop, where `_build_lqr` has just written the Riccati kernel's inputs;
    at B=8192 those are 59 MB in f32 and do not fit."""
    import torch

    for _ in range(warmup):
        fn()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            run()
        g.replay()
        run = g.replay
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cuda_ms(fn, reps, warmup=3):
    """Median over ``reps`` calls of ``fn``, each between its own pair of
    CUDA events (the host's work inside the call included): for a caller's
    own pattern of calls, such as one solve stage."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def configs(backend):
    """The benchmark's two configurations (bench.py:103-129) and k8_dyn2
    with elastic obstacle constraints (the default elastic_penalty) on
    ``backend`` ("fused" leaves SolverConfig's default in place)."""
    from kissmpc_tpu_torch import MPCConfig

    def make(K, stages, **solver):
        cfg = MPCConfig(horizon=N, time_step=0.041, max_obstacles=K)
        if backend != "fused":
            solver["solve_backend"] = backend
        return cfg.replace(solver=dataclasses.replace(
            cfg.solver, iterations=32, refine_stages=stages, **solver,
        ))

    return {
        # fused_block / fused_sublanes are TPU tile settings; nothing on the
        # card reads them.
        "free": make(0, STAGES_FREE, fused_block=256, fused_sublanes=2),
        "k8_dyn2": make(8, STAGES_OBST, mu_sigma_max=0.7, fused_affine_tracks=True),
        "k8_dyn2_elastic": make(8, STAGES_OBST, mu_sigma_max=0.7, fused_affine_tracks=True,
                                elastic_obstacles=True),
    }


def phase_build():
    import torch

    from kissmpc_tpu_torch.ops import _build, ipm_fused, probe, riccati

    sources = {
        "kissmpc_riccati": riccati.SOURCE,
        "kissmpc_probe": probe.SOURCE,
        "kissmpc_ipm_fused": ipm_fused.SOURCE,
    }
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(_build.build, src, name) for name, src in sources.items()}
        libs = {name: f.result() for name, f in futures.items()}
    for module in (riccati, probe, ipm_fused):
        module._library()
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"[1] built {', '.join(lib.name for lib in libs.values())} in {build_s:.3f} s")
    occupancy = {}
    for name, cfg in configs("fused").items():
        occupancy[name] = occ = ipm_fused.occupancy(cfg)
        branch = "elastic" if cfg.solver.elastic_obstacles else "hard"
        log(f"[1] fused kernel, {name} ({branch} instance): {occ['registers']} registers, "
            f"{occ['local_bytes']} bytes of local memory per thread (stack frame and spills, "
            f"as the ptxas lines above split them), {occ['smem_bytes_per_block']} "
            f"bytes of dynamic shared memory per block of {occ['warps_per_block']} warps, "
            f"{occ['blocks_per_sm']} blocks = {occ['scenarios_per_sm']} scenarios resident per SM")
        if occ["blocks_per_sm"] < 1:
            fail(f"the fused kernel cannot be resident for {name}")
    for dtype in (torch.float32, torch.float64):
        for B in (BATCH, RICCATI_BATCHES[-1]):
            occupancy[f"riccati_{str(dtype)[6:]}_b{B}"] = occ = riccati.occupancy(B, N, dtype)
            log(f"[1] Riccati kernel, {str(dtype)[6:]} B={B} N={N}: {occ['registers']} registers, "
                f"{occ['local_bytes']} bytes of local memory per thread, "
                f"{occ['lanes_per_scenario']} lanes per scenario, {occ['scenarios_per_block']} "
                f"scenarios and {occ['smem_bytes_per_block']} bytes of dynamic shared memory per "
                f"block, {occ['blocks_per_sm']} blocks = {occ['scenarios_per_sm']} scenarios "
                f"resident per SM")
            if occ["blocks_per_sm"] < 1:
                fail(f"the Riccati kernel cannot be resident ({dtype}, B={B})")
    return build_s, occupancy


def lqr_from_iterate(cfg, problems, iterations=8):
    """LQR data of the IPM's Newton system after a few iterations."""
    import torch

    from kissmpc_tpu_torch.solver import ipm

    with torch.no_grad():
        it = ipm._init_state(cfg, problems)
        masks = ipm._constraint_masks(cfg, problems, it.states.dtype)
        for _ in range(iterations):
            it = ipm._iteration(cfg, problems, it, ipm._adaptive_mu(cfg, it, masks))
        return ipm._build_lqr(cfg, problems, it, ipm._adaptive_mu(cfg, it, masks))


def riccati_bound(batch, dtype, n=N):
    """The Riccati kernel's least time on the card for ``batch`` scenarios
    at horizon ``n``: (bound ms, "bytes" or "operations", bytes, flop).
    Bytes: every input read once (A, B, d, d0, Qxx, qx, Quu, qu) and dx, du
    and the [B, n, 8] gains K, k written once."""
    import torch

    size = 4 if dtype == torch.float32 else 8
    inputs = (9 + 6 + 3 + 4 + 2) * n + 3 + (9 + 3) * (n + 1)
    outputs = 3 * (n + 1) + 2 * n + 8 * n
    n_bytes = size * batch * (inputs + outputs)
    flops = RICCATI_FLOPS_PER_STEP * n * batch
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / (PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, flops


RICCATI_OUTPUTS = ("dx", "du", "K", "k")
# How many times the plain version's own f32-vs-f64 gap in a scenario the
# kernel may differ from it there, above 1e-4 of the scale: in a scenario
# whose f32 round-off is amplified far above that floor, each f32 solve's
# error is one draw of the same size, and the plain version's may be the
# small one.  On phase 2's data at B=8192 the kernel as written, its build
# without FMA contraction and the earlier one-thread-per-scenario kernel
# need 3.18, 2.39 and 2.78 (dx, du of one scenario) where every other one
# passes at 2, and planted faults need 788 or more
# (scripts/riccati_gate_faults.py).
RICCATI_NOISE_FACTOR = 4.0


def riccati_gate(got, data, reg, ref=None, outputs=RICCATI_OUTPUTS):
    """Phase 2's gate: the kernel's solution ``got`` of ``data`` against the
    plain version's (or against ``ref``, another solution of ``data``,
    whose own f32-vs-f64 gap then takes the plain version's place), each
    of ``outputs`` (dx, du, K, k) of each scenario held to its
    own tolerance, so that one ill-conditioned scenario cannot widen the
    limit of another, nor its gains the limit of its rollout.  In float32
    1e-4 of that scenario's scale of that output (its largest magnitude, at
    least 1) plus RICCATI_NOISE_FACTOR times the plain version's own
    f32-vs-f64 gap there: the two sum in different orders over an N-step
    recurrence, and a scenario's conditioning amplifies the round-off of
    both alike.  In float64 1e-9 of the scale.  Works on any device.
    Returns {"ok", "err" (max |kernel - plain| over everything), "outputs":
    {name: {"err", "scenario" (the one nearest its limit), "err_at",
    "tol_at", "scale_at", "ratio"; in float32
    also "kernel64", "plain64" (largest gaps to the f64 solve) and
    "kernel_further" (scenarios where the kernel is further from it than the
    plain version)}}}."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr

    f32 = data.A.dtype == torch.float32
    ref = solve_lqr(data, reg) if ref is None else ref
    ref64 = solve_lqr(LQRData(*(x.double() for x in data)), reg) if f32 else ref
    B = data.A.shape[0]
    ok, gated = True, {}
    for name in outputs:
        i = RICCATI_OUTPUTS.index(name)
        g, r, r64 = got[i], ref[i], ref64[i]
        g = g.reshape(B, -1).double()
        r = r.reshape(B, -1).double().to(g.device)
        err = (g - r).abs().amax(1)
        scale = r.abs().amax(1).clamp(min=1.0)
        if f32:
            r64 = r64.reshape(B, -1).to(g.device)
            plain64 = (r - r64).abs().amax(1)
            kernel64 = (g - r64).abs().amax(1)
            tol = 1e-4 * scale + RICCATI_NOISE_FACTOR * plain64
        else:
            tol = 1e-9 * scale
        ratio = torch.where(torch.isfinite(g).all(1), err / tol,
                            torch.full_like(err, float("inf")))
        worst = int(ratio.argmax())
        out = {"err": float(err.max()), "scenario": worst, "err_at": float(err[worst]),
               "tol_at": float(tol[worst]), "scale_at": float(scale[worst]),
               "ratio": float(ratio[worst])}
        if f32:
            out.update(kernel64=float(kernel64.max()), plain64=float(plain64.max()),
                       kernel_further=int((kernel64 > plain64).sum()))
        ok = ok and out["ratio"] <= 1.0
        gated[name] = out
    return {"ok": ok, "err": max(o["err"] for o in gated.values()), "outputs": gated}


def check_riccati(data, reg, phase=2):
    """``riccati_gate`` on the kernel's solution of ``data``, logged per
    output under ``phase``; fails the run if the gate fails.  Returns the
    gate."""
    import torch

    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

    got = solve_lqr_cuda(data, reg)
    torch.cuda.synchronize()
    g = riccati_gate(got, data, reg)
    B, n, dtype = data.A.shape[0], data.A.shape[1], str(data.A.dtype)[6:]
    for name, o in g["outputs"].items():
        extra = (f"; vs f64: kernel {o['kernel64']:.3e}, plain {o['plain64']:.3e}, the kernel "
                 f"further in {o['kernel_further']} of {B}" if "kernel64" in o else "")
        log(f"[{phase}] Riccati {dtype} B={B} N={n} {name}: max|kernel-plain| {o['err']:.3e}; "
            f"nearest its limit: scenario {o['scenario']}, {o['err_at']:.3e} against tol "
            f"{o['tol_at']:.3e} (scale {o['scale_at']:.3e}), {o['ratio']:.3f} of it{extra}")
    if not g["ok"]:
        fail(f"Riccati kernel disagrees with its plain version ({dtype}, B={B}, N={n}): "
             + ", ".join(f"{k} {o['ratio']:.3f} of its limit" for k, o in g["outputs"].items()))
    return g


def phase_kernel(cfg, pool):
    """The Riccati kernel against its plain version on LQR data of a real
    IPM iterate (K=8, B=8192; the smaller batches are its first B
    scenarios), in float32 at every batch the split path hands it and in
    float64 at B=8192 and 164; each timed by kernel_ms with its bound."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather

    reg = cfg.solver.reg
    data = lqr_from_iterate(cfg, gather(pool, torch.arange(BATCH, device="cuda")))
    rows = []
    for dtype, batches in ((torch.float32, RICCATI_BATCHES), (torch.float64, RICCATI_F64_BATCHES)):
        full = LQRData(*(x.to(dtype) for x in data))
        for B in batches:
            sub = LQRData(*(x[:B].contiguous() for x in full))
            gate = check_riccati(sub, reg)
            ms = kernel_ms(lambda: solve_lqr_cuda(sub, reg), reps=20, graph=True)
            bound_ms, bound_by, n_bytes, flops = riccati_bound(B, dtype)
            rows.append({"dtype": str(dtype)[6:], "B": B, "ms": ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": gate["err"],
                         "gate": {k: [o["err"], o["err_at"], o["tol_at"], o["ratio"]]
                                  for k, o in gate["outputs"].items()}})
            log(f"[2] Riccati kernel {str(dtype)[6:]} B={B}: {ms:.5f} ms, {ms / bound_ms:.2f}x "
                f"its bound {bound_ms:.5f} ms ({n_bytes} bytes -> "
                f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.5f} ms; {flops} flop; {bound_by})")
    single_ms = cuda_ms(lambda: solve_lqr_cuda(data, reg), reps=30)
    log(f"[2] Riccati kernel f32 B={BATCH}, one call per event pair (the wrapper's host work "
        f"inside, as timed before): {single_ms:.5f} ms; 20 launches per event pair in a CUDA "
        f"graph: {rows[0]['ms']:.5f} ms")
    plain_ms = kernel_ms(lambda: solve_lqr(data, reg), reps=3, warmup=1)
    data64 = LQRData(*(x.double() for x in data))
    plain64_ms = kernel_ms(lambda: solve_lqr(data64, reg), reps=3, warmup=1)
    log(f"[2] Riccati plain version B={BATCH}: f32 {plain_ms:.4f} ms, f64 {plain64_ms:.4f} ms")
    main, main64 = rows[0], rows[len(RICCATI_BATCHES)]
    return {
        "name": "riccati",
        "route": "cuda",
        "source": "kissmpc_tpu_torch/csrc/riccati.cu",
        "replaces": "kissmpc_tpu/ops/pallas/riccati.py:98",
        "launches": None,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "f64_ms": main64["ms"],
        "f64_plain_ms": plain64_ms,
        "f64_bound_ms": main64["bound_ms"],
        "f64_bound_by": main64["bound_by"],
        "single_call_ms": single_ms,
        "batch_ms": rows,
    }


def phase_probe():
    import torch

    from kissmpc_tpu_torch.ops.probe import dynamic_trip, dynamic_trip_plain

    x = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    counts = {}
    for trips in PROBE_TRIPS:
        counts[trips] = iters = torch.tensor([trips], dtype=torch.int32, device="cuda")
        got = dynamic_trip(x, iters)
        ref = dynamic_trip_plain(x, iters)
        torch.cuda.synchronize()
        vals = torch.unique(got).tolist()
        log(f"[3] probe, trip count {trips} from device memory: values {vals}")
        if vals != [float(trips)] or not torch.equal(got, ref):
            fail(f"probe kernel gave {vals} for {trips} trips")
    iters = counts[PROBE_TRIPS[-1]]
    floor_ms = kernel_ms(lambda: dynamic_trip(x, counts[0]), reps=50, graph=True)
    ms = kernel_ms(lambda: dynamic_trip(x, iters), reps=50, graph=True)
    plain_ms = kernel_ms(lambda: dynamic_trip_plain(x, iters), reps=10)
    # One PyTorch call computes the same function: x + iters[0], broadcast.
    library = torch.add(x, iters)
    torch.cuda.synchronize()
    if library.dtype != torch.float32 or not torch.equal(library, dynamic_trip(x, iters)):
        fail("torch.add(x, iters) differs from the probe kernel")
    library_ms = kernel_ms(lambda: torch.add(x, iters), reps=50, graph=True)
    n_bytes = 2 * x.numel() * x.element_size() + iters.element_size()
    flops = PROBE_TRIPS[-1] * x.numel()
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    log(f"[3] probe kernel {ms:.5f} ms at {PROBE_TRIPS[-1]} trips, {floor_ms:.5f} ms at 0 trips "
        f"(its launch floor), plain {plain_ms:.4f} ms, torch.add {library_ms:.5f} ms "
        f"({n_bytes} bytes -> {bytes_ms:.3e} ms; {flops} flop -> {ops_ms:.3e} ms)")
    return {
        "name": "probe_dynamic_trip",
        "route": "cuda",
        "source": "kissmpc_tpu_torch/csrc/probe_dynamic_trip.cu",
        "replaces": "scripts/probe_dynamic_trip.py:20",
        "launches": 0,  # not on the main path: a probe of the fused kernel's trip count
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "launch_floor_ms": floor_ms,
    }


def solution_gap(a, b):
    """Largest |a - b| over states and controls."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in ((a.states, b.states), (a.controls, b.controls)))


def plain_reference(cfg, batch):
    """The plain version's side of phase 4's gates on ``batch``: its
    one-iteration solution and that solution's own f32-vs-f64 gap, its
    FUSED_ITERATIONS solution, and the flag noise floor: how many of its
    converged flags change under a one-ulp nudge of x0, up and down."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused_plain
    from kissmpc_tpu_torch.solver.problem import Problem

    ref1 = solve_batch_fused_plain(cfg, batch, iterations=1)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in batch)), iterations=1)
    ref = solve_batch_fused_plain(cfg, batch, iterations=FUSED_ITERATIONS)
    x0, noises = batch.initial_state, []
    for toward in (np.inf, -np.inf):
        nudged = batch._replace(initial_state=torch.nextafter(x0, torch.full_like(x0, toward)))
        ref_nudged = solve_batch_fused_plain(cfg, nudged, iterations=FUSED_ITERATIONS)
        noises.append(int((ref_nudged.diagnostics.converged != ref.diagnostics.converged).sum()))
    return {"one": ref1, "plain64": solution_gap(ref1, ref64), "full": ref, "noises": noises}


def fused_gates(ref, got1, got, tol):
    """Phase 4's gates on a kernel's one-iteration and FUSED_ITERATIONS
    solutions ``got1``, ``got`` against ``plain_reference``'s ``ref``."""
    import torch

    scale = max(1.0, float(ref["one"].states.abs().max()),
                float(ref["one"].controls.abs().max()))
    err1 = solution_gap(got1, ref["one"])
    tol1 = 1e-4 * scale + 2.0 * ref["plain64"]
    finite = bool(torch.isfinite(got1.states).all() and torch.isfinite(got1.controls).all())
    c_k, c_p = got.diagnostics.converged, ref["full"].diagnostics.converged
    batch = c_p.shape[0]
    flip_limit = max(0.01 * batch, 2 * max(ref["noises"]))
    flips = int((c_k != c_p).sum())
    both = c_k & c_p
    diff = (got.controls - ref["full"].controls).abs().flatten(1).amax(dim=1)
    within = float((diff[both] <= tol).float().mean()) if bool(both.any()) else 0.0
    return {
        "ok_one": finite and err1 <= tol1,
        "ok_full": flips <= flip_limit and within >= 0.95,
        "err1": err1, "tol1": tol1, "scale": scale,
        "converged": float(c_k.float().mean()),
        "plain_converged": float(c_p.float().mean()),
        "flips": flips, "flip_limit": flip_limit, "within": within,
        "both": int(both.sum()),
        "worst": float(diff[both].max()) if bool(both.any()) else float("nan"),
        "max_all": float(diff.max()),
    }


def fused_bound(cfg, batch, iterations, n=N):
    """The fused kernel's least time on the card for ``batch`` scenarios,
    ``iterations`` and horizon ``n``: (bound ms, "bytes" or "operations",
    bytes, operations).  Bytes: its inputs read once and its outputs
    written once (the iterate never leaves the chip)."""
    K = cfg.max_obstacles
    elastic = cfg.solver.elastic_obstacles
    in_rows = 27 + 3 * (n + 1) + 2 * n + (4 * K + 2 * K + 1 if K else 0)
    out_rows = 3 * (n + 1) + 2 * n + 6
    n_bytes = 4 * (in_rows + out_rows) * batch + 4
    ops = batch * (iterations * fused_ops_per_iteration(n, K, cfg.solver.ls_iters, elastic)
                   + fused_ops_once(n, K, elastic))
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, ops


def check_fused(name, cfg, batch, tol):
    """Phase 4's gates on one batch; returns their readings."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused

    B = batch.initial_state.shape[0]
    ref = plain_reference(cfg, batch)
    g = fused_gates(ref, solve_batch_fused(cfg, batch, iterations=1),
                    solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS), tol)
    torch.cuda.synchronize()
    log(f"[4] fused {name} B={B} iterations=1: max|kernel-plain| {g['err1']:.3e} "
        f"(tol {g['tol1']:.3e}, scale {g['scale']:.3e}, plain f32-f64 {ref['plain64']:.3e})")
    if not g["ok_one"]:
        fail(f"fused kernel disagrees with its plain version at one iteration ({name}, B={B})")
    log(f"[4] fused {name} B={B} iterations={FUSED_ITERATIONS}: converged kernel "
        f"{g['converged']:.5f}, plain {g['plain_converged']:.5f}; flags differ on "
        f"{g['flips']} (limit {g['flip_limit']:g}; the plain version's flags change on "
        f"{ref['noises']} under a one-ulp nudge of x0 up, down); {g['within']:.5f} of "
        f"{g['both']} converged on both within {tol} (max {g['worst']:.3e}); max over all "
        f"{g['max_all']:.3e}")
    if not g["ok_full"]:
        fail(f"fused kernel disagrees with its plain version at {FUSED_ITERATIONS} "
             f"iterations ({name}, B={B})")
    return g


def phase_fused_kernel(cfgs, pools):
    """The fused kernel against its plain version on the card, B=8192, and
    at the last refine stage's batch of the K=8 cells: {configuration: its
    kernels-line entry}."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
    from kissmpc_tpu_torch.solver.problem import gather

    entries = {}
    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3), ("k8_dyn2_elastic", 2e-3)):
        cfg = cfgs[name]
        batch = gather(pools[name], torch.arange(BATCH, device="cuda"))
        g = check_fused(name, cfg, batch, tol)
        if cfg.max_obstacles:
            check_fused(name, cfg, gather(pools[name], torch.arange(
                REFINE_CHECK_BATCH, device="cuda")), tol)
        ms = kernel_ms(lambda: solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS),
                       reps=5, warmup=1)
        plain_ms = kernel_ms(
            lambda: solve_batch_fused_plain(cfg, batch, iterations=FUSED_ITERATIONS),
            reps=1, warmup=0, windows=1)
        bound_ms, bound_by, n_bytes, ops = fused_bound(cfg, BATCH, FUSED_ITERATIONS)
        log(f"[4] fused {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at B={BATCH}, "
            f"{FUSED_ITERATIONS} iterations; bound {bound_ms:.4f} ms ({n_bytes} bytes, "
            f"{ops} operations: {bound_by}); {ms / bound_ms:.2f}x the bound")
        entries[name] = {
            "name": "ipm_fused",
            "route": "cuda",
            "source": "kissmpc_tpu_torch/csrc/ipm_fused.cu",
            "replaces": "kissmpc_tpu/ops/pallas/ipm_fused.py:108",
            "launches": None,
            "max_abs_err": g["err1"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        }
    return entries


def stage_shapes(cfg, batch):
    """(B, iterations, mu_sigma) of every solve stage of `solve_batch`."""
    shapes = [(batch, cfg.solver.iterations, None)]
    for frac, iters, mu_sigma in cfg.solver.refine_stages:
        shapes.append((min(batch, max(1, int(round(batch * frac)))), iters, mu_sigma))
    return shapes


def phase_fused_stages(cfgs, pools):
    """The kernel alone at every solve stage's (B, iterations) of the three
    cells and of the fleet loop, CUDA events around the wrapper's call (the
    earlier kernel's recorded time beside it in the log line only):
    [{cell, B, iterations, ms, ms_per_iteration, bound_ms}], all of this run."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.solver.problem import gather

    cells = dict(cfgs, fleet_b4096=fleet_config()[0])
    rows = []
    for cell, cfg in cells.items():
        pool = pools["k8_dyn2" if cell == "fleet_b4096" else cell]
        size = FLEET_BATCH if cell == "fleet_b4096" else BATCH
        for B, iters, mu_sigma in stage_shapes(cfg, size):
            sub = gather(pool, torch.arange(B, device="cuda"))
            ms = cuda_ms(lambda: solve_batch_fused(cfg, sub, iterations=iters,
                                                   mu_sigma=mu_sigma), reps=5, warmup=1)
            bound_ms = fused_bound(cfg, B, iters)[0]
            old = THREAD_KERNEL_STAGE_MS[cell][(B, iters)]
            rows.append({"cell": cell, "B": B, "iterations": iters, "ms": ms,
                         "ms_per_iteration": ms / iters, "bound_ms": bound_ms})
            log(f"[4] fused {cell} stage B={B} x {iters} it.: {ms:.4f} ms "
                f"({ms / iters:.5f} ms per iteration, {ms / bound_ms:.2f}x its bound "
                f"{bound_ms:.4f} ms); one-thread-per-scenario kernel {old} ms "
                f"({old / iters:.4f} per iteration): {old / ms:.2f}x faster")
    return rows


@contextlib.contextmanager
def stage_events():
    """Time every fused launch that `solve_batch` makes inside the block with
    CUDA events (the wrapper's packing included); yields the
    list of (B, start, end) it appends to."""
    import torch

    from kissmpc_tpu_torch.solver import api

    real = api.solve_batch_fused
    stages = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        stages.append((int(args[1].initial_state.shape[0]), start, end))
        return out

    api.solve_batch_fused = timed
    try:
        yield stages
    finally:
        api.solve_batch_fused = real


def timed_stages(cfg, batch):
    """One solve_batch call with each fused launch timed: [(B, ms), ...]."""
    import torch

    from kissmpc_tpu_torch.solver import api

    with stage_events() as stages:
        api.solve_batch(cfg, batch)
        torch.cuda.synchronize()
    return [(b, s.elapsed_time(e)) for b, s, e in stages]


def phase_main_path(backend, cfgs, pools, calls):
    """``calls`` timed solve_batch calls per configuration after a warm-up,
    with the launch counts of both kernels read around every call; the
    counts are set to 0 before the first configuration and read after the
    last."""
    import torch

    from kissmpc_tpu_torch import solve_batch
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather

    rng = np.random.default_rng(0)
    results = {}
    solve_lqr_cuda.launches = 0
    solve_batch_fused.launches = 0
    for name, cfg in cfgs.items():
        pool = pools[name]
        stages = len(cfg.solver.refine_stages)
        if backend == "fused":
            expected = {"fused": 1 + stages, "riccati": 0}
        else:
            its = cfg.solver.iterations + sum(it for _, it, _ in cfg.solver.refine_stages)
            expected = {"fused": 0, "riccati": its}
        lat, conv, usable = [], [], []
        for call in range(1 + calls):
            idx = torch.as_tensor(rng.permutation(POOL)[:BATCH], device="cuda")
            batch = gather(pool, idx)
            torch.cuda.synchronize()
            before = (solve_batch_fused.launches, solve_lqr_cuda.launches)
            t0 = time.perf_counter()
            sol = solve_batch(cfg, batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launched = {"fused": solve_batch_fused.launches - before[0],
                        "riccati": solve_lqr_cuda.launches - before[1]}
            if launched != expected:
                fail(f"{backend} {name}: launches {launched}, expected {expected}")
            if sol.controls.shape != (BATCH, N, 2) or sol.states.shape != (BATCH, N + 1, 3):
                fail(f"{name}: solution shapes {sol.states.shape} {sol.controls.shape}")
            if not (torch.isfinite(sol.controls).all() and torch.isfinite(sol.states).all()):
                fail(f"{name}: non-finite solution")
            frac = float(sol.diagnostics.converged.float().mean())
            use = float((sol.diagnostics.kkt_feasibility <= 1e-2).float().mean())
            log(f"[5] {backend} {name} call {call}{' (warm-up)' if call == 0 else ''}: "
                f"{elapsed * 1e3:.3f} ms, converged {frac:.5f}, usable {use:.5f}, "
                f"launches {launched}")
            if call:
                lat.append(elapsed * 1e3)
                conv.append(frac)
                usable.append(use)
        p50 = float(np.percentile(lat, 50))
        results[name] = {
            "backend": backend,
            "batch": BATCH,
            "calls": calls,
            "latency_p50_ms": p50,
            "latency_max_ms": max(lat),
            "solves_per_s": BATCH / (p50 / 1e3),
            "converged_fraction": float(np.mean(conv)),
            "usable_fraction": float(np.mean(usable)),
            "launches_per_call": expected,
        }
        log(f"[5] {backend} {name}: " + json.dumps(results[name]))
    floors = {"free": 0.95, "k8_dyn2": 0.90, "k8_dyn2_elastic": 0.90}
    for name in results:
        floor = floors[name]
        if results[name]["converged_fraction"] < floor:
            fail(f"{backend} {name}: converged fraction "
                 f"{results[name]['converged_fraction']} < {floor}")
    launches = {"fused": solve_batch_fused.launches, "riccati": solve_lqr_cuda.launches}
    key = "fused" if backend == "fused" else "riccati"
    if launches[key] == 0:
        fail(f"the {backend} main path never launched its kernel")
    return results, launches[key]


def phase_mehrotra(cfg, pool):
    """One timed `solve_batch` call each of split with mehrotra "pc" and
    "soc" on ``cfg`` at B=8192: two Riccati launches per IPM iteration."""
    import torch

    from kissmpc_tpu_torch import solve_batch
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather

    results = {}
    its = cfg.solver.iterations + sum(it for _, it, _ in cfg.solver.refine_stages)
    for mode in ("pc", "soc"):
        mcfg = cfg.replace(solver=dataclasses.replace(cfg.solver, mehrotra=mode))
        idx = torch.as_tensor(np.random.default_rng(2).permutation(POOL)[:BATCH], device="cuda")
        batch = gather(pool, idx)
        torch.cuda.synchronize()
        solve_lqr_cuda.launches = 0
        t0 = time.perf_counter()
        sol = solve_batch(mcfg, batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = solve_lqr_cuda.launches
        finite = bool(torch.isfinite(sol.controls).all() and torch.isfinite(sol.states).all())
        results[mode] = {
            "latency_ms": elapsed * 1e3,
            "solves_per_s": BATCH / elapsed,
            "converged_fraction": float(sol.diagnostics.converged.float().mean()),
            "usable_fraction": float((sol.diagnostics.kkt_feasibility <= 1e-2).float().mean()),
            "riccati_launches": launches,
            "iterations": its,
        }
        log(f"[5] split free mehrotra={mode}: " + json.dumps(results[mode]))
        if launches != 2 * its:
            fail(f"mehrotra={mode}: {launches} Riccati launches, expected {2 * its}")
        if not finite:
            fail(f"mehrotra={mode}: non-finite solution")
    return results


def phase_cpu_check(fused_cfgs, split_cfgs, pools):
    """64 scenarios of each configuration through the base solve on the
    card and on the CPU (no refinement, so both solve the same batch).

    Fused backend, float32: the kernel on the card against its plain version
    on the CPU.  Split backend, float64: the same code must agree to
    round-off on every scenario, with identical converged flags (controls to
    1e-6, the CPU parity budget of tests/test_torch_ipm.py); float32, the
    main path's type, as for fused.  In float32 converged flags agree on at
    least 62 of 64, and the controls of the scenarios both report converged
    agree within the f32 budget of tests/test_ipm_fused.py (1e-3 free, 2e-3
    with obstacles) for at least 95% of them.  f32 reports convergence at a
    stationarity of 50*sqrt(eps) ~ 1.7e-2, so two converged f32 solves can
    differ near 1e-3 in flat directions, and unconverged ones stop at
    iterates that drift apart under any change of summation order: the
    maximum is printed, not gated.
    """
    import torch

    from kissmpc_tpu_torch.solver.api import _dispatch
    from kissmpc_tpu_torch.solver.problem import Problem, gather, to_device

    def compare(cfg, sub):
        on_card = _dispatch(cfg, sub)
        on_cpu = _dispatch(cfg, to_device(sub, "cpu"))
        c_card = on_card.diagnostics.converged.cpu().numpy()
        c_cpu = on_cpu.diagnostics.converged.numpy()
        diff = np.abs(on_card.controls.cpu().numpy() - on_cpu.controls.numpy()).max(axis=(1, 2))
        return c_card, c_cpu, diff

    def check_f32(label, cfg, sub, tol):
        c_card, c_cpu, diff = compare(cfg, sub)
        both = c_card & c_cpu
        within = float(np.mean(diff[both] <= tol)) if both.any() else 0.0
        log(f"[6] {label} f32: flags agree {int((c_card == c_cpu).sum())}/64, converged "
            f"{int(both.sum())} on both, {within:.4f} of them within {tol} "
            f"(max {float(diff[both].max()) if both.any() else float('nan'):.3e}), "
            f"{float(diff.max()):.3e} over all")
        if (c_card != c_cpu).sum() > 2 or within < 0.95:
            fail(f"{label}: card and CPU paths disagree in float32")

    def check_f64(label, cfg, sub):
        c_card, c_cpu, diff = compare(cfg, Problem(*(x.double() for x in sub)))
        log(f"[6] {label} f64: flags agree {int((c_card == c_cpu).sum())}/64, "
            f"converged {int(c_card.sum())}, max control diff {float(diff.max()):.3e} "
            f"(tol 1e-6)")
        if (c_card != c_cpu).any() or not float(diff.max()) <= 1e-6:
            fail(f"{label}: card and CPU paths disagree in float64")

    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3), ("k8_dyn2_elastic", 2e-3)):
        sub = gather(pools[name], torch.arange(64, device="cuda"))
        check_f32(f"fused {name}", fused_cfgs[name], sub, tol)
        cfg = split_cfgs[name]
        check_f64(f"split {name}", cfg, sub)
        if name == "free":
            for mode in ("pc", "soc"):
                check_f64(f"split {name} mehrotra={mode}", cfg.replace(
                    solver=dataclasses.replace(cfg.solver, mehrotra=mode)), sub)
        if name != "k8_dyn2_elastic":
            check_f32(f"split {name}", cfg, sub, tol)


def fleet_config():
    """The closed loop of scripts/bench_fleet_episodes.py:81-112."""
    from kissmpc_tpu_torch import MPCConfig
    from kissmpc_tpu_torch.agent import AgentParams

    cfg = MPCConfig(horizon=N, time_step=0.041, max_obstacles=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, refine_stages=FLEET_STAGES, mu_sigma_max=0.7,
        fused_affine_tracks=True))
    params = AgentParams(complete_warm_starts=False, prediction_dt=cfg.time_step,
                         stall_skip_ticks=50)
    return cfg, params


def fleet_worlds(cfg, batch, seed, device, router="grid"):
    """(env, obstacles, info) of the bench's episode worlds
    (scripts/bench_fleet_episodes.py:114-120)."""
    from kissmpc_tpu_torch.scenarios import episode_worlds

    return episode_worlds(cfg, batch, n_waypoints=3, seed=seed, n_dynamic=2,
                          route_around_obstacles=True, router=router,
                          planner_grid=FLEET_PLANNER_GRID, points_per_leg=FLEET_POINTS_PER_LEG,
                          return_info=True, device=device)


def static_circles(obstacles):
    """(centers, radii, static mask) of a world's obstacles as numpy, for a
    replan (the static circles stay where they are)."""
    return (obstacles.position.cpu().numpy(), obstacles.radius.cpu().numpy(),
            (obstacles.linear_velocity == 0.0).cpu().numpy())


def replan(env, circles, inflation, device):
    """The bench's global replan (scripts/bench_fleet_episodes.py:200-215):
    one leg from each robot's current pose to its final waypoint, resampled
    into the chain's length, the agents' goals and waypoint indices reset.
    Returns (env, leg reachability [B, 1])."""
    import torch

    from kissmpc_tpu_torch.planner import plan_waypoint_chain

    W = env.waypoints.shape[1]
    new_wps, reach = plan_waypoint_chain(
        env.agent.states_matrix[:, 1, :].cpu().numpy(), env.waypoints[:, -1:, :].cpu().numpy(),
        *circles, inflation, points_per_leg=W - 1, grid=FLEET_PLANNER_GRID, device=device)
    wps = torch.as_tensor(new_wps, dtype=env.waypoints.dtype, device=env.waypoints.device)
    zero = torch.zeros_like(env.waypoint_index)
    return env._replace(agent=env.agent._replace(goal_state=wps[:, 0].contiguous()),
                        waypoints=wps, waypoint_index=zero, stall_ticks=zero), reach


def fleet_tick(cfg, params, env, obstacles, device):
    """One closed-loop tick: the fleet's solves, then the world moves."""
    from kissmpc_tpu_torch import environment
    from kissmpc_tpu_torch.obstacles import advance

    env, info = environment.fleet_step(cfg, params, env, obstacles, device=device)
    return env, advance(obstacles, cfg.time_step), info


def phase_fleet():
    """`fleet_step` + `obstacles.advance` for FLEET_TICKS ticks of
    FLEET_BATCH episodes on the card, then FLEET_CHECK episodes x ticks on
    the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch.obstacles import clearance_to_point
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

    cfg, params = fleet_config()
    t0 = time.perf_counter()
    env, obstacles, winfo = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reach = winfo["leg_reachable"]
    log(f"[7] {FLEET_BATCH} episode worlds (grid router, W={env.waypoints.shape[1]}) built on "
        f"the card in {build_s:.3f} s; reachable legs {float(reach.mean()):.5f}, episodes "
        f"with every leg reachable {float(reach.all(axis=1).mean()):.5f}")
    circles = static_circles(obstacles)
    expected = 1 + len(cfg.solver.refine_stages)
    solve_batch_fused.launches = 0
    solve_lqr_cuda.launches = 0
    lat, conv, usable, clear, stage_ms = [], [], [], [], []
    replan_s, replan_reach = None, None
    ever_final = torch.zeros(FLEET_BATCH, dtype=torch.bool, device="cuda")
    with stage_events() as events:
        for tick in range(FLEET_TICKS):
            if tick == FLEET_TICKS // 2:
                # The bench's replan pause, left out of the tick latencies.
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                env, replan_reach = replan(env, circles, params.inflation_radius, "cuda")
                torch.cuda.synchronize()
                replan_s = time.perf_counter() - t0
                log(f"[7] replan at tick {tick} from the current poses: {replan_s:.3f} s, "
                    f"reachable {float(replan_reach.mean()):.5f}")
            before, n_events = solve_batch_fused.launches, len(events)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env, obstacles, info = fleet_tick(cfg, params, env, obstacles, "cuda")
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            stage_ms.append([(b, s.elapsed_time(e)) for b, s, e in events[n_events:]])
            launched = solve_batch_fused.launches - before
            if launched != expected:
                fail(f"fleet tick {tick}: {launched} fused launches, expected {expected}")
            states = env.agent.states_matrix
            if not bool(torch.isfinite(states).all()):
                fail(f"fleet tick {tick}: non-finite executed plan")
            clr = clearance_to_point(obstacles, states[:, 1, :2], params.radius)
            conv.append(float(info.diagnostics.converged.float().mean()))
            usable.append(float((info.diagnostics.kkt_feasibility <= params.fallback_feasibility)
                                .float().mean()))
            clear.append(float(clr.min()))
            ever_final |= info.final_goal_reached
            if tick % 10 == 0 or tick == FLEET_TICKS - 1:
                log(f"[7] tick {tick}: {lat[-1]:.3f} ms, converged {conv[-1]:.5f}, usable "
                    f"{usable[-1]:.5f}, min clearance {clear[-1]:.4f} m, final goal reached "
                    f"{float(ever_final.float().mean()):.5f}")
    if solve_lqr_cuda.launches:
        fail("the fused fleet loop launched the Riccati kernel")
    fused_launches = solve_batch_fused.launches
    p50 = float(np.percentile(lat, 50))
    # Share of each tick's host-clock time spent inside the fused stages
    # (CUDA events around each launch): the card's busy share, to within
    # the problem construction's small kernels.
    share = [sum(ms for _, ms in st) / t for st, t in zip(stage_ms, lat)]
    log(f"[7] fused stages of the last tick (B, ms): {stage_ms[-1]}; their share of a "
        f"tick: mean {float(np.mean(share)):.5f}, min {min(share):.5f}")
    result = {
        "batch": FLEET_BATCH,
        "ticks": FLEET_TICKS,
        "tick_p50_ms": p50,
        "tick_max_ms": max(lat),
        "first_tick_ms": lat[0],
        "solves_per_s": FLEET_BATCH / (p50 / 1e3),
        "converged_fraction_mean": float(np.mean(conv)),
        "usable_fraction_mean": float(np.mean(usable)),
        "final_goal_reached_fraction": float(ever_final.float().mean()),
        "min_clearance_m": min(clear),
        "fused_launches_per_tick": expected,
        "fused_launches": fused_launches,
        "fused_stage_share_mean": float(np.mean(share)),
        "last_tick_stage_ms": stage_ms[-1],
        "router": "grid",
        "world_build_s": build_s,
        "leg_reachable_fraction": float(reach.mean()),
        "episode_reachable_fraction": float(reach.all(axis=1).mean()),
        "replan_s": replan_s,
        "replan_reachable_fraction": float(replan_reach.mean()),
    }

    # The "detour" router's tick time beside it: a short loop on its worlds
    # (6 route points per episode instead of 12).
    env_d, obs_d, _ = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda", router="detour")
    detour = []
    for _ in range(DETOUR_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env_d, obs_d, _ = fleet_tick(cfg, params, env_d, obs_d, "cuda")
        torch.cuda.synchronize()
        detour.append((time.perf_counter() - t0) * 1e3)
    result["detour_tick_p50_ms"] = float(np.percentile(detour, 50))
    result["detour_ticks"] = DETOUR_TICKS
    log("[7] fleet: " + json.dumps(result))

    # The same closed loop on the card and on the CPU port (the fused plain
    # version, f32).  Float32 solves on both sides agree within 2e-3 in the
    # controls (phase 6), so one tick moves an executed state by at most
    # ~dt * 2e-3 ~ 1e-4, and five ticks, each starting from the last, by
    # ~5e-4: the states are held to 1e-3 on 95% of episode-ticks; a solve
    # converged on one side only, or gated to the fallback on one side
    # only, may differ more, which the 5% allows.
    n_ep, n_ticks = FLEET_CHECK
    worlds = {dev: fleet_worlds(cfg, n_ep, 1, dev)[:2] for dev in ("cuda", "cpu")}
    idx_match, close, worst = [], [], 0.0
    for tick in range(n_ticks):
        out = {}
        for dev, (env_d, obs_d) in worlds.items():
            env_d, obs_d, info_d = fleet_tick(cfg, params, env_d, obs_d, dev)
            worlds[dev] = (env_d, obs_d)
            out[dev] = (info_d.waypoint_index.cpu(), env_d.agent.states_matrix[:, 1].cpu())
        idx_match.append(out["cuda"][0] == out["cpu"][0])
        diff = (out["cuda"][1] - out["cpu"][1]).abs().amax(dim=1)
        close.append(diff <= 1e-3)
        worst = max(worst, float(diff.max()))
    idx_frac = float(torch.cat(idx_match).float().mean())
    close_frac = float(torch.cat(close).float().mean())
    log(f"[7] fleet card vs CPU, {n_ep} episodes x {n_ticks} ticks: waypoint indices match "
        f"on {idx_frac:.5f}, executed states within 1e-3 on {close_frac:.5f} "
        f"(max {worst:.3e}) of episode-ticks")
    if idx_frac < 0.95 or close_frac < 0.95:
        fail("the closed loop on the card disagrees with the CPU port")
    result.update(cpu_check_index_match=idx_frac, cpu_check_state_close=close_frac,
                  cpu_check_state_max=worst)
    return result



def planner_inputs(cfg, batch, seed):
    """Start poses, waypoint chains and obstacle fields of ``batch`` fleet
    episodes before routing, drawn as `scenarios.episode_worlds` draws them
    (3 waypoints, 2 dynamic circles): (starts, waypoints, centers, radii,
    static mask)."""
    from kissmpc_tpu_torch.scenarios import (sample_endpoints, sample_obstacle_field,
                                             waypoint_hops)

    rng = np.random.default_rng(seed)
    starts, first = sample_endpoints(cfg, batch, rng)
    wps = waypoint_hops(cfg, first, 3, rng)
    centers, radii, _, v = sample_obstacle_field(
        starts, first, cfg.max_obstacles, rng, n_dynamic=2,
        clear_points=list(wps[:, 1:].swapaxes(0, 1)))
    return starts, wps, centers, radii, v == 0.0


def compare_routes(label, card, cpu, tol=PLANNER_POINT_TOL):
    """Leg reachability equal, and the episodes whose route points (and
    headings, away from the +-pi cut) differ by more than ``tol``: fails
    unless at least PLANNER_AGREE of PLANNER_CHECK agree.  Returns the
    largest difference."""
    (out_g, reach_g), (out_c, reach_c) = card, cpu
    if not np.array_equal(reach_g, reach_c):
        fail(f"{label}: leg reachability differs on the card and on the CPU in "
             f"{int((reach_g != reach_c).any(axis=1).sum())} episodes")
    dxy = np.abs(out_g[..., :2] - out_c[..., :2]).max(axis=(1, 2))
    dth = np.abs(np.angle(np.exp(1j * (out_g[..., 2].astype(np.float64) - out_c[..., 2])))).max(1)
    diff = np.maximum(dxy, dth)
    bad = np.flatnonzero(diff > tol)
    log(f"{label}: reachability equal; route points within {tol} on "
        f"{len(diff) - len(bad)} of {len(diff)} episodes (max {float(diff.max()):.3e}); "
        f"differing episodes: {bad.tolist()}")
    if len(diff) - len(bad) < PLANNER_AGREE:
        fail(f"{label}: routes on the card and on the CPU disagree")
    return float(diff.max())


def phase_planner():
    """The planner at the fleet's size on the card, timed, then
    PLANNER_CHECK episodes on the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch.planner import bottleneck_clearance, plan_waypoint_chain

    cfg, params = fleet_config()
    infl = params.inflation_radius
    kw = dict(points_per_leg=FLEET_POINTS_PER_LEG, grid=FLEET_PLANNER_GRID)
    starts, wps, centers, radii, static = planner_inputs(cfg, FLEET_BATCH, 2)
    plan_s, clear_s = [], []
    for _ in range(2):  # the first call includes the card's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, reach = plan_waypoint_chain(starts, wps, centers, radii, static, infl, **kw)
        plan_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        w = bottleneck_clearance(starts, wps[:, -1], centers, radii, static, infl,
                                 grid=FLEET_PLANNER_GRID)
        clear_s.append(time.perf_counter() - t0)
    if not (np.isfinite(out).all() and out.shape == (FLEET_BATCH, 12, 3)):
        fail(f"the planner's chain is {out.shape} or not finite")
    log(f"[8] plan_waypoint_chain B={FLEET_BATCH} W=3 G={FLEET_PLANNER_GRID} on the card: "
        f"{plan_s[-1]:.4f} s (first call {plan_s[0]:.4f} s), reachable legs "
        f"{float(reach.mean()):.5f}; bottleneck_clearance: {clear_s[-1]:.4f} s (first "
        f"{clear_s[0]:.4f} s), median margin {float(np.median(w)):.4f} m")

    n = PLANNER_CHECK
    sub = tuple(x[:n] for x in (starts, wps, centers, radii, static))
    t0 = time.perf_counter()
    cpu = plan_waypoint_chain(*sub, infl, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    card = plan_waypoint_chain(*sub, infl, device="cuda", **kw)
    route_max = compare_routes(f"[8] plan_waypoint_chain card vs CPU, {n} episodes", card, cpu)
    w_cpu = bottleneck_clearance(sub[0], sub[1][:, -1], *sub[2:], infl, grid=FLEET_PLANNER_GRID,
                                 device="cpu")
    w_card = bottleneck_clearance(sub[0], sub[1][:, -1], *sub[2:], infl,
                                  grid=FLEET_PLANNER_GRID, device="cuda")
    dw = np.abs(w_card - w_cpu)
    bad = np.flatnonzero(~(dw <= PLANNER_CLEAR_TOL))
    log(f"[8] bottleneck_clearance card vs CPU: within {PLANNER_CLEAR_TOL} m on "
        f"{n - len(bad)} of {n} (max {float(dw.max()):.3e}); differing episodes: "
        f"{bad.tolist()}; the CPU port planned {n} episodes in {cpu_s:.3f} s")
    if n - len(bad) < PLANNER_AGREE:
        fail("bottleneck clearances on the card and on the CPU disagree")
    return {"batch": FLEET_BATCH, "grid": FLEET_PLANNER_GRID, "plan_s": plan_s[-1],
            "plan_first_s": plan_s[0], "clearance_s": clear_s[-1],
            "reachable_fraction": float(reach.mean()), "route_max_diff": route_max,
            "clearance_max_diff": float(dw.max())}


def write_synthetic_map(path, shape=LAB_MAP_PX, seed=0):
    """A P5 occupancy map of ``shape`` pixels (rows, columns) from ``seed``:
    a light floor with dark outer walls, interior walls across the rows
    with two doorways each, and dark boxes and disks, their count and
    sizes following the map's area."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.full((h, w), 254, np.uint8)
    img[:8], img[-8:], img[:, :8], img[:, -8:] = 0, 0, 0, 0
    door = max(h // 20, 12)
    for x in rng.integers(w // 10, w - w // 10, w // 300):
        img[:, x:x + 6] = 0
        for y in rng.integers(16, h - door - 16, 2):
            img[y:y + door, x:x + 6] = 254
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(max(h * w // 20000, 6)):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        if rng.random() < 0.5:
            r = int(rng.integers(4, 16))
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0
        else:
            bh, bw = rng.integers(5, 25, 2)
            img[cy - bh:cy + bh, cx - bw:cx + bw] = 0
    with open(path, "wb") as f:
        f.write(f"P5\n# synthetic lab map, seed {seed}\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def phase_lab(tmpdir):
    """`lab_worlds` on a synthetic map: LAB_BATCH worlds on the card, timed,
    then PLANNER_CHECK episodes on the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch.scenarios import lab_worlds

    cfg, params = fleet_config()
    path = f"{tmpdir}/synthetic_lab.pgm"
    write_synthetic_map(path)
    t0 = time.perf_counter()
    env, obs, info = lab_worlds(cfg, LAB_BATCH, map_path=path, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    start = env.agent.states_matrix[:, 0, :2]
    margin = float(((start[:, None, :] - obs.position).norm(dim=-1) - obs.radius).min())
    if obs.position.shape != (LAB_BATCH, 24, 2) or not bool(torch.isfinite(env.waypoints).all()):
        fail(f"lab_worlds: obstacles {tuple(obs.position.shape)} or non-finite waypoints")
    if margin <= params.inflation_radius:
        fail(f"lab_worlds: a start lies {margin:.3f} m from a circle")
    reach = info["leg_reachable"]
    log(f"[9] lab_worlds B={LAB_BATCH} on a {LAB_MAP_PX[0]} x {LAB_MAP_PX[1]} px map "
        f"({info['n_circles']} circles, extent {info['extent'].tolist()} m) built on the card "
        f"in {build_s:.3f} s; reachable legs {float(reach.mean()):.5f}; closest start "
        f"{margin:.3f} m from a circle")
    worlds = {dev: lab_worlds(cfg, PLANNER_CHECK, map_path=path, seed=1, device=dev)
              for dev in ("cuda", "cpu")}
    (env_g, obs_g, info_g), (env_c, obs_c, info_c) = worlds["cuda"], worlds["cpu"]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(obs_g, obs_c)):
        fail("lab_worlds: the card's and the CPU's obstacles differ")
    route_max = compare_routes(
        f"[9] lab_worlds card vs CPU, {PLANNER_CHECK} episodes",
        (env_g.waypoints.cpu().numpy(), info_g["leg_reachable"]),
        (env_c.waypoints.numpy(), info_c["leg_reachable"]))
    return {"batch": LAB_BATCH, "map_px": list(LAB_MAP_PX), "n_circles": info["n_circles"],
            "build_s": build_s, "reachable_fraction": float(reach.mean()),
            "route_max_diff": route_max}


def random_lqr(B, n, seed, dtype):
    """Well-posed LQR data on the card from a numpy seed (near-identity
    dynamics, SPD costs), as the card tests and the CPU shim make it."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData

    rng = np.random.default_rng(seed)

    def spd(m, count):
        x = rng.normal(size=(B, count, m, m))
        return x @ np.swapaxes(x, -1, -2) * 0.3 + np.eye(m) * 0.5

    arrays = dict(A=rng.normal(size=(B, n, 3, 3)) * 0.1 + np.eye(3),
                  B=rng.normal(size=(B, n, 3, 2)) * 0.5, d=rng.normal(size=(B, n, 3)) * 0.1,
                  d0=rng.normal(size=(B, 3)) * 0.1, Qxx=spd(3, n + 1),
                  qx=rng.normal(size=(B, n + 1, 3)), Quu=spd(2, n), qu=rng.normal(size=(B, n, 2)))
    return LQRData(**{k: torch.tensor(v, dtype=dtype, device="cuda") for k, v in arrays.items()})


def phase_horizons(fused_cfgs):
    """Phase 10: the kernels at their horizon limits (see the module
    docstring).  Returns the Riccati and fused rows for the kernels line."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_fused, riccati
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem

    reg = 1e-8
    ric = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        on_chip = riccati.max_horizon(dtype)
        for n in (on_chip + 1, RICCATI_LONG_N):
            for B in RICCATI_LONG_BATCHES:
                data = random_lqr(B, n, seed=n + B, dtype=dtype)
                occ = riccati.occupancy(B, n, dtype)
                gate = check_riccati(data, reg, phase=10)
                log(f"[10] Riccati {name} N={n} B={B} (longest on-chip horizon {on_chip}): "
                    f"gate passes, max|kernel-plain| {gate['err']:.3e}; "
                    f"{occ['smem_bytes_per_block']} bytes of shared memory per block, "
                    f"{occ['blocks_per_sm']} blocks per SM")
        B = RICCATI_LONG_BATCHES[-1]
        data = random_lqr(B, RICCATI_LONG_N, seed=1, dtype=dtype)
        ms = kernel_ms(lambda: solve_lqr_cuda(data, reg), reps=5, graph=True)
        bound_ms, bound_by, n_bytes, flops = riccati_bound(B, dtype, RICCATI_LONG_N)
        ric[name] = {"max_horizon": on_chip, "global_gains_ms": ms, "global_gains_B": B,
                     "global_gains_N": RICCATI_LONG_N, "global_gains_bound_ms": bound_ms,
                     "global_gains_bound_by": bound_by}
        log(f"[10] Riccati global-gains instance {name} N={RICCATI_LONG_N} B={B}: {ms:.4f} ms, "
            f"{ms / bound_ms:.2f}x its bound {bound_ms:.5f} ms ({n_bytes} bytes, {flops} flop: "
            f"{bound_by})")

    fused = {}
    for label, base in (("free", fused_cfgs["free"]), ("k8_dyn2", fused_cfgs["k8_dyn2"])):
        n = ipm_fused.max_horizon(base)
        cfg = base.replace(horizon=n)
        K = cfg.max_obstacles
        pr = (obstacle_problems(cfg, EDGE_BATCH, seed=3, n_dynamic=2) if K
              else free_problems(cfg, EDGE_BATCH, seed=3))
        occ = ipm_fused.occupancy(cfg)
        got = solve_batch_fused(cfg, pr, iterations=EDGE_ITERATIONS)
        ref = solve_batch_fused_plain(cfg, pr, iterations=EDGE_ITERATIONS)
        ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)),
                                        iterations=EDGE_ITERATIONS)
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.states.abs().max()), float(ref.controls.abs().max()))
        err, tol = solution_gap(got, ref), 1e-4 * scale + 2.0 * solution_gap(ref, ref64)
        finite = bool(torch.isfinite(got.states).all() and torch.isfinite(got.controls).all())
        log(f"[10] fused {label} at its longest horizon N={n} (K={K}), B={EDGE_BATCH}, "
            f"{EDGE_ITERATIONS} iterations, {occ['warps_per_block']} warp(s) and "
            f"{occ['smem_bytes_per_block']} bytes per block: max|kernel-plain| {err:.3e} "
            f"(tol {tol:.3e})")
        if not (finite and err <= tol and occ["warps_per_block"] == 1):
            fail(f"the fused kernel at its longest horizon ({label}, N={n})")
        ms = kernel_ms(lambda: solve_batch_fused(cfg, pr, iterations=EDGE_ITERATIONS), reps=3,
                       warmup=1)
        bound_ms, bound_by, _, _ = fused_bound(cfg, EDGE_BATCH, EDGE_ITERATIONS, n)
        over = cfg.replace(horizon=n + 1)
        pr_over = (obstacle_problems(over, 2, seed=3, n_dynamic=2) if K
                   else free_problems(over, 2, seed=3))
        before = solve_batch_fused.launches
        try:
            solve_batch_fused(over, pr_over, iterations=1)
        except ValueError as exc:
            refused = str(exc)
        else:
            fail(f"the fused kernel took N={n + 1} ({label})")
        if solve_batch_fused.launches != before:
            fail("the refused horizon launched the fused kernel")
        log(f"[10] fused {label}: {ms:.4f} ms at N={n}, B={EDGE_BATCH}, {EDGE_ITERATIONS} "
            f"iterations ({ms / bound_ms:.2f}x its bound {bound_ms:.4f} ms, {bound_by}); "
            f"N={n + 1} refused before any launch: {refused}")
        fused[label] = {"max_horizon": n, "ms": ms, "B": EDGE_BATCH,
                        "iterations": EDGE_ITERATIONS, "bound_ms": bound_ms,
                        "max_abs_err": err}
    return ric, fused


def perception_config():
    """The fleet configuration of scripts/bench_perception_tick.py:58-66."""
    from kissmpc_tpu_torch import MPCConfig
    from kissmpc_tpu_torch.agent import AgentParams

    cfg = MPCConfig(horizon=N, time_step=0.041, max_obstacles=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, refine_stages=PERCEPTION_STAGES, mu_sigma_max=0.7))
    params = AgentParams(prediction_dt=cfg.time_step, complete_warm_starts=False,
                         stall_skip_ticks=50)
    return cfg, params


def walk_frames(path, n_frames):
    """(frames, truth): the port's synthetic walk recorded to ``path`` and
    replayed time-synced (scripts/bench_perception_tick.py:43-56)."""
    from kissmpc_tpu_torch.io.frames import FrameReplayer, record_synthetic_walk

    truth = record_synthetic_walk(path, n_frames=n_frames, dt=FRAMES_DT)
    return list(FrameReplayer(path).synced()), truth


def stacked_frames(frames, device):
    """(geometry, points [F, P, 3], point masks, instance masks, instance
    valid) on ``device``, the frames stacked once as the bench stacks them."""
    import torch

    from kissmpc_tpu_torch.bridge import geometry_from_numpy

    stack = lambda name: torch.as_tensor(  # noqa: E731
        np.stack([getattr(f, name) for f in frames]), device=device)
    return (geometry_from_numpy(frames[0].geometry, device=device), stack("points"),
            stack("point_mask"), stack("instance_masks"), stack("instance_valid"))


@contextlib.contextmanager
def perception_trace():
    """Record what `pipeline.step` computes inside the block: for each call,
    DBSCAN's points, selection and labels, and the centres and found flags
    handed to the tracker.  Yields the list of dicts it appends to."""
    from kissmpc_tpu_torch.perception import clustering, tracker

    real_dbscan, real_update = clustering.dbscan, tracker.update
    calls = []

    def dbscan(points, mask, *args, **kwargs):
        out = real_dbscan(points, mask, *args, **kwargs)
        calls.append({"points": points, "mask": mask, "labels": out.labels})
        return out

    def update(cfg, tracks, detections, det_mask, dt):
        calls[-1].update(centres=detections, found=det_mask)
        return real_update(cfg, tracks, detections, det_mask, dt)

    clustering.dbscan, tracker.update = dbscan, update
    try:
        yield calls
    finally:
        clustering.dbscan, tracker.update = real_dbscan, real_update


def run_pipelines(frames, batch, n_frames, device):
    """``batch`` pipelines fed the first ``n_frames`` frames on ``device``:
    per frame (labels, centres, found, track ids, track positions) as CPU
    tensors."""
    from kissmpc_tpu_torch.perception import pipeline, tracker

    geom, pts, pm, im, iv = stacked_frames(frames[:n_frames], device)
    state = pipeline.init_perception(TRACK_CAPACITY, batch=batch, device=device)
    out = []
    with perception_trace() as calls:
        for f in range(n_frames):
            state, _ = pipeline.step(tracker.TrackerConfig(), state, geom, pts[f], pm[f], im[f],
                                     iv[f], FRAMES_DT, device=device)
            c = calls[-1]
            out.append([x.cpu() for x in (c["labels"], c["centres"], c["found"],
                                          state.tracks.track_id, state.tracks.position)])
    return out


def compare_pipelines(card, cpu, tol=PERCEPTION_TOL):
    """(agreeing pipelines, differing pipeline indices, largest centre or
    track-position gap): a pipeline agrees when on every frame its found
    flags, labels and track ids are equal and its centres and track
    positions within ``tol``."""
    import torch

    ok, worst = None, 0.0
    for g, c in zip(card, cpu):
        same = torch.ones(g[0].shape[0], dtype=torch.bool)
        for i in (0, 2, 3):  # labels, found, track ids
            same &= (g[i] == c[i]).reshape(len(same), -1).all(1)
        for i in (1, 4):  # centres, track positions
            gap = (g[i] - c[i]).abs().reshape(len(same), -1).amax(1)
            worst = max(worst, float(gap.max()))
            same &= gap <= tol
        ok = same if ok is None else ok & same
    return int(ok.sum()), torch.nonzero(~ok).flatten().tolist(), worst


def phase_perception(tmpdir):
    """The perception-in-the-loop fleet tick (scripts/bench_perception_tick.py
    at its default size) on the card, the two variants interleaved; the
    perception step's CUDA-event time and DBSCAN's share of it; then
    PERCEPTION_CHECK pipelines x frames on the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch import environment
    from kissmpc_tpu_torch.obstacles import ObstacleSet
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.perception import clustering, pipeline, tracker
    from kissmpc_tpu_torch.scenarios import episode_worlds

    B, ticks = PERCEPTION_BATCH, PERCEPTION_TICKS
    frames, truth = walk_frames(f"{tmpdir}/walk.npz", ticks + 1)
    F = len(frames)
    geom, pts, pm, im, iv = stacked_frames(frames, "cuda")
    cfg, params = perception_config()
    t0 = time.perf_counter()
    env, static = episode_worlds(cfg, B, n_waypoints=2, seed=0, n_dynamic=0,
                                 route_around_obstacles=True, router="grid", device="cuda")
    torch.cuda.synchronize()
    log(f"[11] {F} synced frames; {B} episode worlds (grid router) built in "
        f"{time.perf_counter() - t0:.3f} s")
    offsets = env.agent.states_matrix[:, 0, :2] + torch.tensor(PERCEPTION_OFFSET,
                                                               device="cuda")
    tcfg = tracker.TrackerConfig()
    expected = 1 + len(cfg.solver.refine_stages)

    def perceive(pstate, f):
        return pipeline.step(tcfg, pstate, geom, pts[f], pm[f], im[f], iv[f], FRAMES_DT,
                             device="cuda")

    def tick_perception(env, pstate, f):
        pstate, tracked = perceive(pstate, f)
        tracked = tracked._replace(position=tracked.position + offsets[:, None, :])
        obstacles = ObstacleSet(*(torch.cat([a, b], dim=1) for a, b in zip(static, tracked)))
        env, info = environment.fleet_step(cfg, params, env, obstacles, device="cuda")
        return env, pstate, info, tracked

    def tick_solver_only(env, pstate, f):
        env, info = environment.fleet_step(cfg, params, env, static, device="cuda")
        return env, pstate, info, None

    pstate0 = pipeline.init_perception(TRACK_CAPACITY, batch=B, device="cuda")
    variants = {"solver_only": tick_solver_only, "with_perception": tick_perception}
    solve_batch_fused.launches = 0
    st = {}
    for name, fn in variants.items():  # the bench's first call, at frame 0
        e, p, info, tracked = fn(env, pstate0, 0)
        torch.cuda.synchronize()
        st[name] = {"fn": fn, "e": e, "p": p, "lat": [], "launches": [], "info": info,
                    "tracked": tracked, "f": 0}
    rounds = max(1, (ticks - 1) // PERCEPTION_CHUNK)
    for r in range(rounds):
        for name, s in st.items():
            for j in range(PERCEPTION_CHUNK):
                f = (r * PERCEPTION_CHUNK + j) % F
                before = solve_batch_fused.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s["e"], s["p"], s["info"], s["tracked"] = s["fn"](s["e"], s["p"], f)
                conv = float(s["info"].diagnostics.converged.float().mean())
                s["lat"].append((time.perf_counter() - t0) * 1e3)
                s["launches"].append(solve_batch_fused.launches - before)
                s["conv"], s["f"] = conv, f
    if solve_batch_fused.launches == 0:
        fail("the perception tick never launched the fused kernel")
    results = {}
    for name, s in st.items():
        lat = np.asarray(s["lat"])
        if set(s["launches"]) != {expected}:
            fail(f"{name}: fused launches per tick {sorted(set(s['launches']))}, "
                 f"expected {expected}")
        tracked_total = (float(s["tracked"].active.sum()) if s["tracked"] is not None else 0.0)
        results[name] = {"tick_p50_ms": float(np.percentile(lat, 50)),
                         "tick_p99_ms": float(np.percentile(lat, 99)),
                         "ticks": len(lat), "converged": s["conv"],
                         "tracked_total": tracked_total,
                         "fused_launches_per_tick": expected}
        log(f"[11] {name}: " + json.dumps(results[name]))
    results["perception_added_ms"] = (results["with_perception"]["tick_p50_ms"]
                                      - results["solver_only"]["tick_p50_ms"])

    # Gates: every episode tracks the walker near the ground truth, and the
    # episodes keep converging (tests/test_perception.py:449-455).
    s = st["with_perception"]
    tracked = s["tracked"]
    active = tracked.active > 0
    n_active = int(active.sum())
    err = float((tracked.position - offsets[:, None, :] - torch.as_tensor(
        truth[s["f"]], device="cuda"))[active].abs().max())
    log(f"[11] last tick (frame {s['f']}): {n_active} confirmed tracks for {B} episodes, "
        f"largest error to the walk's ground truth {err:.4f} m")
    if n_active != B or err > TRACK_TRUTH_TOL:
        fail(f"perception tick: {n_active} tracks for {B} episodes, error {err:.4f} m")
    for name in variants:
        if results[name]["converged"] < 0.90:
            fail(f"perception tick {name}: converged {results[name]['converged']:.5f} < 0.90")

    # The perception step alone, one call per event pair, and DBSCAN on the
    # selection it clusters; launches of one step by the profiler's trace.
    p = st["with_perception"]["p"]
    step_ms = cuda_ms(lambda: perceive(p, 5), reps=20)
    with perception_trace() as calls:
        perceive(p, 5)
    c = calls[-1]
    dbscan_ms = cuda_ms(lambda: clustering.dbscan(c["points"], c["mask"], pipeline.DBSCAN_EPS,
                                                  pipeline.DBSCAN_MIN_SAMPLES), reps=20)
    results.update(perception_step_ms=step_ms, dbscan_ms=dbscan_ms,
                   dbscan_share=dbscan_ms / step_ms)
    log(f"[11] perception step alone (B={B}, one call per event pair): {step_ms:.4f} ms; "
        f"DBSCAN on its selection {dbscan_ms:.4f} ms, {dbscan_ms / step_ms:.5f} of it")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        perceive(p, 5)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 if kernels else None
    results.update(perception_launches_per_step=len(kernels) if kernels else None,
                   perception_step_device_busy_ms=busy_ms)
    log(f"[11] one perception step by the profiler: {len(kernels)} kernels on the card, "
        f"busy {busy_ms} ms" if kernels else
        "[11] the profiler recorded no kernel of the perception step: not measured")

    # Card against the CPU port on the same frames.
    n_pipe, n_frames = PERCEPTION_CHECK
    card = run_pipelines(frames, n_pipe, n_frames, "cuda")
    cpu = run_pipelines(frames, n_pipe, n_frames, "cpu")
    agree, differ, worst = compare_pipelines(card, cpu)
    log(f"[11] perception card vs CPU, {n_pipe} pipelines x {n_frames} frames: {agree} agree "
        f"(found, labels, track ids equal; centres and tracks within {PERCEPTION_TOL} m; "
        f"largest gap {worst:.3e} m); differing: {differ}")
    if agree < PERCEPTION_AGREE:
        fail(f"perception on the card disagrees with the CPU port in {differ}")
    results.update(batch=B, frames=F, cpu_check_agree=agree, cpu_check_max_gap=worst)
    log("[11] perception tick: " + json.dumps(results))
    return results


@contextlib.contextmanager
def riccati_events():
    """Time every Riccati launch the split IPM makes inside the block with
    CUDA events (the wrapper's packing included); yields the list of
    (start, end) it appends to."""
    import torch

    from kissmpc_tpu_torch.solver import ipm

    real = ipm.solve_lqr_cuda
    events = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    ipm.solve_lqr_cuda = timed
    try:
        yield events
    finally:
        ipm.solve_lqr_cuda = real


def node_obstacles(walk_path, device):
    """The walk's tracked humans after each frame (`io.frames.replay_session`
    on ``device``), moved ahead of the robot by PERCEPTION_OFFSET."""
    import torch

    from kissmpc_tpu_torch.io.frames import FrameReplayer, replay_session
    from kissmpc_tpu_torch.perception.tracker import TrackerConfig

    _, per_frame = replay_session(FrameReplayer(walk_path), TrackerConfig(),
                                  capacity=TRACK_CAPACITY, device=device)
    offset = torch.tensor(PERCEPTION_OFFSET, device=device)
    return [o._replace(position=o.position + offset) for o in per_frame]


def node_loop(device, ticks, obstacles, odoms=None):
    """The node's control loop (`io.pubsub.ControlLoop` over `io.Model` at
    its defaults with 4 obstacle slots), ``ticks`` ticks back to back on
    ``device``: the plan NODE_PLAN once; a fresh odometry pose every tick
    (where the last command takes the robot in one 10 ms period, or
    ``odoms``); the walk's humans every 10 ticks (perception at 10 Hz).
    Returns (commands [ticks, 2], odometry poses, tick ms, the loop and its
    odometry slot)."""
    import torch

    from kissmpc_tpu_torch.io import ControlLoop, LatestValue, Model

    model = Model(max_obstacles=4, device=device)
    odom, plan, obs = LatestValue(), LatestValue(), LatestValue()
    commands = []
    loop = ControlLoop(model, odometry=odom, plan=plan, obstacles=obs,
                       on_command=lambda v, w: commands.append((v, w)))
    plan.publish(np.array(NODE_PLAN))
    pose, poses, lat = np.zeros(3), [], []
    period = NODE_PERIOD_MS / 1e3
    for tick in range(ticks):
        if tick % 10 == 0:
            obs.publish(obstacles[NODE_FIRST_FRAME + tick // 10])
        if odoms is not None:
            pose = odoms[tick]
        odom.publish(pose)
        poses.append(pose)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not loop.tick():
            fail(f"node tick {tick} produced no command")
        lat.append((time.perf_counter() - t0) * 1e3)
        v, w = commands[-1]
        pose = pose + period * np.array([v * np.cos(pose[2]), v * np.sin(pose[2]), w])
    return np.array(commands), poses, lat, (loop, odom)


def phase_node(tmpdir):
    """The single-robot node tick on the card: NODE_TICKS ticks with their
    Riccati launches counted and timed; its commands against the CPU port;
    the kernel against its plain version on one tick's LQR data."""
    import torch

    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

    walk = f"{tmpdir}/walk.npz"
    obstacles = node_obstacles(walk, "cuda")
    solve_lqr_cuda.launches = 0
    with riccati_events() as events:
        commands, poses, lat, (loop, odom) = node_loop("cuda", NODE_TICKS, obstacles)
    torch.cuda.synchronize()
    model = loop.model
    iters = model.cfg.solver.iterations
    launches = solve_lqr_cuda.launches
    if launches != iters * NODE_TICKS:
        fail(f"node: {launches} Riccati launches in {NODE_TICKS} ticks, expected "
             f"{iters} per tick")
    ric_ms = [sum(s.elapsed_time(e) for s, e in events[t * iters:(t + 1) * iters])
              for t in range(NODE_TICKS)]
    share = [r / t for r, t in zip(ric_ms, lat)]
    if not np.isfinite(commands).all():
        fail("node: non-finite command")
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    result = {"ticks": NODE_TICKS, "horizon": model.cfg.horizon,
              "iterations": iters, "tick_p50_ms": p50, "tick_p99_ms": p99,
              "first_tick_ms": lat[0], "period_ms": NODE_PERIOD_MS,
              "p50_over_period": p50 / NODE_PERIOD_MS,
              "riccati_launches_per_tick": launches // NODE_TICKS,
              "riccati_ms_per_tick_p50": float(np.percentile(ric_ms, 50)),
              "riccati_share_mean": float(np.mean(share)),
              "converged_last": bool(model.last_diagnostics.converged),
              "last_command": commands[-1].tolist()}
    log(f"[12] node tick (N={model.cfg.horizon}, {iters} iterations, B=1): p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms against the {NODE_PERIOD_MS} ms period of the 100 Hz timer "
        f"({p50 / NODE_PERIOD_MS:.2f}x); {launches // NODE_TICKS} Riccati launches per tick, "
        f"their CUDA-event time {result['riccati_ms_per_tick_p50']:.4f} ms per tick, "
        f"{result['riccati_share_mean']:.5f} of a tick")

    # One more tick under the profiler: kernels, the card's busy share and
    # the host's synchronising calls.
    from torch.profiler import ProfilerActivity, profile

    odom.publish(poses[-1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    runtime = {name: sum(1 for e in events if e.name == name)
               for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    result.update(profiled_tick_ms=wall_ms, profiled_kernels=len(kernels),
                  profiled_busy_ms=busy_ms, profiled_runtime_calls=runtime)
    log(f"[12] one node tick under the profiler: {wall_ms:.3f} ms, {len(kernels)} kernels, "
        f"card busy {busy_ms:.4f} ms (idle {1 - busy_ms / wall_ms:.5f}); runtime calls "
        f"{runtime}")

    # The same inputs on the CPU port: odometry and humans as the card saw them.
    cpu_cmds, _, cpu_lat, _ = node_loop("cpu", NODE_CHECK_TICKS, node_obstacles(walk, "cpu"),
                                        odoms=poses)
    gap = float(np.abs(cpu_cmds - commands[:NODE_CHECK_TICKS]).max())
    result.update(cpu_tick_p50_ms=float(np.percentile(cpu_lat, 50)))
    log(f"[12] node card vs CPU, first {NODE_CHECK_TICKS} ticks: largest command gap "
        f"{gap:.3e} (limit {NODE_CMD_TOL}); the CPU port's tick p50 on this host "
        f"{result['cpu_tick_p50_ms']:.3f} ms")
    if not gap <= NODE_CMD_TOL:
        fail(f"node commands on the card differ from the CPU port's by {gap:.3e}")
    data = lqr_from_iterate(model.cfg, model.last_problem)
    gate = check_riccati(data, model.cfg.solver.reg, phase=12)
    result.update(cpu_check_max_gap=gap, riccati_gate_err=gate["err"])
    log("[12] node: " + json.dumps(result))
    return result


def phase_data_parallel(cfg, pool):
    """Phase 13: `parallel.fleet` over a one-rank NCCL group (an in-process
    store, no port): the fleet solver on the K=8 cell at B=8192 bitwise
    against `solve_batch`, the stepper for DP_TICKS ticks at FLEET_BATCH
    bitwise against `fleet_step`, and the health check."""
    import datetime

    import torch
    import torch.distributed as dist

    from kissmpc_tpu_torch import environment, solve_batch
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.obstacles import advance
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.parallel import fleet, multihost
    from kissmpc_tpu_torch.solver.problem import gather

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = fleet.make_mesh()
        batch = gather(pool, torch.arange(BATCH, device="cuda"))
        solver = fleet.make_fleet_solver(cfg, mesh)
        ref, (sol, metrics) = solve_batch(cfg, batch), solver(batch)
        torch.cuda.synchronize()
        d = ref.diagnostics
        if not all(torch.equal(a, b) for a, b in zip((sol.states, sol.controls, *sol.diagnostics),
                                                     (ref.states, ref.controls, *d))):
            fail("the fleet solver's solution differs from solve_batch's")
        own = (d.converged.float().mean(), d.kkt_stationarity.amax(), d.kkt_feasibility.amax(),
               d.final_cost.mean())
        if not all(torch.equal(a, b) for a, b in zip(metrics, own)):
            fail(f"fleet metrics {[float(x) for x in metrics]} differ from the diagnostics' "
                 f"{[float(x) for x in own]}")
        lat = {"solve_batch": [], "fleet": []}
        collectives = fleet.fleet_metrics.collectives
        solve_batch_fused.launches = fleet_launches = 0
        for _ in range(DP_CALLS):
            for name, call in (("solve_batch", lambda: solve_batch(cfg, batch)),
                               ("fleet", lambda: solver(batch))):
                before = solve_batch_fused.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e3)
                if name == "fleet":
                    fleet_launches += solve_batch_fused.launches - before
        per_call = (fleet.fleet_metrics.collectives - collectives) / DP_CALLS
        expected = (1 + len(cfg.solver.refine_stages)) * DP_CALLS
        if fleet_launches != expected:
            fail(f"the fleet solver launched the fused kernel {fleet_launches} times in "
                 f"{DP_CALLS} calls, expected {expected}")
        p50 = {name: float(np.percentile(v, 50)) for name, v in lat.items()}
        # What the fleet adds to a call, alone: the metric reduction.
        metrics_ms = cuda_ms(lambda: fleet.fleet_metrics(d, fleet.mesh_group(mesh)), reps=20)
        log(f"[13] fleet solver, one NCCL rank, k8_dyn2 B={BATCH}: solution bitwise equal to "
            f"solve_batch's, metrics equal to its diagnostics' (converged "
            f"{float(metrics.converged_fraction):.5f}); {per_call:g} collectives per call, "
            f"{fleet_launches} fused launches in its {DP_CALLS} calls; p50 {p50['fleet']:.3f} ms "
            f"against solve_batch's {p50['solve_batch']:.3f} ms "
            f"(+{p50['fleet'] - p50['solve_batch']:.3f} ms); the metric reduction alone "
            f"{metrics_ms:.4f} ms (CUDA events, one call per pair)")

        fcfg, params = fleet_config()
        env, obstacles, _ = fleet_worlds(fcfg, FLEET_BATCH, 2, "cuda")
        stepper = fleet.make_fleet_env_stepper(fcfg, params, mesh)
        chains = {"fleet_step": [env, obstacles], "stepper": [env, obstacles]}
        tick_ms = {name: [] for name in chains}
        solve_batch_fused.launches = stepper_launches = 0
        for tick in range(DP_TICKS):
            for name, chain in chains.items():
                before = solve_batch_fused.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "stepper":
                    new_env, _, step_metrics = stepper(*chain)
                else:
                    new_env, _ = environment.fleet_step(fcfg, params, *chain)
                chain[:] = [new_env, advance(chain[1], fcfg.time_step)]
                torch.cuda.synchronize()
                tick_ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "stepper":
                    stepper_launches += solve_batch_fused.launches - before
            a, b = (leaves(chains[n][0]) for n in chains)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"the fleet stepper's EnvState differs from fleet_step's at tick {tick}")
        tick_p50 = {name: float(np.percentile(v, 50)) for name, v in tick_ms.items()}
        expected = (1 + len(fcfg.solver.refine_stages)) * DP_TICKS
        if stepper_launches != expected:
            fail(f"the fleet stepper launched the fused kernel {stepper_launches} times in "
                 f"{DP_TICKS} ticks, expected {expected}")
        log(f"[13] fleet stepper B={FLEET_BATCH}, {DP_TICKS} ticks: EnvState bitwise equal to "
            f"fleet_step's every tick; tick p50 {tick_p50['stepper']:.3f} ms against "
            f"fleet_step's {tick_p50['fleet_step']:.3f} ms; {stepper_launches} fused launches in "
            f"its {DP_TICKS} ticks; last tick converged "
            f"{float(step_metrics.converged_fraction):.5f}")
        t0 = time.perf_counter()
        healthy = multihost.health_check(mesh, timeout_s=GROUP_TIMEOUT_S)
        health_s = time.perf_counter() - t0
        log(f"[13] health check: {healthy} in {health_s:.4f} s")
        if not healthy:
            fail("the one-rank health check failed")
    finally:
        dist.destroy_process_group()
    return {"batch": BATCH, "calls": DP_CALLS, "collectives_per_call": per_call,
            "fused_launches": fleet_launches, "stepper_fused_launches": stepper_launches,
            "fleet_p50_ms": p50["fleet"], "solve_batch_p50_ms": p50["solve_batch"],
            "fleet_minus_solve_batch_ms": p50["fleet"] - p50["solve_batch"],
            "metrics_ms": metrics_ms,
            "stepper_batch": FLEET_BATCH, "stepper_ticks": DP_TICKS,
            "stepper_tick_p50_ms": tick_p50["stepper"],
            "fleet_step_tick_p50_ms": tick_p50["fleet_step"], "health_check_s": health_s}


def lqr_pt_check(label, data, reg, gates):
    """`solve_lqr_associative` on ``data`` against the Riccati kernel: each
    scenario's KKT residual relative to its data's scale (at most
    LQR_PT_KKT_REL if "kkt" is in ``gates``), and phase 2's per-scenario
    dx/du gate against the kernel's output (gated if "riccati" is in
    ``gates``), each else reported; timed beside the kernel, the backward
    scan apart from the forward recovery."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import kkt_residual
    from kissmpc_tpu_torch.ops.lqr_pt import backward_pass, solve_lqr_associative
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

    B, n, dtype = data.A.shape[0], data.A.shape[1], str(data.A.dtype)[6:]
    kern = solve_lqr_cuda(data, reg)
    got = solve_lqr_associative(data, reg)
    torch.cuda.synchronize()
    scale = torch.stack([x.reshape(B, -1).abs().amax(1).double() for x in data]).amax(0)
    # The system both solve: Quu regularized by reg.
    solved = data._replace(Quu=data.Quu + reg * torch.eye(2, dtype=data.Quu.dtype,
                                                          device=data.Quu.device))
    rel = kkt_residual(solved, got).double() / scale
    rel_kernel = kkt_residual(solved, kern).double() / scale
    finite = bool(torch.isfinite(got.dx).all() and torch.isfinite(got.du).all())
    gate = riccati_gate(got, data, reg, ref=kern, outputs=("dx", "du"))
    ratios = {k: o["ratio"] for k, o in gate["outputs"].items()}
    log(f"[14] lqr_pt {label} {dtype} B={B} N={n}: relative KKT residual max "
        f"{float(rel.max()):.3e} (limit {LQR_PT_KKT_REL[dtype]:.0e}, "
        f"{'gated' if 'kkt' in gates else 'reported'}; the kernel's "
        f"{float(rel_kernel.max()):.3e}); dx/du against the kernel: max "
        f"{gate['err']:.3e}, {ratios} of phase 2's per-scenario limits "
        f"({'gated' if 'riccati' in gates else 'reported'})")
    if not finite:
        fail(f"lqr_pt {label} {dtype}: non-finite dx or du")
    if "kkt" in gates and not float(rel.max()) <= LQR_PT_KKT_REL[dtype]:
        fail(f"lqr_pt {label} {dtype}: KKT residual {float(rel.max()):.3e} of the data's scale")
    if "riccati" in gates and not gate["ok"]:
        fail(f"lqr_pt {label} {dtype} disagrees with the Riccati kernel: {ratios}")
    reps = 3 if n > 500 else 10
    total_ms = cuda_ms(lambda: solve_lqr_associative(data, reg), reps=reps, warmup=1)
    backward_ms = cuda_ms(lambda: backward_pass(data, reg), reps=reps, warmup=1)
    kernel = kernel_ms(lambda: solve_lqr_cuda(data, reg), reps=5 if n > 500 else 20, graph=True)
    log(f"[14] lqr_pt {label} {dtype} B={B} N={n}: {total_ms:.3f} ms (backward scan "
        f"{backward_ms:.3f}, forward recovery {total_ms - backward_ms:.3f}) against the Riccati "
        f"kernel's {kernel:.5f} ms ({total_ms / kernel:.1f}x)")
    return {"B": B, "N": n, "dtype": dtype, "gates": sorted(gates), "ms": total_ms,
            "backward_ms": backward_ms, "forward_ms": total_ms - backward_ms,
            "kernel_ms": kernel, "kkt_rel_max": float(rel.max()),
            "kernel_kkt_rel_max": float(rel_kernel.max()), "max_abs_err": gate["err"],
            "gate_ratio": ratios}


def phase_lqr_pt(cfg, pool):
    """Phase 14: the associative-scan LQR against the Riccati kernel on
    phase 2's data (N=50, B=8192, float32 and float64) and phase 10's
    (N=2000, B=1025, float64 gated, float32 reported), with the kernel
    launches of one call counted by the profiler at N=2000."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kissmpc_tpu_torch.ops.lqr import LQRData
    from kissmpc_tpu_torch.ops.lqr_pt import solve_lqr_associative
    from kissmpc_tpu_torch.solver.problem import gather

    reg = cfg.solver.reg
    data = lqr_from_iterate(cfg, gather(pool, torch.arange(BATCH, device="cuda")))
    # On phase 2's barrier-conditioned data the sequential solve is not the
    # more accurate of the two (f64 KKT residuals), so the dx/du gate
    # against it is reported there and the KKT residual gates.  At N=2000
    # the residual's own adjoint recursion grows through 2000 steps of
    # near-identity A (1.6e-4 and 6.0e-4 of the scale for the two solves
    # where they agree to 2e-14, on an H100), so there the dx/du gate holds
    # f64; f32 at N=2000 is reported only (the composition of inverses is
    # not conditioned for it).
    rows = [lqr_pt_check("phase 2's data", LQRData(*(x.to(dtype) for x in data)), reg,
                         gates={"kkt"})
            for dtype in (torch.float32, torch.float64)]
    B = RICCATI_LONG_BATCHES[-1]
    for dtype, gates in ((torch.float64, {"riccati"}), (torch.float32, set())):
        long = random_lqr(B, RICCATI_LONG_N, seed=1, dtype=dtype)
        rows.append(lqr_pt_check("phase 10's data", long, 1e-8, gates))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_lqr_associative(long, 1e-8)
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(1 for e in events if e.device_type.name == "CUDA")
    runtime = {name: sum(1 for e in events if e.name == name)
               for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    log(f"[14] one lqr_pt call at N={RICCATI_LONG_N}, B={B}: {launches} kernels on the card "
        f"(profiler), {launches / RICCATI_LONG_N:.2f} per step; runtime calls {runtime}")
    return {"rows": rows, "launches_n2000": launches, "runtime_calls_n2000": runtime}


def phase_utils_cli(tmpdir, cfg, pool):
    """Phase 15: the CLI's demo, map and lab on the card, a profiler trace
    of one fleet tick, `measure` on solve_batch, and a checkpoint of the
    fleet's EnvState resumed bitwise."""
    import glob

    import torch

    from kissmpc_tpu_torch import cli, environment, solve_batch
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather
    from kissmpc_tpu_torch.utils import profiling
    from kissmpc_tpu_torch.utils.checkpoint import CheckpointManager, FleetCheckpoint

    result = {}
    path = f"{tmpdir}/synthetic_lab.pgm"
    write_synthetic_map(path)  # phase 9's map: the same shape and seed
    for name, argv in (("demo", ["demo", "--ticks", str(DEMO_TICKS)]),
                       ("map", ["map", path, "-o", f"{tmpdir}/circles.npz"]),
                       ("lab", ["lab", "--map", path, "--batch", str(CLI_LAB_BATCH),
                                "--ticks", str(CLI_LAB_TICKS)])):
        solve_batch_fused.launches = solve_lqr_cuda.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        result[f"{name}_s"] = time.perf_counter() - t0
        launches = {"fused": solve_batch_fused.launches, "riccati": solve_lqr_cuda.launches}
        result[f"{name}_launches"] = launches
        log(f"[15] cli {' '.join(argv[:1] + argv[2:] if name == 'map' else argv)}: rc {rc} in "
            f"{result[f'{name}_s']:.3f} s; kernel launches {launches}")
        if rc != 0:
            fail(f"cli {name} returned {rc}")
        # demo solves split (the agent's make_solver), lab through fleet_step.
        kernel = {"demo": "riccati", "lab": "fused"}.get(name)
        if kernel and not launches[kernel]:
            fail(f"cli {name} never launched the {kernel} kernel")
    circles = np.load(f"{tmpdir}/circles.npz")
    if not (len(circles["radii"]) > 0 and np.isfinite(circles["centers"]).all()):
        fail("cli map wrote no circles")

    fcfg, params = fleet_config()
    env, obstacles, _ = fleet_worlds(fcfg, FLEET_BATCH, 3, "cuda")
    env, _ = environment.fleet_step(fcfg, params, env, obstacles)
    with profiling.trace(f"{tmpdir}/trace") as prof:
        with profiling.annotate("fleet_tick"):
            traced, _ = environment.fleet_step(fcfg, params, env, obstacles)
        torch.cuda.synchronize()
    files = glob.glob(f"{tmpdir}/trace/*.json")
    text = open(files[0]).read() if len(files) == 1 else ""
    device_ms = sum(e.device_time for e in prof.events() if e.device_type.name == "CUDA") / 1e3
    log(f"[15] profiling.trace of one fleet tick (B={FLEET_BATCH}): {len(text)} bytes; names "
        f"fleet_tick: {'fleet_tick' in text}, ipm_fused_kernel: {'ipm_fused_kernel' in text}; "
        f"device time {device_ms:.3f} ms")
    if "fleet_tick" not in text or "ipm_fused_kernel" not in text:
        fail("the trace names neither the fleet_tick span nor the fused kernel")
    result.update(trace_bytes=len(text), trace_device_ms=device_ms)

    batch = gather(pool, torch.arange(BATCH, device="cuda"))
    stats = profiling.measure(solve_batch, cfg, batch, warmup=1, reps=5)
    log(f"[15] measure(solve_batch) k8_dyn2 B={BATCH}: {json.dumps(stats)}")
    result.update(measure=stats)

    gen = torch.Generator(device="cuda").manual_seed(5)
    state = FleetCheckpoint(env_state=env, rng_key=gen.get_state(),
                            scenario_cursor=torch.tensor(FLEET_BATCH), tick=torch.tensor(1))
    mgr = CheckpointManager(f"{tmpdir}/ckpt")
    t0 = time.perf_counter()
    mgr.save(1, state)
    save_s = time.perf_counter() - t0
    restored = mgr.restore(mgr.latest_step(), state)
    mgr.close()
    resumed, _ = environment.fleet_step(fcfg, params, restored.env_state, obstacles)
    torch.cuda.synchronize()
    same_state = all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(state)))
    same_tick = all(torch.equal(a, b) for a, b in zip(leaves(resumed), leaves(traced)))
    on_card = all(x.is_cuda for x in leaves(restored.env_state))
    log(f"[15] checkpoint of the B={FLEET_BATCH} EnvState: saved in {save_s:.4f} s, restored "
        f"bitwise {same_state} (on the card {on_card}), resumed tick bitwise equal to the "
        f"uninterrupted one {same_tick}")
    if not (same_state and same_tick and on_card):
        fail("the checkpoint did not resume the fleet bitwise")
    result.update(checkpoint_save_s=save_s)
    return result


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")

    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    build_s, occupancy = phase_build()
    fused_cfgs, split_cfgs = configs("fused"), configs("split")
    t0 = time.perf_counter()
    pools = {
        "free": free_problems(fused_cfgs["free"], POOL, seed=0),
        "k8_dyn2": obstacle_problems(fused_cfgs["k8_dyn2"], POOL, seed=0, n_dynamic=2),
    }
    pools["k8_dyn2_elastic"] = pools["k8_dyn2"]  # the same scenarios, elastic constraints
    torch.cuda.synchronize()
    log(f"pools of {POOL} built on the card in {time.perf_counter() - t0:.3f} s")

    riccati = phase_kernel(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    probe = phase_probe()
    fused = phase_fused_kernel(fused_cfgs, pools)
    fused_stages = phase_fused_stages(fused_cfgs, pools)
    fused_results, fused_launches = phase_main_path("fused", fused_cfgs, pools, CALLS)
    hard = ("free", "k8_dyn2")
    split_results, riccati_launches = phase_main_path(
        "split", {name: split_cfgs[name] for name in hard}, pools, CALLS)
    riccati["launches"] = riccati_launches
    mehrotra = phase_mehrotra(split_cfgs["free"], pools["free"])
    for name, cfg in fused_cfgs.items():
        idx = torch.as_tensor(np.random.default_rng(1).permutation(POOL)[:BATCH], device="cuda")
        stage_ms = timed_stages(cfg, gather(pools[name], idx))
        fused_results[name]["stage_ms"] = stage_ms
        log(f"[5] fused {name}: CUDA-event time of each stage's launch (B, ms): {stage_ms}")
    phase_cpu_check(fused_cfgs, split_cfgs, pools)
    fleet = phase_fleet()
    planner = phase_planner()
    with tempfile.TemporaryDirectory() as tmpdir:
        lab = phase_lab(tmpdir)
    ric_edges, fused_edges = phase_horizons(fused_cfgs)
    riccati.update(long_horizon=ric_edges)
    with tempfile.TemporaryDirectory() as tmpdir:
        perception = phase_perception(tmpdir)
        node = phase_node(tmpdir)
    riccati.update(node_launches_per_tick=node["riccati_launches_per_tick"],
                   node_launches=node["riccati_launches_per_tick"] * node["ticks"])
    t0 = time.perf_counter()
    data_parallel = phase_data_parallel(fused_cfgs["k8_dyn2"], pools["k8_dyn2"])
    data_parallel["phase_s"] = t1 = time.perf_counter() - t0
    lqr_pt = phase_lqr_pt(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    lqr_pt["phase_s"] = t2 = time.perf_counter() - t0 - t1
    with tempfile.TemporaryDirectory() as tmpdir:
        utils_cli = phase_utils_cli(tmpdir, fused_cfgs["k8_dyn2"], pools["k8_dyn2"])
    utils_cli["phase_s"] = time.perf_counter() - t0 - t1 - t2
    log(f"phases 13-15 took {t1:.3f} / {t2:.3f} / {utils_cli['phase_s']:.3f} s")
    riccati.update(cli_demo_launches=utils_cli["demo_launches"]["riccati"])

    # The fused row is the K=8 cell's, with the elastic branch's numbers
    # beside it; its launches are the fused main path's (all three cells).
    fused_k8, elastic = fused["k8_dyn2"], fused["k8_dyn2_elastic"]
    for entry in fused.values():
        entry["launches"] = fused_launches
    fused_k8.update(elastic_ms=elastic["ms"], elastic_plain_ms=elastic["plain_ms"],
                    elastic_bound_ms=elastic["bound_ms"],
                    elastic_max_abs_err=elastic["max_abs_err"], stage_ms=fused_stages,
                    longest_horizon=fused_edges, fleet_launches=fleet["fused_launches"],
                    perception_launches_per_tick=perception["with_perception"][
                        "fused_launches_per_tick"],
                    data_parallel_launches=data_parallel["fused_launches"],
                    data_parallel_stepper_launches=data_parallel["stepper_fused_launches"],
                    cli_lab_launches=utils_cli["lab_launches"]["fused"])
    log(json.dumps({"build_s": build_s, "fused_occupancy": occupancy,
                    "fused_free_kernel": fused["free"],
                    "main_path": {"fused": fused_results, "split": split_results,
                                  "split_mehrotra": mehrotra},
                    "fleet": fleet, "planner": planner, "lab_worlds": lab,
                    "perception_tick": perception, "node_tick": node,
                    "data_parallel": data_parallel, "lqr_pt": lqr_pt, "utils_cli": utils_cli,
                    "total_s": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"kernels": [riccati, probe, fused_k8]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
