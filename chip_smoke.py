#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`kissmpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. build the five CUDA libraries from `kissmpc_tpu_torch/csrc/` (one nvcc
   per source, all started together: the Riccati kernel, the probe, the
   fused IPM kernel, the split solve's four kernels and the problem
   build) and print each
   ptxas register/spill line; for the fused kernel's launch at every solve
   stage of each configuration and of the fleet tick, its width (warps per
   scenario), registers, local bytes, dynamic shared memory per block and
   the scenarios resident per SM (`ops/ipm_fused.py::occupancy`); the same for
   the Riccati kernel in float32 and float64 at B=8192 and 164 (its two
   chunk lengths), with its lanes and scenarios per block
   (`ops/riccati.py::occupancy`);
Before phase 2 the benchmark's pools of 16384 (seed 0) are built on the card,
free eagerly and K=8 by `scenarios.obstacle_problems`, one CUDA graph (as
the reference jits its builder; inside it one launch of the build kernel):
its program under the sync debug mode, the
first call (warm-up and capture) timed, then a second K=8 pool (seed 1) by a
replay and eagerly, timed, bitwise equal, with the graph's static output
bytes.

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
   then phases 17 and 18 (below) run;
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
5. drive the main path, `make_batch_solver` (the benchmark's entry point,
   one CUDA graph per configuration: the base solve and every refine
   stage) with the default ("fused") backend, beside the eager
   `solve_batch` on the same batches, at the benchmark's configurations
   (`bench.py`): N=50, B=8192, float32, 32 IPM iterations plus staged
   refinement, obstacle-free and K=8 circles with 2 dynamic tracks, and
   k8_dyn2_elastic.  A warm-up batch solved by the program eagerly under
   `torch.cuda.set_sync_debug_mode("error")` and by the first captured
   call (warm-up and capture, timed), then 5 distinct batches drawn from a
   pool of 16384, each solved eagerly and by a replay in turns, timed,
   bitwise equal; one replay under the profiler (kernels, busy time, idle
   share; its fused, Riccati and split kernels equal to the counters').  Every call launches the fused kernel once per
   solve stage and no other.  Then the same for the "split" backend (free
   and K=8), whose every IPM iteration is one condensation, one Riccati and
   one step launch, and every solve stage one init and one diagnostics
   launch (by the counters around every call, and by the profiled
   replay's trace), and one eager call each of split with mehrotra "pc"
   and "soc" on the free configuration: two condensations, two Riccati
   solves and one step per iteration, one init and one diagnostics per
   stage;
6. check 64 scenarios of each configuration against the port's CPU path:
   the fused kernel against its plain version on the CPU in float32, the
   split path in float64 and float32, and in float64 the split path with
   elastic obstacles and with mehrotra "pc" and "soc";
7. the closed loop: `environment.fleet_step` plus `obstacles.advance` per
   tick as one CUDA graph (`fleet_tick`, as scripts/bench_fleet_episodes.py:169
   jits it; its program first under the sync debug mode) at the
   configuration of `scripts/bench_fleet_episodes.py` (N=50, K=8, 32
   iterations plus two refine stages, B=4096 episode worlds routed by the
   "grid" router, the batched grid planner on a 96-cell grid with 3 route
   points per leg, 50 ticks: the first a warm-up and capture, reported
   apart), 3 fused launches and one build launch per tick (by the counters
   and a profiled replay's trace); the first 10 ticks also eagerly on a
   copy of the state, bitwise equal to the replays; one replayed tick under
   the profiler for the fused stages' share of a tick; the world build's
   time and its fraction of reachable legs; one replan from the current
   poses at the middle tick (as the bench's, timed, and left out of the
   tick latencies); a short loop on "detour" worlds for that router's tick
   time beside it; then 64 episodes x 5 ticks on the card and on the CPU
   port, whose waypoint indices must match on 95% of episode-ticks and
   whose executed states must agree within 1e-3 on 95% of them;
8. the planner at the fleet's B=4096 on the card, its grid fields one CUDA
   graph each: the world build, the replan and `bottleneck_clearance`,
   each eagerly under the sync debug mode, then captured (or replayed) and
   replayed, timed, bitwise equal to the eager run; one eager and one
   replayed `plan_waypoint_chain` under the profiler (kernels, idle share);
   then 64 episodes on the card and on the CPU port: leg reachability
   equal, route points within 1e-4 m and clearances within 1e-5 m on at
   least 63 of 64 episodes (the log names any that differ);
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
   to each episode's start and joined to its static circles; each variant
   (solver-only, with perception) one CUDA graph (`perception_tick`, as the
   bench jits it; the frame index a device tensor, the frames, geometry,
   offsets and static circles inputs), both programs first under the sync
   debug mode; the variants alternate in chunks of 8 ticks (56 replays each
   after the first call, the capture, at frame 0), 3 fused launches and
   one build launch per tick; the first call and the first 10 replays of each also eagerly on a
   copy of the state, bitwise equal (env, perception state, step info,
   tracked set) at 10 distinct frames; replay p50 and p99, eager p50, and
   `perception_added_ms` replayed and eager; one profiled replay of each
   (kernels, busy, idle share against the p50, 3 fused kernels) and
   DBSCAN's kernels and device time inside the perception replay (its
   eager kernels found back to back in the replay's trace); the eager
   perception step's CUDA-event time and DBSCAN's share of it, and its
   kernels by the profiler; gates: at the last tick exactly B confirmed
   tracks, each within 0.25 m of the walk's ground truth, converged >= 0.90
   in both variants; then 64 pipelines x 10 frames on the card and on the
   CPU port: found flags, DBSCAN labels and track ids equal, centres and
   track positions within 1e-5 m on at least 63;
12. the single-robot node: `io.Model` at the node's defaults (N=7,
   planning dt 0.8, 40 iterations) with 4 obstacle slots, driven by
   `io.pubsub.ControlLoop` for 50 ticks (odometry every tick, the walk's
   tracked humans from `io.frames.replay_session` every 10), its tick one
   CUDA graph (`solver/graph.py`: captured at the first tick, replayed
   after it); tick p50 and p99 of ticks 2-50 against the 10 ms period of
   the node's 100 Hz timer, the first tick (warm-up and capture) apart;
   the same walk and
   odometry on the eager path on the card (`graph.eager()`), its p50 and
   p99; one eager tick under the profiler (kernels, idle share, kernel
   launches by op) and 3 replayed ticks, each traced alone (kernels, idle
   share, host syncs, the IPM loop's kernels and their time); the replayed
   tick's p50 and p99 against the 10 ms period; the tick's program eagerly
   under `torch.cuda.set_sync_debug_mode("error")`; gates: one graph for
   the 50 ticks, condensation, Riccati and step launches per tick each
   equal to the iterations run, and one build, one init and one
   diagnostics launch per tick, on both paths, the captured commands
   bitwise equal to the eager ones, each replayed tick's counters and a
   replayed tick's trace showing exactly 40 of each of the three
   iteration kernels (120 for the IPM loop) and one of each of the other
   three, and at most 8 host syncs (one per leaf read back),
   the first 10 ticks' commands within 1e-3 of the CPU port's on the same
   inputs, the Riccati kernel against its plain version by phase 2's gate
   and the split kernels against their plain halves by phase 17's gates
   on the last tick's problem (B=1, N=7);
13. the data-parallel fleet (`parallel.fleet`) over a one-rank NCCL group
   from an in-process store, each fleet call one CUDA graph with its two
   `all_reduce`s (each program first under the sync debug mode):
   `make_fleet_solver` on the K=8 cell at B=8192 bitwise equal to the
   captured `make_batch_solver` and its `FleetMetrics` equal to that
   call's diagnostics', 2 collectives counted per replay, p50 of 5 calls
   beside `make_batch_solver`'s; `make_fleet_env_stepper` for 10 ticks at
   B=4096 (grid worlds) with its EnvState and obstacles bitwise equal to
   phase 7's captured tick's every tick, both ticks' p50;
   `multihost.health_check` True within its timeout;
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
15. the CLI on the card: `agent.step`'s program at the demo's
   configuration and `lab --ticks 1`'s programs under the sync debug mode;
   `demo --ticks 60` (every tick one replay of `agent.step`'s CUDA graph:
   one graph captured), `map` and `lab --batch 256 --ticks 50` (every tick
   one replay of its `fleet_step` graph, 3 fused launches per tick) on
   phase 9's synthetic map (written again from its seed), each returning
   0; one fleet tick (B=4096) in `utils.profiling.trace` with an
   `annotate("fleet_tick")` span, whose trace must name the span
   and the fused kernel; a `FleetCheckpoint` of the fleet's EnvState
   saved, restored onto the card bitwise, and its next tick bitwise equal
   to the uninterrupted one;
16. `make_solver` captured (one CUDA graph) against the eager `ipm.solve`
   on k8_dyn2 (split, N=50, float32, 32 iterations) at B=8192: its program
   under the sync debug mode, the first call (warm-up and capture) timed,
   then 5 eager calls and 5 replays in turns, each bitwise equal to the
   eager result, the first result unchanged by them, p50 of both, and one
   replay's condensation, Riccati and step kernels by the profiler equal
   to its launch counters' 32 each, and its init and diagnostics kernels
   to their 1 each;
17. (run right after phase 2) the split iteration's two kernels
   (`csrc/ipm_split.cu`) against their plain halves on the card
   (`split_kernels_check`), on the iterate after 8 plain iterations:
   k8_dyn2 at B=8192 and at the last refine stage's 164 in float32 and
   float64, k8_dyn2_elastic and free at B=8192, mehrotra "pc" at 164, and
   the node (N=7, B=1, 4 obstacle slots).  Condensation: each LQRData
   field of each scenario within 1e-4 of its scale plus twice the plain
   version's own f32-vs-f64 gap (f64: 1e-9 of its scale).  Step (given the
   plain condensation and Riccati solve): the accepted line-search
   candidate differs on at most max(1, twice the plain version's own
   f32-vs-f64 flips) scenarios, and elsewhere the new iterate, the next mu
   and the step length meet the same gate, and so do the merits at
   alpha = 0 and at every candidate and the penalty weight rho (the
   kernel's optional output, null on the main path; their f32-vs-f64 gap
   is the plain version's against itself in float64 arithmetic with
   float32's floors).  Each kernel timed
   by `kernel_ms` (20 launches in a CUDA graph) beside its bound
   (`split_bound`) and its plain half, with the step's warps per scenario
   and residency (`ops/ipm_split.py::step_occupancy`); k8_dyn2 float32 is
   also timed at the other refine batches, 1024 and 328;
18. (run right after phase 17) the problem build kernel
   (`csrc/problem_build.cu`) against `build_plain` (`build_kernel_check`)
   on the pool's inputs (K=8, N=50, B=16384), the fleet loop's first tick
   (B=4096) and the node's (N=7, B=1, 6 obstacles for 4 slots), and the
   split solve's init and diagnostics kernels (`csrc/ipm_split.cu`)
   against `ipm.init_plain` and `ipm.diagnostics_plain`
   (`once_kernels_check`) at k8_dyn2's B=8192, 1024, 328 and 164,
   k8_dyn2_elastic, mehrotra "pc" and the node, float32 and float64.
   Build: every Problem field of each scenario within 1e-4 of its scale
   plus twice the plain version's own f32-vs-f64 gap (f64: 1e-9 of its
   scale); a scenario outside it counts as a discrete flip (the sensor's
   order, the repair's deepest obstacle, the roll, a blocked step), at
   most `allowed_flips` (twice its `ulp_witness`'s flips).  Init and
   diagnostics: every field by the same gate, ``converged`` flips counted
   the same way.  Each kernel timed by `kernel_ms` (20 launches in a CUDA
   graph) beside its bound (`build_bound`, `once_bound`) and its plain
   version; the diagnostics with their launch shape
   (`ops/ipm_split.py::diagnostics_occupancy`).

Every check of a call's counted kernels by the profiler's trace
(`traced_launches`) reads the last of two calls between recorded marker
kernels: the profiler can lose a trace's first kernels, and a tick's first
kernel is now its build kernel.

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
SECOND_POOL_SEED = 1  # the K=8 pool built again, by a replay of the builder's graph
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
FLEET_EAGER_TICKS = 10  # eager ticks on a copy of the state, held to the replays
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
PERCEPTION_VARIANTS = ("solver_only", "with_perception")
PERCEPTION_EAGER_TICKS = 10  # replays also run eagerly on a copy of the state
PERCEPTION_COMPARED_FRAMES = 5  # distinct frames among the compared ticks, at least
MARKER_LEAD_CYCLES = 10_000_000  # a few ms of spin before a (marked) profile's calls
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
NODE_PROFILED = 3  # replayed ticks traced one by one
NODE_LEAVES_READ = 8  # states, controls and the six diagnostics, one read each
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
# Phase 16: make_solver's eager calls and replays, in turns.
CAPTURED_CALLS = 5
# Phase 17: plain iterations before the iterate the split kernels are held on.
SPLIT_CHECK_ITERATIONS = 8
# Phase 18: node-shaped scenarios the build kernel is held on beside the
# node's own one (N=7, K=4 slots, NODE_BUILD_K_ALL obstacles each).  The
# build's and the diagnostics' discrete flips (`allowed_flips`): twice the
# witness's, at least one scenario in FLIP_SHARE (none in a smaller batch),
# at most one in FLIP_CAP whatever the witness.
NODE_BUILD_BATCH = 512
NODE_BUILD_K_ALL = 6
FLIP_SHARE = 100
FLIP_CAP = 4
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

    from kissmpc_tpu_torch.ops import _build, ipm_fused, ipm_split, probe, problem_build, riccati

    sources = {
        "kissmpc_riccati": riccati.SOURCE,
        "kissmpc_probe": probe.SOURCE,
        "kissmpc_ipm_fused": ipm_fused.SOURCE,
        "kissmpc_ipm_split": ipm_split.SOURCE,
        "kissmpc_problem_build": problem_build.SOURCE,
    }
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(_build.build, src, name) for name, src in sources.items()}
        libs = {name: f.result() for name, f in futures.items()}
    for module in (riccati, probe, ipm_fused, ipm_split, problem_build):
        module._library()
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"[1] built {', '.join(lib.name for lib in libs.values())} in {build_s:.3f} s")
    occupancy = {}
    cells = [(name, cfg, BATCH) for name, cfg in configs("fused").items()]
    for name, cfg, size in cells + [("fleet_b4096", fleet_config()[0], FLEET_BATCH)]:
        for B, _, _ in stage_shapes(cfg, size):
            occupancy[f"{name}_b{B}"] = occ = ipm_fused.occupancy(cfg, B)
            branch = "elastic" if cfg.solver.elastic_obstacles else "hard"
            log(f"[1] fused kernel, {name} B={B} ({branch} instance, {occ['width']} warp(s) per "
                f"scenario): {occ['registers']} registers, {occ['local_bytes']} bytes of local "
                f"memory per thread (stack frame and spills, as the ptxas lines above split "
                f"them), {occ['smem_bytes_per_block']} bytes of dynamic shared memory per block "
                f"of {occ['warps_per_block']} warps, {occ['blocks_per_sm']} blocks = "
                f"{occ['scenarios_per_sm']} scenarios resident per SM")
            if occ["blocks_per_sm"] < 1:
                fail(f"the fused kernel cannot be resident for {name} at B={B}")
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


def split_iterate(cfg, problems, iterations):
    """The split IPM's iterate after ``iterations`` plain iterations from
    the warm start (`ipm.condense_plain`, `ops/lqr.py`, `ipm.step_plain`),
    and its next mu."""
    import torch

    from kissmpc_tpu_torch.solver import ipm

    with torch.no_grad():
        it, mu = ipm.init_plain(cfg, problems)
        for _ in range(iterations):
            it, mu, _ = ipm._iteration(cfg, problems, it, mu)
    return it, mu


def lqr_from_iterate(cfg, problems, iterations=8):
    """LQR data of the IPM's Newton system after a few iterations."""
    from kissmpc_tpu_torch.solver import ipm

    it, mu = split_iterate(cfg, problems, iterations)
    return ipm.condense_plain(cfg, problems, it, mu)


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


SPLIT_FLIP_RTOL = 1e-3  # alphas of one candidate agree far closer; two differ by ls_backtrack


def allowed_flips(witness_flips, batch):
    """Discrete flips a kernel may show against its plain version in a
    batch of ``batch``: twice its witness's (`ulp_witness`), at least one
    scenario in FLIP_SHARE (so none below FLIP_SHARE scenarios without a
    witness), and never more than one in FLIP_CAP: however fragile the
    data, three scenarios in four (all of a batch below FLIP_CAP) are held
    to the field gate."""
    return min(max(batch // FLIP_SHARE, 2 * witness_flips), batch // FLIP_CAP)


def nudged(x, up):
    """``x`` moved one ulp of its dtype up (or down)."""
    import torch

    return torch.nextafter(x, torch.full_like(x, float("inf") if up else -float("inf")))


def ulp_witness(evaluate, start, differs):
    """The plain version's own discrete flips in the kernel's dtype: the
    most scenarios where ``differs(result)`` holds among three evaluations
    an ulp away from the one the kernel is held to, the plain version on
    the CPU (``evaluate(True, None)``) and with ``start`` moved one ulp up
    and down (``evaluate(False, moved)``).  ``differs`` returns a boolean
    per scenario."""
    evals = [evaluate(True, None)] + [evaluate(False, nudged(start, up)) for up in (True, False)]
    return max(int(differs(r).sum()) for r in evals)


def on_cpu(tree):
    """Every tensor of a tuple (or NamedTuple) tree, and ``kw``'s, on the CPU."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: on_cpu(v) if k != "device" else "cpu" for k, v in tree.items()}
    if tree is None or not isinstance(tree, tuple):
        return tree
    return type(tree)(*(on_cpu(x) for x in tree)) if hasattr(tree, "_fields") \
        else type(tree)(on_cpu(x) for x in tree)


def _cast(tree, dtype):
    """Every floating tensor of a tuple (or NamedTuple) tree in ``dtype``."""
    import torch

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.dtype.is_floating_point else tree
    return type(tree)(*(_cast(x, dtype) for x in tree)) if hasattr(tree, "_fields") \
        else type(tree)(_cast(x, dtype) for x in tree)


def _field_ratio(got, ref, other, f32, own=False):
    """One field of `split_field_gate`, per scenario: (err, err / tol).
    With ``own``, the plain version's own gap instead: |other - ref| over
    1e-4 of the scale, its finite entries (above 1 where the two precisions
    part by more than rounding: a discrete decision taken the other way)."""
    import torch

    B = ref.shape[0]
    g = got.reshape(B, -1).double()
    r = ref.reshape(B, -1).double().to(g.device)
    o = other.reshape(B, -1).double().to(g.device)
    if g.shape[1] == 0:
        zero = torch.zeros(B, dtype=g.dtype, device=g.device)
        return zero, zero
    rf = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
    scale = rf.abs().amax(1).clamp(min=1.0)
    og = torch.where(torch.isfinite(o) & torch.isfinite(r), (r - o).abs(), torch.zeros_like(r))
    if own:
        return og.amax(1), og.amax(1) / (1e-4 * scale)
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    diff = torch.where(same, torch.zeros_like(g), (g - r).abs()).nan_to_num(nan=float("inf"))
    err = diff.amax(1)
    tol = 1e-4 * scale + 2.0 * og.amax(1) if f32 else 1e-9 * scale
    return err, err / tol


def split_field_gate(fields, f32, skip=None):
    """Each of ``fields`` ((name, got, ref, other) with a leading batch
    axis; ``other`` the plain version in the other precision) held per
    scenario: within 1e-4 of that scenario's scale of the field (its
    largest magnitude in ``ref``, at least 1) plus twice the plain
    version's own f32-vs-f64 gap there in float32, within 1e-9 of the
    scale in float64; equal non-finite entries agree, others do not.
    Scenarios in the boolean mask ``skip`` are left out.  Returns {"ok",
    "err", "fields": {name: {"err", "scenario", "ratio"}}}."""
    import torch

    out, ok = {}, True
    for name, got, ref, other in fields:
        err, ratio = _field_ratio(got, ref, other, f32)
        if skip is not None:
            ratio = torch.where(skip.to(ratio.device), torch.zeros_like(ratio), ratio)
            err = torch.where(skip.to(err.device), torch.zeros_like(err), err)
        worst = int(ratio.argmax())
        out[name] = {"err": float(err.max()), "scenario": worst, "ratio": float(ratio[worst])}
        ok = ok and out[name]["ratio"] <= 1.0
    worst = max(out, key=lambda k: out[k]["ratio"])
    return {"ok": ok, "err": max(o["err"] for o in out.values()), "worst": worst, "fields": out}


def _flips(a, b):
    """Scenarios whose accepted step lengths name different candidates."""
    a, b = a.double(), b.double().to(a.device)
    return ~((a - b).abs() <= SPLIT_FLIP_RTOL * b.abs())


@contextlib.contextmanager
def float32_floors():
    """The plain halves with float32's floors at every dtype (`ipm._floor`,
    `ipm._sigma_max`): float64 arithmetic under the float32 contract."""
    import torch

    from kissmpc_tpu_torch.solver import ipm

    saved = ipm._floor, ipm._sigma_max
    ipm._floor = lambda dtype: saved[0](torch.float32)
    ipm._sigma_max = lambda dtype: saved[1](torch.float32)
    try:
        yield
    finally:
        ipm._floor, ipm._sigma_max = saved


def split_kernels_check(cfg, problems, iterations, lib, stream, warps=None):
    """The split iteration's two kernels, launched through ``lib`` on
    ``stream`` by the wrapper's card path (`ops/ipm_split.py::_condense`,
    `_step`, with ``warps`` per scenario if given, else the wrapper's
    choice; a CPU build of the source runs them on CPU tensors), against
    their plain halves on the iterate after ``iterations`` plain
    iterations, with the plain predictor's correction rows under Mehrotra:

    - condensation: each LQRData field of each scenario by
      `split_field_gate` (float32: 1e-4 of its scale plus twice the plain
      version's own f32-vs-f64 gap; float64: 1e-9 of its scale);
    - step, given the plain condensation and its plain Riccati solve: the
      accepted candidate differs on at most max(1, twice the plain
      version's own f32-vs-f64 flips) scenarios, and elsewhere the new
      iterate, the next mu and the step length meet the same gate;
    - the step's merits at alpha = 0 and at every candidate and its
      penalty weight rho, of every scenario, by the same gate, the plain
      version's own gap measured against itself in float64 arithmetic
      with float32's floors (`float32_floors`): the floors are part of
      the float32 contract, and against float64's floors (sigma at most
      1e18, not 1e12) their effect and float32 rounding cancel in some
      elastic scenarios, hiding the rounding the kernel does not share.

    Returns {"ok", "condense", "step", "merit", "flips", "plain_flips",
    "allowed", "B", "dtype"} and the inputs, outputs of the kernels
    ("launched")."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.ops.lqr import solve_lqr
    from kissmpc_tpu_torch.solver import ipm

    problems = ipm._contiguous(problems)
    dtype = problems.initial_state.dtype
    f32 = dtype == torch.float32
    other = torch.float64 if f32 else torch.float32
    with torch.no_grad():
        it, mu = split_iterate(cfg, problems, iterations)
        corr = None
        if cfg.solver.mehrotra != "off":
            mu, corr = ipm._predictor(cfg, problems, it, mu, ipm.condense_plain, solve_lqr)
        args_o = [_cast(x, other) for x in (problems, it, mu, corr)]
        got_c = ipm_split._condense(lib, stream, cfg, problems, it, mu, corr)
        ref_c = ipm.condense_plain(cfg, problems, it, mu, corr)
        oth_c = ipm.condense_plain(cfg, *args_o)
        cgate = split_field_gate([(f, getattr(got_c, f), getattr(ref_c, f), getattr(oth_c, f))
                                  for f in ref_c._fields], f32)
        sol = solve_lqr(ref_c, cfg.solver.reg)
        got_s, got_m = ipm_split._step(lib, stream, cfg, problems, it, mu, ref_c, sol, corr,
                                       merits=True, warps=warps)
        ref_s, ref_m = ipm.step_plain(cfg, problems, it, mu, ref_c, sol, corr, merits=True)
        oth_s, oth_m = ipm.step_plain(cfg, *args_o[:3], _cast(ref_c, other), _cast(sol, other),
                                      args_o[3], merits=True)
        if f32:
            with float32_floors():
                _, oth_m = ipm.step_plain(cfg, *args_o[:3], _cast(ref_c, other),
                                          _cast(sol, other), args_o[3], merits=True)
    flips = _flips(got_s.alpha, ref_s.alpha)
    plain_flips = int(_flips(oth_s.alpha, ref_s.alpha).sum())
    allowed = max(1, 2 * plain_flips)
    fields = [(f, getattr(got_s.it, f), getattr(ref_s.it, f), getattr(oth_s.it, f))
              for f in ref_s.it._fields]
    fields += [("mu", got_s.mu, ref_s.mu, oth_s.mu), ("alpha", got_s.alpha, ref_s.alpha,
                                                      oth_s.alpha)]
    sgate = split_field_gate(fields, f32, skip=flips)
    mgate = split_field_gate([(f, getattr(got_m, f), getattr(ref_m, f), getattr(oth_m, f))
                              for f in ref_m._fields], f32)
    n_flips = int(flips.sum())
    return {"ok": cgate["ok"] and sgate["ok"] and mgate["ok"] and n_flips <= allowed,
            "condense": cgate, "step": sgate, "merit": mgate, "flips": n_flips,
            "plain_flips": plain_flips, "allowed": allowed,
            "B": int(problems.initial_state.shape[0]), "dtype": str(dtype)[6:],
            "launched": (problems, it, mu, corr, ref_c, sol)}


def describe_split_check(res):
    c, s, m = res["condense"], res["step"], res["merit"]
    return (f"condensation max|kernel-plain| {c['err']:.3e}, nearest its limit {c['worst']} "
            f"at {c['fields'][c['worst']]['ratio']:.3f} of it; step: accepted candidate differs "
            f"on {res['flips']} of {res['B']} (allowed {res['allowed']}: the plain version's "
            f"own f32-vs-f64 flips {res['plain_flips']}), elsewhere max|kernel-plain| "
            f"{s['err']:.3e}, nearest its limit {s['worst']} at "
            f"{s['fields'][s['worst']]['ratio']:.3f} of it; merits and rho: max|kernel-plain| "
            f"{m['err']:.3e}, nearest its limit {m['worst']} at "
            f"{m['fields'][m['worst']]['ratio']:.3f} of it; "
            f"{'passes' if res['ok'] else 'FAILS'}")


def init_gate(cfg, problems, lib, stream):
    """The init kernel, launched through ``lib`` on ``stream`` by the
    wrapper's card path (`ops/ipm_split.py::_init`), on the warm start of
    ``problems`` against `ipm.init_plain`: the new iterate's slacks, duals,
    e_ob, reg, sigma and the first mu, each field of each scenario by
    `split_field_gate`.  Returns the gate, with the kernel's mu ("mu")."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.solver import ipm

    problems = ipm._contiguous(problems)
    f32 = problems.initial_state.dtype == torch.float32
    other = torch.float64 if f32 else torch.float32
    with torch.no_grad():
        got_it, got_mu = ipm_split._init(lib, stream, cfg, problems)
        ref_it, ref_mu = ipm.init_plain(cfg, problems)
        oth_it, oth_mu = ipm.init_plain(cfg, _cast(problems, other))
    fields = [(f, getattr(got_it, f), getattr(ref_it, f), getattr(oth_it, f))
              for f in ref_it._fields[2:]]
    return {**split_field_gate(fields + [("mu", got_mu, ref_mu, oth_mu)], f32), "mu": got_mu}


def once_kernels_check(cfg, problems, iterations, lib, stream):
    """The split solve's init and diagnostics kernels, launched through
    ``lib`` on ``stream`` by the wrapper's card path
    (`ops/ipm_split.py::_init`, `_diagnostics`; a CPU build of the source
    runs them on CPU tensors), against their plain versions
    (`ipm.init_plain`, `ipm.diagnostics_plain`):

    - init on the warm start: the new iterate's slacks, duals, e_ob, reg,
      sigma and the first mu, each field of each scenario by
      `split_field_gate` (float32: 1e-4 of its scale plus twice the plain
      version's own f32-vs-f64 gap; float64: 1e-9 of its scale);
    - diagnostics on the iterate after ``iterations`` plain iterations:
      ``converged`` differs on at most `allowed_flips` scenarios, twice its
      witness's flips (`ulp_witness`: the plain version on the CPU, and
      with the initial state moved one ulp either way, against the plain
      version where the kernel ran, in the kernel's dtype), and the
      stationarity, feasibility, complementarity, final cost and final mu
      of every scenario meet the same gate.

    Returns {"ok", "init", "diagnostics", "flips", "plain_flips", "allowed",
    "B", "dtype"}, the inputs of the launches ("launched": the problems
    and the last iterate) and the diagnostics kernel's output ("got")."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.solver import ipm

    problems = ipm._contiguous(problems)
    dtype = problems.initial_state.dtype
    f32 = dtype == torch.float32
    other = torch.float64 if f32 else torch.float32
    igate = init_gate(cfg, problems, lib, stream)
    with torch.no_grad():
        it, _ = split_iterate(cfg, problems, iterations)
        got_d = ipm_split._diagnostics(lib, stream, cfg, problems, it)
        ref_d = ipm.diagnostics_plain(cfg, problems, it)
        oth_d = ipm.diagnostics_plain(cfg, _cast(problems, other), _cast(it, other))
        plain_flips = ulp_witness(
            lambda cpu, x0: ipm.diagnostics_plain(cfg, on_cpu(problems), on_cpu(it)) if cpu
            else ipm.diagnostics_plain(cfg, problems._replace(initial_state=x0), it),
            problems.initial_state,
            lambda d: d.converged.to(ref_d.converged.device) != ref_d.converged)
    B = int(problems.initial_state.shape[0])
    flips = int((got_d.converged != ref_d.converged).sum())
    allowed = allowed_flips(plain_flips, B)
    dgate = split_field_gate([(f, getattr(got_d, f), getattr(ref_d, f), getattr(oth_d, f))
                              for f in ref_d._fields[1:]], f32)
    return {"ok": igate["ok"] and dgate["ok"] and flips <= allowed, "init": igate,
            "diagnostics": dgate, "flips": flips, "plain_flips": plain_flips,
            "allowed": allowed, "B": B, "dtype": str(dtype)[6:], "launched": (problems, it),
            "got": got_d}


def describe_once_check(res):
    i, d = res["init"], res["diagnostics"]
    return (f"init max|kernel-plain| {i['err']:.3e}, nearest its limit {i['worst']} at "
            f"{i['fields'][i['worst']]['ratio']:.3f} of it; diagnostics: converged differs on "
            f"{res['flips']} of {res['B']} (allowed {res['allowed']}: the plain version's own "
            f"flips an ulp away {res['plain_flips']}), max|kernel-plain| {d['err']:.3e}, nearest "
            f"its limit {d['worst']} at {d['fields'][d['worst']]['ratio']:.3f} of it; "
            f"{'passes' if res['ok'] else 'FAILS'}")


def build_inputs(cfg, batch, seed, *, k_all=None, shared=False, warm=True, n_dynamic=2,
                 tie=None, dtype=None, device="cuda"):
    """Inputs of `problem_with_obstacles` from a numpy seed: starts and goals
    (`scenarios.sample_endpoints`), ``k_all`` circles per scenario
    straddling the start-goal segment (`scenarios.sample_obstacle_field`,
    ``n_dynamic`` of them moving, some turning), about one slot in eight
    inactive, one set shared by every scenario (a stride-0 ``expand``, as
    `agent.build_problem` passes it) with ``shared``, and with ``warm`` a
    warm start along the straight segment through the circles (which the
    repair pushes out and the completion rolls out) and random controls.
    With ``tie`` obstacle 1 of every scenario takes obstacle 0's position
    and radius ("keys": the sensor's keys tie, the tracks differ) or every
    leaf ("caps": the rollout's speed caps tie too).  Returns
    (initial_state, goal_state, obstacles, keywords)."""
    import torch

    from kissmpc_tpu_torch.obstacles.obstacles import ObstacleSet
    from kissmpc_tpu_torch.scenarios import sample_endpoints, sample_obstacle_field

    dtype = dtype or torch.float32
    N = cfg.horizon
    k_all = cfg.max_obstacles if k_all is None else k_all
    rng = np.random.default_rng(seed)
    starts, goals = sample_endpoints(cfg, batch, rng)
    centers, radii, orient, v = sample_obstacle_field(starts, goals, k_all, rng,
                                                      n_dynamic=min(n_dynamic, k_all),
                                                      inflation=0.25)
    turn = rng.normal(0.0, 0.3, (batch, k_all)) * (v > 0)
    active = (rng.uniform(size=(batch, k_all)) > 0.125).astype(np.float32)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    leaves = [t(centers), t(radii), t(orient), t(v), t(turn), t(active)]
    if tie not in (None, "keys", "caps"):
        raise ValueError(f"unknown tie {tie!r}")
    for i, x in enumerate(leaves if tie else ()):
        if tie == "caps" or i < 2:  # position and radius; or every leaf
            x[:, 1] = x[:, 0]
    if shared:
        leaves = [x[0].expand((batch,) + x.shape[1:]) for x in leaves]
    kw = dict(sensor_radius=2.5, prediction_dt=cfg.time_step, inflation_radius=0.25,
              dtype=dtype, device=device)
    if warm:
        s = np.linspace(0.0, 1.0, N + 1)[None, :, None]
        path = starts[:, None, :] + s * (goals - starts)[:, None, :]
        path[:, :, 2] = np.arctan2(goals[:, 1] - starts[:, 1], goals[:, 0] - starts[:, 0])[:, None]
        kw.update(warm_states=t(path), warm_controls=t(rng.uniform(-0.2, 0.4, (batch, N, 2))))
    return t(starts), t(goals), ObstacleSet(*leaves), kw


def build_kernel_check(cfg, inputs, lib, stream, **options):
    """The build kernel, launched through ``lib`` on ``stream`` by the
    wrapper's card path (`ops/problem_build.py::_launch`; a CPU build of
    the source runs it on CPU tensors), against `build_plain` on the same
    ``inputs`` (`build_inputs`' tuple; ``options`` add keywords such as
    the repair and completion switches).  Every field of the Problem is
    held per scenario by `split_field_gate`'s rule (float32: 1e-4 of its
    scale plus twice the plain version's own f32-vs-f64 gap; float64: 1e-9
    of its scale).  A scenario outside it counts as a flip, a discrete
    decision taken the other way (the sensor's order, the repair's deepest
    obstacle, the roll, a blocked step and its obstacle): flips at most
    `allowed_flips`, twice its witness's (`ulp_witness`: the scenarios the
    same gate takes out when the plain version runs on the CPU, or with
    the start moved one ulp either way, in the kernel's dtype).  Returns
    {"ok", "gate", "flips", "plain_flips", "allowed", "rolled", "B",
    "dtype", "launched"}."""
    import torch

    from kissmpc_tpu_torch.ops import problem_build

    start, goal, obstacles, kw = inputs
    kw = {**kw, **options}
    dtype = kw["dtype"]
    f32 = dtype == torch.float32
    other = torch.float64 if f32 else torch.float32
    with torch.no_grad():
        got = problem_build._launch(lib, stream, cfg, start, goal, obstacles, **kw)
        ref = problem_build.build_plain(cfg, start, goal, obstacles, **kw)
        cast = {k: _cast(v, other) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        oth = problem_build.build_plain(cfg, _cast(start, other), _cast(goal, other),
                                        _cast(obstacles, other), **{**cast, "dtype": other})
    fields = [(f, getattr(got, f), getattr(ref, f), getattr(oth, f)) for f in ref._fields]

    def outside(problem):
        return torch.stack([_field_ratio(getattr(problem, f), r, o, f32)[1].to(r.device)
                            for f, _, r, o in fields]).amax(0) > 1.0

    def evaluate(cpu, x0):
        with torch.no_grad():
            if cpu:
                return problem_build.build_plain(cfg, on_cpu(start), on_cpu(goal),
                                                 on_cpu(obstacles), **on_cpu(kw))
            return problem_build.build_plain(cfg, x0, goal, obstacles, **kw)

    flips = outside(got)
    plain_flips = ulp_witness(evaluate, start, outside)
    B = int(ref.initial_state.shape[0])
    allowed = allowed_flips(plain_flips, B)
    gate = split_field_gate(fields, f32, skip=flips)
    warm = kw.get("warm_controls")
    warm = torch.zeros_like(ref.warm_controls) if warm is None else warm.to(ref.warm_controls)
    rolled = int((ref.warm_controls != warm).flatten(1).any(1).sum())
    return {"ok": gate["ok"] and int(flips.sum()) <= allowed, "gate": gate,
            "flips": int(flips.sum()), "plain_flips": plain_flips, "allowed": allowed,
            "rolled": rolled, "B": B, "dtype": str(dtype)[6:],
            "launched": (start, goal, obstacles, kw)}


def describe_build_check(res):
    g = res["gate"]
    return (f"scenarios outside the gate {res['flips']} of {res['B']} (allowed "
            f"{res['allowed']}: the plain version's own flips an ulp away "
            f"{res['plain_flips']}), "
            f"{res['rolled']} rolled out by the plain version; elsewhere max|kernel-plain| {g['err']:.3e}, nearest its limit "
            f"{g['worst']} at {g['fields'][g['worst']]['ratio']:.3f} of it; "
            f"{'passes' if res['ok'] else 'FAILS'}")


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


def split_bytes(cfg, batch, dtype, kernel):
    """Bytes the split ``kernel`` ("condense" or "step") must move for
    ``batch`` scenarios of ``cfg``: every input it reads once, every output
    written once.  The condensation reads the problem, the iterate's
    trajectory, slacks, duals (and e in elastic mode), reg, mu and the
    correction rows, and writes the eight LQRData tensors; the step reads
    the problem, the whole iterate, mu, the condensed qx and A, dx, du and
    the correction rows, and writes the new iterate, the next mu and the
    step length."""
    import torch

    N, K = cfg.horizon, cfg.max_obstacles
    elastic = cfg.solver.elastic_obstacles and K > 0
    size = 4 if dtype == torch.float32 else 8
    t1 = N + 1
    problem = 16 + 2 * K * N + 2 * K + 1
    rows = 4 * N + 6 * t1 + N * K  # one slack (or dual) of every element
    iterate = 3 * t1 + 2 * N + 2 * rows + N * K + 2  # with e, reg, sigma
    corr = rows if cfg.solver.mehrotra != "off" else 0
    lqr = 24 * N + 3 + 12 * t1
    if kernel == "condense":
        reads = problem + iterate - 1 - (0 if elastic else N * K) + 1 + corr
        writes = lqr
    else:
        reads = problem + iterate + 1 + 6 * t1 + 11 * N + corr
        writes = iterate + 2
    return size * batch * (reads + writes)


def split_ops(cfg, batch, kernel):
    """Operations of the split ``kernel`` for ``batch`` scenarios of
    ``cfg`` that the function needs, roughly: each add, multiply,
    compare-and-select, min, max, abs, division, sqrt, sin, cos and log
    one, an FMA two.  Condensation per stage: 96 (state row: cost, two box
    families, Hessian diagonal), 80 (control row: cost, two box families,
    linearisation with sin and cos, defect), 60 per obstacle (its geometry,
    gradient coefficient, Gauss-Newton and curvature terms; +15 elastic).
    Step: each element's step once (12 per box element, 25 per obstacle
    element, +30 elastic), the fractions to the boundary (10 per element),
    per candidate 10 per box element, 38 per obstacle element and 45 per
    stage (trial point, cost, defect with sin and cos), the update and
    complementarity (17 per element), and the adjoint sweep (21 per
    stage)."""
    N, K = cfg.horizon, cfg.max_obstacles
    elastic = cfg.solver.elastic_obstacles and K > 0
    box, obst = 4 * N + 6 * (N + 1), N * K
    if kernel == "condense":
        per = 96 * (N + 1) + 80 * N + (60 + (15 if elastic else 0)) * obst
    else:
        cand = 1 + cfg.solver.ls_iters
        step = 12 * box + (25 + (30 if elastic else 0)) * obst
        per = (step + 10 * (box + obst) + cand * (10 * box + 38 * obst + 45 * (N + 1))
               + 17 * (box + obst) + 21 * N)
    return per * batch


def split_bound(cfg, batch, dtype, kernel):
    """(bound ms, "bytes" or "operations", bytes, operations).  Both
    instances do their arithmetic in double (csrc/ipm_split.cu's Compute),
    so the operations go at the float64 peak."""
    n_bytes, ops = split_bytes(cfg, batch, dtype, kernel), split_ops(cfg, batch, kernel)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F64_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, ops


def node_config():
    """The node's configuration: `io.Model`'s defaults with 4 obstacle slots."""
    from kissmpc_tpu_torch import MPCConfig

    return MPCConfig(horizon=7, time_step=0.8, max_obstacles=4)


def phase_split_kernels(split_cfgs, pools):
    """Phase 17: the split iteration's two kernels against their plain
    halves on the card (`split_kernels_check`), on the iterate after
    SPLIT_CHECK_ITERATIONS plain iterations: k8_dyn2 at B=8192 and at the
    last refine stage's 164 in float32 and float64, k8_dyn2_elastic and
    free at B=8192, Mehrotra "pc" at 164, the node (N=7, B=1), and k8_dyn2
    float32 at the other refine batches, 1024 and 328; each kernel timed by
    `kernel_ms` (launches captured in a CUDA graph) beside its bound and
    its plain half, the step with its layout (`ipm_split.step_occupancy`).
    Returns the two kernels' rows of the ``kernels`` line (k8_dyn2, f32,
    B=8192), launches filled in later."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver import ipm
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    lib = ipm_split._library()
    k8 = split_cfgs["k8_dyn2"]
    node = node_config()
    pc = k8.replace(solver=dataclasses.replace(k8.solver, mehrotra="pc"))
    cases = [("k8_dyn2", k8, "k8_dyn2", BATCH, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", REFINE_CHECK_BATCH, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", BATCH, torch.float64),
             ("k8_dyn2", k8, "k8_dyn2", REFINE_CHECK_BATCH, torch.float64),
             ("k8_dyn2_elastic", split_cfgs["k8_dyn2_elastic"], "k8_dyn2", BATCH, torch.float32),
             ("free", split_cfgs["free"], "free", BATCH, torch.float32),
             ("k8_dyn2 pc", pc, "k8_dyn2", REFINE_CHECK_BATCH, torch.float32),
             ("node", node, None, 1, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", 1024, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", 328, torch.float32)]
    rows = []
    for label, cfg, pool, B, dtype in cases:
        if pool is None:
            problems = obstacle_problems(cfg, B, seed=12, n_dynamic=2)
        else:
            problems = gather(pools[pool], torch.arange(B, device="cuda"))
        problems = Problem(*(x.to(dtype) for x in problems))
        res = split_kernels_check(cfg, problems, SPLIT_CHECK_ITERATIONS, lib,
                                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        log(f"[17] split kernels, {label} {res['dtype']} B={B} N={cfg.horizon}: "
            f"{describe_split_check(res)}")
        if not res["ok"]:
            fail(f"the split kernels disagree with their plain halves ({label}, {res['dtype']}, "
                 f"B={B})")
        pr, it, mu, corr, data, sol = res["launched"]
        occ = ipm_split.step_occupancy(cfg, B, dtype, corr=corr is not None)
        log(f"[17] step kernel, {label} {res['dtype']} B={B}: {occ['warps_per_scenario']} warps "
            f"per scenario, {occ['smem_bytes_per_block']} bytes of dynamic shared memory per "
            f"block{' (arena in global scratch)' if occ['global_arena'] else ''}, "
            f"{occ['registers']} registers, {occ['local_bytes']} local bytes per thread, "
            f"{occ['scenarios_per_sm']} scenarios resident per SM")
        row = {"case": label, "dtype": res["dtype"], "B": B, "N": cfg.horizon,
               "flips": res["flips"], "allowed_flips": res["allowed"],
               "merit_err": res["merit"]["err"], "step_layout": occ}
        # The stream is read at each call: kernel_ms captures the calls on
        # a stream of its own.
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for kernel, fn, plain in (
                ("condense", lambda: ipm_split._condense(lib, stream(), cfg, pr, it, mu, corr),
                 lambda: ipm.condense_plain(cfg, pr, it, mu, corr)),
                ("step", lambda: ipm_split._step(lib, stream(), cfg, pr, it, mu, data, sol, corr),
                 lambda: ipm.step_plain(cfg, pr, it, mu, data, sol, corr))):
            ms = kernel_ms(fn, reps=20, graph=True)
            plain_ms = kernel_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by, n_bytes, ops = split_bound(cfg, B, dtype, kernel)
            row[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "bytes": n_bytes, "ops": ops,
                           "max_abs_err": res["condense" if kernel == "condense" else "step"]["err"]}
            log(f"[17] {kernel} kernel, {label} {res['dtype']} B={B}: {ms:.5f} ms, "
                f"{ms / bound_ms:.2f}x its bound {bound_ms:.5f} ms ({n_bytes} bytes, {ops} "
                f"operations; {bound_by}); plain half {plain_ms:.4f} ms")
        rows.append(row)
    main = rows[0]

    def entry(kernel, name, replaces, what):
        m = main[kernel]
        return {"name": name, "route": "cuda", "source": "kissmpc_tpu_torch/csrc/ipm_split.cu",
                "replaces": replaces, "tpu_kernel": None,
                "replaces_note": f"no TPU kernel: XLA's fusion of {what} under the reference's "
                                 f"jax.jit",
                "launches": None, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None,
                "cases": [{k: r[k] for k in ("case", "dtype", "B", "N", "flips")} | r[kernel]
                          for r in rows]}

    return [entry("condense", "ipm_split_condense", "kissmpc_tpu/solver/ipm.py:328",
                  "_build_lqr"),
            entry("step", "ipm_split_step", "kissmpc_tpu/solver/ipm.py:407",
                  "the rest of _iteration")]


def pool_inputs(cfg, batch, seed, dtype):
    """The inputs `scenarios.obstacle_problems` hands `problem_with_obstacles`
    for its pool of ``batch`` scenarios from ``seed`` (two moving circles of
    K straddling each start-goal segment, the start tiled as warm start),
    in `build_inputs`' form."""
    import torch

    from kissmpc_tpu_torch.obstacles.obstacles import ObstacleSet
    from kissmpc_tpu_torch.scenarios import (DEFAULT_INFLATION, sample_endpoints,
                                             sample_obstacle_field)

    rng = np.random.default_rng(seed)
    starts, goals = sample_endpoints(cfg, batch, rng)
    centers, radii, orient, v = sample_obstacle_field(starts, goals, cfg.max_obstacles, rng,
                                                      n_dynamic=2, inflation=DEFAULT_INFLATION)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")  # noqa: E731
    K = cfg.max_obstacles
    obs = ObstacleSet(t(centers), t(radii), t(orient), t(v),
                      torch.zeros((batch, K), dtype=dtype, device="cuda"),
                      torch.ones((batch, K), dtype=dtype, device="cuda"))
    kw = dict(sensor_radius=5.0, prediction_dt=cfg.time_step, inflation_radius=DEFAULT_INFLATION,
              dtype=dtype, device="cuda")
    return t(starts), t(goals), obs, kw


def fleet_inputs(dtype):
    """The first tick's inputs of the fleet loop's problem build (phase 7's
    configuration and worlds, `agent.build_problem`'s keywords), in
    `build_inputs`' form; (cfg, inputs)."""
    from kissmpc_tpu_torch.agent import current_state

    cfg, params = fleet_config()
    env, obstacles, _ = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda")
    agent = env.agent
    kw = dict(sensor_radius=params.sensor_radius, prediction_dt=params.prediction_dt,
              control_bounds=params.control_bounds, state_bounds=params.state_bounds,
              inflation_radius=params.inflation_radius,
              warm_states=agent.states_matrix.to(dtype),
              warm_controls=agent.controls_matrix.to(dtype),
              complete_warm_start_states=params.complete_warm_starts, dtype=dtype, device="cuda")
    return cfg, (current_state(agent).to(dtype), agent.goal_state.to(dtype),
                 _cast(obstacles, dtype), kw)


def perception_inputs(dtype):
    """The problem build's inputs at the perception tick's first tick
    (phase 11's configuration and worlds, B=PERCEPTION_BATCH), in
    `build_inputs`' form: the agents' plans and the static circles, which
    the solver-only tick hands `agent.build_problem` as they are and the
    perception tick with TRACK_CAPACITY tracked slots joined; (cfg,
    inputs)."""
    from kissmpc_tpu_torch.agent import current_state
    from kissmpc_tpu_torch.scenarios import episode_worlds

    cfg, params = perception_config()
    env, static = episode_worlds(cfg, PERCEPTION_BATCH, n_waypoints=2, seed=0, n_dynamic=0,
                                 route_around_obstacles=True, router="grid", device="cuda")
    agent = env.agent
    kw = dict(sensor_radius=params.sensor_radius, prediction_dt=params.prediction_dt,
              control_bounds=params.control_bounds, state_bounds=params.state_bounds,
              inflation_radius=params.inflation_radius,
              warm_states=agent.states_matrix.to(dtype),
              warm_controls=agent.controls_matrix.to(dtype),
              complete_warm_start_states=params.complete_warm_starts, dtype=dtype, device="cuda")
    return cfg, (current_state(agent).to(dtype), agent.goal_state.to(dtype),
                 _cast(static, dtype), kw)


def build_bound(cfg, inputs, rolled, dtype):
    """(bound ms, "bytes" or "operations", bytes, operations) of one build of
    ``inputs`` (`build_inputs`' form) in which ``rolled`` scenarios are
    rolled out.  Bytes: the start, the goal, the warm start (if given) and
    the obstacle set read once (a set shared by every scenario once in
    all), the Problem written once.  Operations per scenario, roughly (an
    add, multiply, compare-and-select, min, max, abs, division, sqrt, sin,
    cos or atan2 one, an FMA two): the sensor's distances (9 per obstacle)
    and a sort's compares (K_all log2 K_all), the tracks (8 per obstacle
    and stage), each repair pass (12 per obstacle and stage, 45 per
    stage), the moved test (2 per warm-start value) and, in rolled
    scenarios only, the rollout (45 per stage, 22 per obstacle and
    stage).  The kernel computes in double: the float64 peak."""
    import math

    import torch

    start, _, obstacles, kw = inputs
    B, N, K = start.shape[0], cfg.horizon, cfg.max_obstacles
    k_all = obstacles.position.shape[-2]
    size = 4 if dtype == torch.float32 else 8
    t1 = N + 1
    shared = obstacles.radius.stride(0) == 0 and B > 1
    reads = B * (6 + (3 * t1 + 2 * N if kw.get("warm_states") is not None else 0))
    reads += 7 * k_all * (1 if shared else B)
    writes = B * (16 + 2 * K * N + 2 * K + 1 + 3 * t1 + 2 * N)
    n_bytes = size * (reads + writes)
    repair = kw.get("repair_warm_start_states", True) and K > 0
    ops = B * (9 * k_all + k_all * max(1, math.ceil(math.log2(max(k_all, 2))))
               + 8 * K * N + (3 * N * (12 * K + 45) if repair else 0) + 6 * t1)
    ops += rolled * N * (45 + 22 * K)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F64_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, ops


def once_bound(cfg, batch, dtype, kernel):
    """(bound ms, "bytes" or "operations", bytes, operations) of the init or
    diagnostics ``kernel`` for ``batch`` scenarios of ``cfg``.  Bytes: the
    init reads the bounds, the obstacles, the inflation and the warm
    start, and writes the slacks, duals, e_ob, reg, sigma and mu; the
    diagnostics read the problem, the trajectory, the slacks, duals and
    sigma, and write the six diagnostics (converged one byte).  Operations,
    roughly (as `split_ops` counts them): the init 6 per box element and 15
    per obstacle element (its geometry); the diagnostics 12 per box
    element, 27 per obstacle element (geometry, normal, gradient), and per
    stage 18 (goal cost and gradient), 14 (control cost and gradient), 8
    (linearisation with sin and cos), 9 (defect) and 21 (the adjoint
    step).  Both compute in double: the float64 peak."""
    import torch

    N, K = cfg.horizon, cfg.max_obstacles
    size = 4 if dtype == torch.float32 else 8
    t1 = N + 1
    box, obst = 4 * N + 6 * t1, N * K
    traj = 3 * t1 + 2 * N
    if kernel == "init":
        n_bytes = size * batch * (10 + 2 * K * N + 2 * K + 1 + traj + 2 * (box + obst) + obst + 3)
        ops = batch * (6 * box + 15 * obst)
    else:
        n_bytes = size * batch * (16 + 2 * K * N + 2 * K + 1 + traj + 2 * (box + obst) + 1 + 5)
        n_bytes += batch
        ops = batch * (12 * box + 27 * obst + t1 * 18 + N * (14 + 8 + 9 + 21))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F64_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, ops


def phase_build_once(split_cfgs, pools):
    """Phase 18: the problem build kernel against `build_plain`
    (`build_kernel_check`) on the pool's inputs (K=8, N=50, B=POOL), the
    fleet loop's first tick (B=4096), the perception tick's (B=2048), the
    node's (N=7, B=1, 6 obstacles for 4 slots, a warm start through them)
    and NODE_BUILD_BATCH node-shaped scenarios (where one discrete flip is
    not the whole batch), each with its launch shape and residency; the
    init and diagnostics
    kernels against `ipm.init_plain` and `ipm.diagnostics_plain`
    (`once_kernels_check`, the diagnostics on the iterate after
    SPLIT_CHECK_ITERATIONS plain iterations) at k8_dyn2's B=8192 and the
    refine stages' 1024, 328 and 164, k8_dyn2_elastic and mehrotra "pc",
    the node and NODE_BUILD_BATCH node-shaped problems; float32 and float64.  Each kernel timed by `kernel_ms`
    (20 launches in a CUDA graph) beside its bound and its plain version.
    Returns the three kernels' rows of the ``kernels`` line, launches
    filled in later."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split, problem_build
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver import ipm
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    # The stream is read at each call: kernel_ms captures the calls on a
    # stream of its own.
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    k8, node = split_cfgs["k8_dyn2"], node_config()
    blib, slib = problem_build._library(), ipm_split._library()
    build_rows = []
    for label, dtype in (("pool", torch.float32), ("pool", torch.float64),
                         ("fleet", torch.float32), ("fleet", torch.float64),
                         ("perception", torch.float32), ("perception", torch.float64),
                         ("node", torch.float32), ("node", torch.float64),
                         ("node batch", torch.float32), ("node batch", torch.float64)):
        options = {}
        if label == "pool":
            cfg, inputs = k8, pool_inputs(k8, POOL, 0, dtype)
        elif label == "fleet":
            cfg, inputs = fleet_inputs(dtype)
        elif label == "perception":
            cfg, inputs = perception_inputs(dtype)
        else:
            cfg = node
            batch = 1 if label == "node" else NODE_BUILD_BATCH
            inputs = build_inputs(node, batch, 18, k_all=NODE_BUILD_K_ALL, dtype=dtype)
            options = dict(sensor_radius=5.0, prediction_dt=None)
        res = build_kernel_check(cfg, inputs, blib, stream(), **options)
        torch.cuda.synchronize()
        B, k_all = res["B"], inputs[2].position.shape[-2]
        occ = problem_build.occupancy(cfg, k_all, B, dtype)
        log(f"[18] build kernel, {label} {res['dtype']} B={B} N={cfg.horizon} K={cfg.max_obstacles}"
            f" K_all={k_all}: {describe_build_check(res)}; {occ['registers']} registers, "
            f"{occ['local_bytes']} local bytes per thread, {occ['scenarios_per_block']} scenarios "
            f"and {occ['smem_bytes_per_block']} shared bytes per block"
            f"{' (rows in global scratch)' if occ['global_rows'] else ''}, "
            f"{occ['scenarios_per_sm']} scenarios resident per SM")
        if not res["ok"]:
            fail(f"the build kernel disagrees with build_plain ({label}, {res['dtype']}, B={B})")
        start, goal, obstacles, kw = res["launched"]
        ms = kernel_ms(lambda: problem_build._launch(blib, stream(), cfg, start, goal, obstacles,
                                                     **kw), reps=20, graph=True)
        plain_ms = kernel_ms(lambda: problem_build.build_plain(cfg, start, goal, obstacles, **kw),
                             reps=3, warmup=1)
        bound_ms, bound_by, n_bytes, ops = build_bound(cfg, inputs, res["rolled"], dtype)
        build_rows.append({"case": label, "dtype": res["dtype"], "B": B, "N": cfg.horizon,
                           "K_all": k_all, "occupancy": occ,
                           "flips": res["flips"], "witness_flips": res["plain_flips"],
                           "allowed_flips": res["allowed"],
                           "rolled": res["rolled"], "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
                           "ops": ops, "max_abs_err": res["gate"]["err"]})
        log(f"[18] build kernel, {label} {res['dtype']} B={B}: {ms:.5f} ms, "
            f"{ms / bound_ms:.2f}x its bound {bound_ms:.5f} ms ({n_bytes} bytes, {ops} "
            f"operations; {bound_by}); plain version {plain_ms:.4f} ms")

    pc = k8.replace(solver=dataclasses.replace(k8.solver, mehrotra="pc"))
    cases = [("k8_dyn2", k8, "k8_dyn2", BATCH, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", 1024, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", 328, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", REFINE_CHECK_BATCH, torch.float32),
             ("k8_dyn2", k8, "k8_dyn2", BATCH, torch.float64),
             ("k8_dyn2", k8, "k8_dyn2", REFINE_CHECK_BATCH, torch.float64),
             ("k8_dyn2_elastic", split_cfgs["k8_dyn2_elastic"], "k8_dyn2", BATCH, torch.float32),
             ("k8_dyn2 pc", pc, "k8_dyn2", REFINE_CHECK_BATCH, torch.float32),
             ("node", node, None, 1, torch.float32),
             ("node", node, None, 1, torch.float64),
             ("node batch", node, None, NODE_BUILD_BATCH, torch.float32),
             ("node batch", node, None, NODE_BUILD_BATCH, torch.float64)]
    once_rows = []
    for label, cfg, pool, B, dtype in cases:
        if pool is None:
            problems = obstacle_problems(cfg, B, seed=12, n_dynamic=2)
        else:
            problems = gather(pools[pool], torch.arange(B, device="cuda"))
        problems = Problem(*(x.to(dtype) for x in problems))
        res = once_kernels_check(cfg, problems, SPLIT_CHECK_ITERATIONS, slib, stream())
        torch.cuda.synchronize()
        log(f"[18] init and diagnostics kernels, {label} {res['dtype']} B={B} N={cfg.horizon}: "
            f"{describe_once_check(res)}")
        if not res["ok"]:
            fail(f"the init or diagnostics kernel disagrees with its plain version ({label}, "
                 f"{res['dtype']}, B={B})")
        pr, it = res["launched"]
        row = {"case": label, "dtype": res["dtype"], "B": B, "N": cfg.horizon,
               "flips": res["flips"], "witness_flips": res["plain_flips"],
               "allowed_flips": res["allowed"]}
        for kernel, fn, plain in (
                ("init", lambda: ipm_split._init(slib, stream(), cfg, pr),
                 lambda: ipm.init_plain(cfg, pr)),
                ("diagnostics", lambda: ipm_split._diagnostics(slib, stream(), cfg, pr, it),
                 lambda: ipm.diagnostics_plain(cfg, pr, it))):
            ms = kernel_ms(fn, reps=20, graph=True)
            plain_ms = kernel_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by, n_bytes, ops = once_bound(cfg, B, dtype, kernel)
            row[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "bytes": n_bytes, "ops": ops,
                           "max_abs_err": res["init" if kernel == "init" else "diagnostics"]["err"]}
            shape = ""
            if kernel == "diagnostics":
                occ = row[kernel]["occupancy"] = ipm_split.diagnostics_occupancy(cfg, B, dtype)
                shape = (f"; {occ['chunk_stages']} stages per chunk, {occ['registers']} registers, "
                         f"{occ['local_bytes']} local bytes per thread, "
                         f"{occ['smem_bytes_per_block']} shared bytes per block, "
                         f"{occ['scenarios_per_sm']} scenarios resident per SM")
            log(f"[18] {kernel} kernel, {label} {res['dtype']} B={B}: {ms:.5f} ms, "
                f"{ms / bound_ms:.2f}x its bound {bound_ms:.5f} ms ({n_bytes} bytes, {ops} "
                f"operations; {bound_by}); plain version {plain_ms:.4f} ms{shape}")
        once_rows.append(row)

    main = build_rows[0]
    build = {"name": "problem_build", "route": "cuda",
             "source": "kissmpc_tpu_torch/csrc/problem_build.cu",
             "replaces": "kissmpc_tpu/solver/problem.py:278", "tpu_kernel": None,
             "replaces_note": "no TPU kernel: XLA's fusion of problem_with_obstacles under the "
                              "reference's jax.jit",
             "launches": None, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None, "cases": build_rows}

    def entry(kernel, name, replaces, what):
        m = once_rows[0][kernel]
        return {"name": name, "route": "cuda", "source": "kissmpc_tpu_torch/csrc/ipm_split.cu",
                "replaces": replaces, "tpu_kernel": None,
                "replaces_note": f"no TPU kernel: XLA's fusion of {what} under the reference's "
                                 f"jax.jit",
                "launches": None, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None,
                "cases": [{k: r[k] for k in ("case", "dtype", "B", "N", "flips", "witness_flips",
                                             "allowed_flips")} | r[kernel]
                          for r in once_rows]}

    return [build,
            entry("init", "ipm_split_init", "kissmpc_tpu/solver/ipm.py:180",
                  "_init_state and the first _adaptive_mu"),
            entry("diagnostics", "ipm_split_diagnostics", "kissmpc_tpu/solver/ipm.py:715",
                  "_adaptive_mu and _diagnostics")]


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
    """`make_batch_solver` (one CUDA graph per configuration) and the eager
    `solve_batch` on the same batches, in turns: the program once under
    the sync debug mode with a warm-up batch, then the first captured call
    (warm-up and capture) on it, then ``calls`` batches, each solved
    eagerly and by a replay, timed, bitwise equal, with the launch counts of
    four kernels (fused; Riccati, split condensation and split step) read
    around every call; then one replay under the profiler, whose trace
    shows the counted kernels.  The counts are set to 0 before the first
    configuration and read after the last."""
    import torch

    from kissmpc_tpu_torch import make_batch_solver, solve_batch
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.solver.problem import gather

    rng = np.random.default_rng(0)
    results = {}
    zero_counts()
    for name, cfg in cfgs.items():
        pool = pools[name]
        stages = len(cfg.solver.refine_stages)
        if backend == "fused":
            expected = expect(fused=1 + stages)
        else:
            its = cfg.solver.iterations + sum(it for _, it, _ in cfg.solver.refine_stages)
            expected = split_solve_launches(its, solves=1 + stages)
        solver = make_batch_solver(cfg)

        def call(fn, batch, what):
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            sol = fn(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = moved(before)
            if launched != expected:
                fail(f"{backend} {name} {what}: launches {launched}, expected {expected}")
            if sol.controls.shape != (BATCH, N, 2) or sol.states.shape != (BATCH, N + 1, 3):
                fail(f"{name}: solution shapes {sol.states.shape} {sol.controls.shape}")
            if not (torch.isfinite(sol.controls).all() and torch.isfinite(sol.states).all()):
                fail(f"{name}: non-finite solution")
            return sol, ms

        def same(a, b):
            return all(bitwise_equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))

        eager_ms, replay_ms, conv, usable = [], [], [], []
        for i in range(1 + calls):
            idx = torch.as_tensor(rng.permutation(POOL)[:BATCH], device="cuda")
            batch = gather(pool, idx)
            if i == 0:  # the warm-up batch
                with sync_checked_programs() as ran:
                    ref, ms = call(solver, batch, "sync-checked")
                if ran != ["make_batch_solver"]:
                    fail(f"the sync-checked make_batch_solver ran the programs {ran}")
                sol, first_ms = call(solver, batch, "first call")
                log(f"[5] {backend} {name}: the program (eager, {ms:.3f} ms) ran under "
                    f"set_sync_debug_mode('error'); first captured call (warm-up and "
                    f"capture) {first_ms:.3f} ms")
            else:
                ref, ms = call(lambda b: solve_batch(cfg, b), batch, "eager")
                eager_ms.append(ms)
                sol, ms = call(solver, batch, "replay")
                replay_ms.append(ms)
            if not same(sol, ref):
                fail(f"{backend} {name} call {i}: make_batch_solver differs from the eager "
                     f"solve_batch")
            frac = float(sol.diagnostics.converged.float().mean())
            use = float((sol.diagnostics.kkt_feasibility <= 1e-2).float().mean())
            if i:
                conv.append(frac)
                usable.append(use)
                log(f"[5] {backend} {name} call {i}: eager {eager_ms[-1]:.3f} ms, replay "
                    f"{replay_ms[-1]:.3f} ms, bitwise equal, converged {frac:.5f}, usable "
                    f"{use:.5f}, launches {expected} each")
        before = counts()
        prof, _ = profile_call(lambda: solver(batch))
        launched = moved(before)
        traced = traced_launches(lambda: solver(batch))
        if traced != launched or launched != expected:
            fail(f"{backend} {name}: a profiled replay ran {traced} kernels by the trace, "
                 f"counted {launched}, expected {expected}")
        p50 = float(np.percentile(replay_ms, 50))
        results[name] = {
            "backend": backend,
            "batch": BATCH,
            "calls": calls,
            "first_call_ms": first_ms,
            "replay_p50_ms": p50,
            "replay_max_ms": max(replay_ms),
            "eager_p50_ms": float(np.percentile(eager_ms, 50)),
            "eager_max_ms": max(eager_ms),
            "solves_per_s": BATCH / (p50 / 1e3),
            "converged_fraction": float(np.mean(conv)),
            "usable_fraction": float(np.mean(usable)),
            "launches_per_call": expected,
            "replay_kernels": prof["kernels"],
            "replay_busy_ms": prof["busy_ms"],
            "replay_idle_share": prof["idle_share"],
            "replay_kernels_by_trace": traced,
        }
        log(f"[5] {backend} {name}: " + json.dumps(results[name]))
    floors = {"free": 0.95, "k8_dyn2": 0.90, "k8_dyn2_elastic": 0.90}
    for name in results:
        floor = floors[name]
        if results[name]["converged_fraction"] < floor:
            fail(f"{backend} {name}: converged fraction "
                 f"{results[name]['converged_fraction']} < {floor}")
    launches = counts()
    keys = (("fused",) if backend == "fused"
            else ("init", "riccati", "condense", "step", "diagnostics"))
    if not all(launches[k] for k in keys):
        fail(f"the {backend} main path never launched one of its kernels: {launches}")
    return results, launches


def phase_mehrotra(cfg, pool):
    """One timed `solve_batch` call each of split with mehrotra "pc" and
    "soc" on ``cfg`` at B=8192: two condensation and two Riccati launches
    and one step launch per IPM iteration."""
    import torch

    from kissmpc_tpu_torch import solve_batch
    from kissmpc_tpu_torch.solver.problem import gather

    results = {}
    its = cfg.solver.iterations + sum(it for _, it, _ in cfg.solver.refine_stages)
    expected = split_solve_launches(its, solves=1 + len(cfg.solver.refine_stages),
                                    predictor=True)
    for mode in ("pc", "soc"):
        mcfg = cfg.replace(solver=dataclasses.replace(cfg.solver, mehrotra=mode))
        idx = torch.as_tensor(np.random.default_rng(2).permutation(POOL)[:BATCH], device="cuda")
        batch = gather(pool, idx)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sol = solve_batch(mcfg, batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = counts()
        finite = bool(torch.isfinite(sol.controls).all() and torch.isfinite(sol.states).all())
        results[mode] = {
            "latency_ms": elapsed * 1e3,
            "solves_per_s": BATCH / elapsed,
            "converged_fraction": float(sol.diagnostics.converged.float().mean()),
            "usable_fraction": float((sol.diagnostics.kkt_feasibility <= 1e-2).float().mean()),
            "launches": launches,
            "iterations": its,
        }
        log(f"[5] split free mehrotra={mode}: " + json.dumps(results[mode]))
        if launches != expected:
            fail(f"mehrotra={mode}: launches {launches}, expected {expected}")
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
    """One closed-loop tick, the fleet's solves and then the world's move,
    as one program through `graph.run` (scripts/bench_fleet_episodes.py:169
    jits it): one CUDA graph per shape on the card, eager on the CPU and
    inside `graph.eager()`.  Returns (env, obstacles, info)."""
    from kissmpc_tpu_torch import environment
    from kissmpc_tpu_torch._tree import leaves, unflatten
    from kissmpc_tpu_torch.obstacles import advance
    from kissmpc_tpu_torch.solver import graph

    like = (env, obstacles)

    def program(*tensors):
        env, obstacles = unflatten(like, tensors)
        env, info = environment.fleet_step(cfg, params, env, obstacles, device=device)
        return env, advance(obstacles, cfg.time_step), info

    return graph.run(("fleet_tick", cfg, params), program, device, *leaves(like))


def perception_tick(variant, cfg, params, tcfg, geom, frames, offsets, static, env, pstate,
                    frame, device):
    """One tick of scripts/bench_perception_tick.py:88-114 as one program
    through `graph.run`, as the bench jits it (`:123`): one CUDA graph per
    variant and shape on the card, eager on the CPU and inside
    `graph.eager()`.  ``"with_perception"`` steps the B pipelines on frame
    ``frame`` of the stacked ``frames`` (points, point masks, instance
    masks, instance valid), offsets their tracked humans to each episode,
    joins them to the ``static`` circles and runs `environment.fleet_step`;
    ``"solver_only"`` runs `fleet_step` on the static circles.  ``frame``
    is a [1] int64 tensor on ``device``, selected on the device: a Python
    index would be baked into the graph, and every replay would perceive
    the capture's frame.  The geometry's tensors, the frames, the offsets
    and the static set are inputs; the geometry's image size is in the
    key.  Returns (env, pstate, info, tracked): for "solver_only" the
    pstate it was given and tracked None."""
    import torch

    from kissmpc_tpu_torch import environment
    from kissmpc_tpu_torch._tree import leaves, unflatten
    from kissmpc_tpu_torch.obstacles import ObstacleSet
    from kissmpc_tpu_torch.perception import pipeline
    from kissmpc_tpu_torch.solver import graph

    if variant == "solver_only":
        like = (env, static)

        def solver_only(*tensors):
            return environment.fleet_step(cfg, params, *unflatten(like, tensors), device=device)

        env, info = graph.run(("perception_tick", variant, cfg, params), solver_only, device,
                              *leaves(like))
        return env, pstate, info, None
    if variant != "with_perception":
        raise ValueError(f"unknown perception tick variant {variant!r}")
    tensors_of_geom = tuple(geom[:3])  # intrinsics, lidar->camera, lidar->map
    like = (env, pstate, frame, frames, tensors_of_geom, offsets, static)

    def with_perception(*tensors):
        env, pstate, frame, frames, g, offsets, static = unflatten(like, tensors)
        current = [torch.index_select(x, 0, frame)[0] for x in frames]
        pstate, tracked = pipeline.step(tcfg, pstate, pipeline.FrameGeometry(*g, *geom[3:]),
                                        *current, FRAMES_DT, device=device)
        tracked = tracked._replace(position=tracked.position + offsets[:, None, :])
        obstacles = ObstacleSet(*(torch.cat([a, b], dim=1) for a, b in zip(static, tracked)))
        env, info = environment.fleet_step(cfg, params, env, obstacles, device=device)
        return env, pstate, info, tracked

    key = ("perception_tick", variant, cfg, params, tcfg, geom.image_width, geom.image_height)
    return graph.run(key, with_perception, device, *leaves(like))


def phase_fleet():
    """`fleet_step` + `obstacles.advance` for FLEET_TICKS ticks of
    FLEET_BATCH episodes on the card, then FLEET_CHECK episodes x ticks on
    the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.obstacles import clearance_to_point
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver import graph

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
    per_tick = expect(fused=expected, build=1)  # the tick's problem build, then its solve
    with sync_checked_programs() as ran:
        fleet_tick(cfg, params, env, obstacles, "cuda")
        torch.cuda.synchronize()
    if ran != ["fleet_tick"]:
        fail(f"the sync-checked fleet tick ran the programs {ran}")
    log("[7] the tick's program ran on the card under set_sync_debug_mode('error')")
    solve_batch_fused.launches = 0
    solve_lqr_cuda.launches = 0
    lat, eager_lat, conv, usable, clear = [], [], [], [], []
    replan_s, replan_reach = None, None
    ever_final = torch.zeros(FLEET_BATCH, dtype=torch.bool, device="cuda")
    eager = (env, obstacles)  # the eager ticks' own copy of the state
    graphs = graph.captured("fleet_tick")
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
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env, obstacles, info = fleet_tick(cfg, params, env, obstacles, "cuda")
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        launched = moved(before)
        if launched != per_tick:
            fail(f"fleet tick {tick}: launches {launched}, expected {per_tick}")
        if tick < FLEET_EAGER_TICKS:
            t0 = time.perf_counter()
            with graph.eager():
                out = fleet_tick(cfg, params, *eager, "cuda")
            torch.cuda.synchronize()
            eager_lat.append((time.perf_counter() - t0) * 1e3)
            if not all(bitwise_equal(a, b) for a, b in zip(leaves((env, obstacles, info)),
                                                          leaves(out), strict=True)):
                fail(f"fleet tick {tick}: the replay differs from the eager tick")
            eager = out[:2]
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
    if graph.captured("fleet_tick") != graphs + 1:
        fail("the fleet loop did not run as one CUDA graph")
    # One replayed tick under the profiler: the fused stages' share of it
    # (CUDA events cannot be recorded inside a captured tick).
    prof, _ = profile_call(lambda: fleet_tick(cfg, params, env, obstacles, "cuda"))
    traced = traced_launches(lambda: fleet_tick(cfg, params, env, obstacles, "cuda"))
    if traced != per_tick:
        fail(f"a profiled fleet tick ran {traced} kernels by the trace, expected {per_tick}")
    if solve_lqr_cuda.launches:
        fail("the fused fleet loop launched the Riccati kernel")
    fused_launches = solve_batch_fused.launches
    p50 = float(np.percentile(lat[1:], 50))
    eager_p50 = float(np.percentile(eager_lat, 50))
    log(f"[7] one replayed tick under the profiler: {prof['kernels']} kernels, busy "
        f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms (idle {prof['idle_share']:.5f}), "
        f"the 3 fused kernels {prof['fused_ms']:.3f} ms ({prof['fused_ms'] / prof['wall_ms']:.5f}"
        f" of the tick); tick p50 {p50:.3f} ms replayed (first tick, warm-up and capture, "
        f"{lat[0]:.3f} ms) against {eager_p50:.3f} ms for the {FLEET_EAGER_TICKS} eager ticks, "
        f"bitwise equal")
    result = {
        "batch": FLEET_BATCH,
        "ticks": FLEET_TICKS,
        "tick_p50_ms": p50,
        "tick_max_ms": max(lat[1:]),
        "first_tick_ms": lat[0],
        "eager_ticks": FLEET_EAGER_TICKS,
        "eager_tick_p50_ms": eager_p50,
        "solves_per_s": FLEET_BATCH / (p50 / 1e3),
        "converged_fraction_mean": float(np.mean(conv)),
        "usable_fraction_mean": float(np.mean(usable)),
        "final_goal_reached_fraction": float(ever_final.float().mean()),
        "min_clearance_m": min(clear),
        "fused_launches_per_tick": expected,
        "launches_per_tick": per_tick,
        "fused_launches": fused_launches,
        "replay_profiled": prof,
        "fused_stage_share": prof["fused_ms"] / prof["wall_ms"],
        "router": "grid",
        "world_build_s": build_s,
        "leg_reachable_fraction": float(reach.mean()),
        "episode_reachable_fraction": float(reach.all(axis=1).mean()),
        "replan_s": replan_s,
        "replan_reachable_fraction": float(replan_reach.mean()),
    }

    # The "detour" router's tick time beside it: a short loop on its worlds
    # (6 route points per episode instead of 12), its first tick a capture.
    env_d, obs_d, _ = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda", router="detour")
    detour = []
    for _ in range(DETOUR_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env_d, obs_d, _ = fleet_tick(cfg, params, env_d, obs_d, "cuda")
        torch.cuda.synchronize()
        detour.append((time.perf_counter() - t0) * 1e3)
    result["detour_tick_p50_ms"] = float(np.percentile(detour[1:], 50))
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
    """The planner at the fleet's size on the card: the world build, the
    replan and `bottleneck_clearance`, each through its CUDA graphs and
    eagerly (under the sync debug mode), timed, bitwise equal; one eager
    plan and one replayed plan under the profiler; then PLANNER_CHECK
    episodes on the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch.planner import bottleneck_clearance, plan_waypoint_chain
    from kissmpc_tpu_torch.solver import graph

    cfg, params = fleet_config()
    infl = params.inflation_radius
    kw = dict(points_per_leg=FLEET_POINTS_PER_LEG, grid=FLEET_PLANNER_GRID)
    starts, wps, centers, radii, static = planner_inputs(cfg, FLEET_BATCH, 2)
    env, obstacles, _ = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda")
    circles = static_circles(obstacles)

    def build():
        return fleet_worlds(cfg, FLEET_BATCH, 0, "cuda")[0].waypoints

    def replanned():
        return replan(env, circles, infl, "cuda")[0].waypoints

    def clearance():
        return torch.as_tensor(bottleneck_clearance(starts, wps[:, -1], centers, radii, static,
                                                    infl, grid=FLEET_PLANNER_GRID))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    times, graphs = {}, graph.captured()
    for name, fn in (("world_build", build), ("replan", replanned), ("clearance", clearance)):
        with sync_checked_programs() as ran:
            ref, eager_s = timed(fn)
        first, first_s = timed(fn)  # a capture where phase 7 has not made the shape
        again, replay_s = timed(fn)
        if not (ran and bitwise_equal(first, ref) and bitwise_equal(again, ref)):
            fail(f"the planner's {name}: its replay differs from the eager run, or no program "
                 f"ran under the sync debug mode ({ran})")
        times[name] = {"eager_s": eager_s, "first_s": first_s, "replay_s": replay_s}
        log(f"[8] {name} B={FLEET_BATCH} G={FLEET_PLANNER_GRID}: eager {eager_s:.4f} s (programs "
            f"{ran} under set_sync_debug_mode('error')), first call {first_s:.4f} s, replay "
            f"{replay_s:.4f} s, bitwise equal")
    out, reach = plan_waypoint_chain(starts, wps, centers, radii, static, infl, **kw)
    if not (np.isfinite(out).all() and out.shape == (FLEET_BATCH, 12, 3)):
        fail(f"the planner's chain is {out.shape} or not finite")
    plan = lambda: plan_waypoint_chain(starts, wps, centers, radii, static, infl, **kw)  # noqa: E731
    with graph.eager():
        eager_prof, _ = profile_call(plan)
    replay_prof, _ = profile_call(plan)
    log(f"[8] plan_waypoint_chain B={FLEET_BATCH} W=3 under the profiler: eager "
        f"{eager_prof['kernels']} kernels, busy {eager_prof['busy_ms']:.3f} of "
        f"{eager_prof['wall_ms']:.3f} ms (idle {eager_prof['idle_share']:.5f}); replayed "
        f"{replay_prof['kernels']} kernels, busy {replay_prof['busy_ms']:.3f} of "
        f"{replay_prof['wall_ms']:.3f} ms (idle {replay_prof['idle_share']:.5f}); reachable "
        f"legs {float(reach.mean()):.5f}; graphs captured in this phase "
        f"{graph.captured() - graphs}")

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
    return {"batch": FLEET_BATCH, "grid": FLEET_PLANNER_GRID, "times": times,
            "eager_plan_profiled": eager_prof, "replayed_plan_profiled": replay_prof,
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
        occ = ipm_fused.occupancy(cfg, EDGE_BATCH)
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


def trace_kernels(prof, copies=False):
    """The card's kernels in a profile (with ``copies`` its copies and
    fills too, else without), in the order they ran."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and (copies or not e.name.startswith(("Memcpy", "Memset")))]
    return sorted(kernels, key=lambda e: e.time_range.start)


def find_run(kernels, run):
    """The indices at which the names of ``run`` occur in ``kernels`` back
    to back: where a program's kernels ran inside a replay that ran them in
    the order of their eager launches."""
    names, want = [e.name for e in kernels], [e.name for e in run]
    return [i for i in range(len(names) - len(want) + 1) if names[i:i + len(want)] == want]


def marked_runs(fn, runs, copies=False):
    """The card's kernels (with ``copies`` its copies and fills too) of
    ``runs`` calls of ``fn`` under one profile, a list for each call whose
    kernels lie between two recorded marker kernels (`torch.cuda._sleep`'s
    `spin_kernel`).  The profiler can lose the first kernels of a trace, so
    a long spin leads, and a call that begins before the first recorded
    marker is left out: every list is a whole call."""
    import torch

    def marked():
        torch.cuda._sleep(MARKER_LEAD_CYCLES)
        for _ in range(runs):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)

    _, prof = profile_call(marked)
    kernels = trace_kernels(prof, copies)
    cuts = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
    return [kernels[a + 1:b] for a, b in zip(cuts, cuts[1:]) if b > a + 1]


def phase_perception(tmpdir):
    """The perception-in-the-loop fleet tick (scripts/bench_perception_tick.py
    at its default size) on the card, each variant one CUDA graph
    (`perception_tick`, its program first under the sync debug mode), the
    two interleaved in chunks as the bench runs them; the first call and
    the first PERCEPTION_EAGER_TICKS replays of each also eagerly on a copy
    of the state, bitwise equal; one profiled replay of each, and DBSCAN's
    kernels inside the perception replay; the eager perception step's
    CUDA-event time and DBSCAN's share of it; then PERCEPTION_CHECK
    pipelines x frames on the card against the CPU port."""
    import torch

    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.perception import clustering, pipeline, tracker
    from kissmpc_tpu_torch.scenarios import episode_worlds
    from kissmpc_tpu_torch.solver import graph

    B, ticks = PERCEPTION_BATCH, PERCEPTION_TICKS
    frames, truth = walk_frames(f"{tmpdir}/walk.npz", ticks + 1)
    F = len(frames)
    geom, *stack = stacked_frames(frames, "cuda")
    stack = tuple(stack)
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
    per_tick = expect(fused=expected, build=1)  # the tick's problem build, then its solve

    def tick(variant, env, pstate, f):
        frame = torch.full((1,), f, dtype=torch.int64, device="cuda")
        return perception_tick(variant, cfg, params, tcfg, geom, stack, offsets, static, env,
                               pstate, frame, "cuda")

    def perceive(pstate, f):
        return pipeline.step(tcfg, pstate, geom, *(x[f] for x in stack), FRAMES_DT,
                             device="cuda")

    pstate0 = pipeline.init_perception(TRACK_CAPACITY, batch=B, device="cuda")
    with sync_checked_programs() as ran:
        for name in PERCEPTION_VARIANTS:
            tick(name, env, pstate0, 1)
        torch.cuda.synchronize()
    if ran != ["perception_tick"] * len(PERCEPTION_VARIANTS):
        fail(f"the sync-checked perception ticks ran the programs {ran}")
    log("[11] both variants' programs ran on the card under set_sync_debug_mode('error')")

    solve_batch_fused.launches = 0
    graphs = graph.captured("perception_tick")
    st = {name: {"e": env, "p": pstate0, "eager": (env, pstate0), "calls": 0, "lat": [],
                 "eager_lat": [], "launches": [], "compared": []}
          for name in PERCEPTION_VARIANTS}

    def run_tick(name, f):
        """One tick of ``name`` at frame ``f``, timed to its converged
        fraction on the host as the bench reads its scalars; the first call
        and the next PERCEPTION_EAGER_TICKS also eagerly from the eager
        copy of the state, held bitwise to the replay."""
        s = st[name]
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s["e"], s["p"], s["info"], s["tracked"] = tick(name, s["e"], s["p"], f)
        s["conv"] = float(s["info"].diagnostics.converged.float().mean())
        ms = (time.perf_counter() - t0) * 1e3
        s["launches"].append(moved(before))
        if s["calls"]:
            s["lat"].append(ms)
        else:
            s["first_ms"] = ms
        if s["calls"] <= PERCEPTION_EAGER_TICKS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with graph.eager():
                out = tick(name, *s["eager"], f)
            float(out[2].diagnostics.converged.float().mean())
            if s["calls"]:
                s["eager_lat"].append((time.perf_counter() - t0) * 1e3)
            got = leaves((s["e"], s["p"], s["info"], s["tracked"]))
            if not all(bitwise_equal(a, b) for a, b in zip(got, leaves(out), strict=True)):
                fail(f"perception tick {name}, call {s['calls']} (frame {f}): the replay "
                     f"differs from the eager tick")
            s["eager"] = out[:2]
            s["compared"].append(f)
        s["calls"] += 1
        s["f"] = f

    for name in PERCEPTION_VARIANTS:  # the bench's first call, at frame 0
        run_tick(name, 0)
    rounds = max(1, (ticks - 1) // PERCEPTION_CHUNK)
    for r in range(rounds):
        for name in PERCEPTION_VARIANTS:
            for j in range(PERCEPTION_CHUNK):
                run_tick(name, (r * PERCEPTION_CHUNK + j) % F)
    if graph.captured("perception_tick") != graphs + len(PERCEPTION_VARIANTS):
        fail("the perception tick did not run as one CUDA graph per variant")
    results, traces = {}, {}
    for name, s in st.items():
        wrong = [n for n in s["launches"] if n != per_tick]
        if wrong:
            fail(f"{name}: launches per tick {wrong[0]} ({len(wrong)} ticks), expected "
                 f"{per_tick}")
        if len(set(s["compared"])) < PERCEPTION_COMPARED_FRAMES:
            fail(f"{name}: replays held to the eager tick at frames {s['compared']} only")
        prof, traces[name] = profile_call(lambda: tick(name, s["e"], s["p"], s["f"]))
        traced = traced_launches(lambda: tick(name, s["e"], s["p"], s["f"]))
        if traced != per_tick:
            fail(f"{name}: a profiled replay ran {traced} kernels by the trace, expected "
                 f"{per_tick}")
        lat = np.asarray(s["lat"])
        p50 = float(np.percentile(lat, 50))
        results[name] = {
            "tick_p50_ms": p50, "tick_p99_ms": float(np.percentile(lat, 99)),
            "ticks": s["calls"], "first_call_ms": s["first_ms"],
            "eager_p50_ms": float(np.percentile(s["eager_lat"], 50)),
            "eager_ticks": len(s["eager_lat"]), "ticks_bitwise_equal_to_eager":
            len(s["compared"]), "frames_compared": sorted(set(s["compared"])),
            "converged": s["conv"],
            "tracked_total": (float(s["tracked"].active.sum()) if s["tracked"] is not None
                              else 0.0),
            "fused_launches_per_tick": expected, "launches_per_tick": per_tick,
            "replay_kernels": prof["kernels"], "replay_fused_kernels": prof["fused_kernels"],
            "replay_build_ms": prof["build_ms"],
            "replay_busy_ms": prof["busy_ms"], "replay_fused_ms": prof["fused_ms"],
            "replay_idle_share": 1.0 - prof["busy_ms"] / p50}
        log(f"[11] {name}: " + json.dumps(results[name]))
    # The replays, the eager ticks held against them and the profiled replays.
    results["fused_launches"] = solve_batch_fused.launches
    added = {key: results["with_perception"][key] - results["solver_only"][key]
             for key in ("tick_p50_ms", "eager_p50_ms")}
    results.update(perception_added_ms=added["tick_p50_ms"],
                   perception_added_eager_ms=added["eager_p50_ms"])
    log(f"[11] perception_added_ms {added['tick_p50_ms']:.4f} replayed, "
        f"{added['eager_p50_ms']:.4f} eager")

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
    for name in PERCEPTION_VARIANTS:
        if results[name]["converged"] < 0.90:
            fail(f"perception tick {name}: converged {results[name]['converged']:.5f} < 0.90")

    # The perception step alone, eagerly, one call per event pair, and
    # DBSCAN on the selection it clusters; launches of one step by the
    # profiler's trace.
    p = s["p"]
    step_ms = cuda_ms(lambda: perceive(p, 5), reps=20)
    with perception_trace() as calls:
        perceive(p, 5)
    c = calls[-1]

    def run_dbscan():
        return clustering.dbscan(c["points"], c["mask"], pipeline.DBSCAN_EPS,
                                 pipeline.DBSCAN_MIN_SAMPLES)

    dbscan_ms = cuda_ms(run_dbscan, reps=20)
    results.update(perception_step_ms=step_ms, dbscan_ms=dbscan_ms,
                   dbscan_share=dbscan_ms / step_ms)
    log(f"[11] perception step alone, eager (B={B}, one call per event pair): {step_ms:.4f} "
        f"ms; DBSCAN on its selection {dbscan_ms:.4f} ms, {dbscan_ms / step_ms:.5f} of it")
    step_prof, _ = profile_call(lambda: perceive(p, 5))
    results.update(perception_launches_per_step=step_prof["kernels"],
                   perception_step_device_busy_ms=step_prof["busy_ms"])
    log(f"[11] one eager perception step by the profiler: {step_prof['kernels']} kernels on "
        f"the card, busy {step_prof['busy_ms']:.4f} ms")

    # DBSCAN inside the perception replay: its eager kernels, found back to
    # back in a replay's (a graph runs its kernels in the order of their
    # launches at the capture), each from the last complete marked run.
    last = st["with_perception"]
    dbscan_runs = marked_runs(run_dbscan, 2)
    replays = marked_runs(lambda: tick("with_perception", last["e"], last["p"], last["f"]), 2)
    run = dbscan_runs[-1] if dbscan_runs else []
    replay = replays[-1] if replays else []
    at = find_run(replay, run) if run else []
    if len(at) == 1:
        window = replay[at[0]:at[0] + len(run)]
        by_name = {}
        for e in window:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.device_time / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        window_ms = sum(e.device_time for e in window) / 1e3
        replay_ms = sum(e.device_time for e in replay) / 1e3
        results["dbscan_in_replay"] = {
            "kernels": len(window), "device_ms": window_ms, "replay_kernels": len(replay),
            "replay_kernel_ms": replay_ms, "share_of_replay_kernel_ms": window_ms / replay_ms,
            # each sweep writes and reads one [B, M, P, P] int32 tensor
            "sweep_tensor_bytes": 4 * c["mask"].numel() * c["mask"].shape[-1],
            "top_kernels": [{"name": n[:120], "count": k, "ms": ms} for n, (k, ms) in top]}
        log("[11] DBSCAN inside the profiled perception replay: "
            + json.dumps(results["dbscan_in_replay"]))
    else:
        results["dbscan_in_replay"] = None
        log(f"[11] DBSCAN inside the replay: not measured ({len(dbscan_runs)} and "
            f"{len(replays)} complete marked runs; its {len(run)} eager kernels are found "
            f"{len(at)} times among the replay's {len(replay)})")

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
def sync_checked_programs():
    """Inside the block every program an entry point hands `graph.run` (the
    region a CUDA graph captures) runs eagerly on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, so that any host
    synchronisation in it raises; yields the list of the programs' keys."""
    import torch

    from kissmpc_tpu_torch.solver import graph

    real, ran = graph.run, []

    def checked(key, fn, device, *inputs):
        def strict(*args):
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(before)
            ran.append(key[0])
            return out

        return real(key, strict, device, *inputs)

    graph.run = checked
    try:
        with graph.eager():
            yield ran
    finally:
        graph.run = real


def bitwise_equal(a, b):
    """Equal shapes, dtypes and bits (NaN equal to the same NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def profile_call(fn):
    """One call of ``fn`` under `torch.profiler`, ended by a synchronise.
    Returns its wall ms, the card's events (kernels apart from copies and
    fills), busy ms and idle share, the Riccati, fused, split init,
    condensation, step and diagnostics kernels and the build kernel, and
    their ms, the host's synchronisations (`cudaStreamSynchronize` and synchronous
    `cudaMemcpy`; the closing `torch.cuda.synchronize` is not one of them)
    and every CUDA runtime call by name; and the profiler.  The profiler
    can lose a trace's first kernels: hold a call's counted kernels
    against its counters with `traced_launches`."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    stats = run_stats([e for e in events if e.device_type.name == "CUDA"])
    runtime = collections.Counter(e.name for e in events
                                  if e.device_type.name == "CPU" and e.name.startswith("cuda"))
    return {"wall_ms": wall_ms, **stats, "idle_share": 1.0 - stats["busy_ms"] / wall_ms,
            "host_syncs": runtime["cudaStreamSynchronize"] + runtime["cudaMemcpy"],
            "runtime_calls": dict(runtime)}, prof


def run_stats(device):
    """Of a list of the card's events (copies and fills among them): their
    number, the kernels' (copies and fills apart), busy ms (all of them),
    and each counted kernel's (`KERNEL_NAMES`) launches and ms."""
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    stats = {"device_events": len(device), "kernels": len(kernels),
             "busy_ms": sum(e.device_time for e in device) / 1e3}
    for key, name in KERNEL_NAMES.items():
        mine = [e for e in kernels if name in e.name]
        stats[f"{key}_kernels"] = len(mine)
        stats[f"{key}_ms"] = sum(e.device_time for e in mine) / 1e3
    return stats


def _counters():
    """The launch counters of the card's kernels on the solve paths: the
    fused kernel; the Riccati kernel and the split kernels (init,
    condensation, step, diagnostics); the problem build."""
    from kissmpc_tpu_torch.ops import ipm_split, problem_build
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

    return {"fused": solve_batch_fused, "riccati": solve_lqr_cuda,
            "condense": ipm_split.condense_cuda, "step": ipm_split.step_cuda,
            "init": ipm_split.init_cuda, "diagnostics": ipm_split.diagnostics_cuda,
            "build": problem_build.build_cuda}


# The counted kernels' names in a trace, by their counters' names.
KERNEL_NAMES = {"fused": "ipm_fused_kernel", "riccati": "riccati_kernel",
                "condense": "condense_kernel", "step": "step_kernel", "init": "init_kernel",
                "diagnostics": "diagnostics_kernel", "build": "build_kernel"}


def traced_launches(fn):
    """The counted kernels of one call of ``fn`` by the profiler's trace, per
    counter (`_counters`): the last of two calls between recorded marker
    kernels (`marked_runs`).  The profiler can lose a trace's first
    kernels, and a call's first kernel is often a counted one (a tick's
    build kernel)."""
    runs = marked_runs(fn, 2)
    if not runs:
        fail("no call of a marked profile lies between two recorded markers")
    return {k: sum(1 for e in runs[-1] if name in e.name) for k, name in KERNEL_NAMES.items()}


def expect(**n):
    """Launches per counter of `_counters`: the given ones, 0 elsewhere."""
    unknown = set(n) - set(_counters())
    if unknown:
        raise KeyError(f"no launch counter named {sorted(unknown)}")
    return {k: n.get(k, 0) for k in _counters()}


def split_solve_launches(iterations, solves=1, predictor=False):
    """Launches of ``solves`` split `ipm.solve` calls of ``iterations`` IPM
    iterations in all: per solve one init and one diagnostics launch, per
    iteration one condensation, one Riccati and one step launch (and one
    more condensation and Riccati solve for Mehrotra's predictor)."""
    extra = iterations if predictor else 0
    return expect(init=solves, diagnostics=solves, condense=iterations + extra,
                  riccati=iterations + extra, step=iterations)


def zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in _counters().items()}


def moved(before):
    return {k: n - before[k] for k, n in counts().items()}


def launches_by_op(prof, top=30):
    """The host's kernel launches in a profile, by the operator that made
    them (the innermost `aten::` op around the launch; a launch outside any,
    such as the Riccati wrapper's ctypes call, under "(no op)")."""
    import collections

    count = collections.Counter()
    for e in prof.events():
        if e.device_type.name == "CPU" and "LaunchKernel" in e.name:
            parent = e.cpu_parent
            count[parent.name if parent is not None else "(no op)"] += 1
    return dict(count.most_common(top))


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
    """The single-robot node tick on the card, captured: NODE_TICKS ticks
    with their Riccati launches counted, one CUDA graph for all of them;
    the same walk on the eager path on the card, its commands bitwise
    equal; one eager and NODE_PROFILED replayed ticks under the profiler;
    the tick's program under the sync debug mode; the commands against the
    CPU port; the kernel against its plain version on one tick's LQR data."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.solver import graph

    walk = f"{tmpdir}/walk.npz"
    obstacles = node_obstacles(walk, "cuda")
    graphs = graph.captured()
    zero_counts()
    commands, poses, lat, (loop, odom) = node_loop("cuda", NODE_TICKS, obstacles)
    torch.cuda.synchronize()
    model = loop.model
    iters = model.cfg.solver.iterations
    per_tick = split_solve_launches(iters) | {"build": 1}
    tick_counts, new_graphs = counts(), graph.captured() - graphs
    launches = tick_counts["riccati"]
    if tick_counts != {k: n * NODE_TICKS for k, n in per_tick.items()}:
        fail(f"node: launches {tick_counts} in {NODE_TICKS} ticks, expected {per_tick} per "
             f"tick")
    if new_graphs != 1:
        fail(f"node: {new_graphs} CUDA graphs captured in {NODE_TICKS} ticks, expected 1")
    if not np.isfinite(commands).all():
        fail("node: non-finite command")

    # The same walk and odometry on the eager path on the card.
    zero_counts()
    with graph.eager():
        eager_cmds, _, eager_lat, (eager_loop, eager_odom) = node_loop(
            "cuda", NODE_TICKS, obstacles, odoms=poses)
    torch.cuda.synchronize()
    same = np.array_equal(eager_cmds, commands)
    eager_gap = float(np.abs(eager_cmds - commands).max())
    if counts() != tick_counts:
        fail(f"node, eager: launches {counts()} in {NODE_TICKS} ticks, expected {tick_counts}")
    # Percentiles of the ticks after the first (whose warm-up and capture
    # are reported apart), on both paths.
    p50, p99 = float(np.percentile(lat[1:], 50)), float(np.percentile(lat[1:], 99))
    e50, e99 = (float(np.percentile(eager_lat[1:], 50)),
                float(np.percentile(eager_lat[1:], 99)))
    result = {"ticks": NODE_TICKS, "horizon": model.cfg.horizon, "iterations": iters,
              "graphs_captured": new_graphs, "tick_p50_ms": p50, "tick_p99_ms": p99,
              "first_tick_ms": lat[0], "period_ms": NODE_PERIOD_MS,
              "p50_over_period": p50 / NODE_PERIOD_MS,
              "eager_tick_p50_ms": e50, "eager_tick_p99_ms": e99,
              "eager_first_tick_ms": eager_lat[0], "eager_over_captured_p50": e50 / p50,
              "riccati_launches_per_tick": launches // NODE_TICKS,
              "launches_per_tick": per_tick,
              "eager_commands_bitwise_equal": same, "eager_max_command_gap": eager_gap,
              "converged_last": bool(model.last_diagnostics.converged),
              "last_command": commands[-1].tolist()}
    log(f"[12] node tick (N={model.cfg.horizon}, {iters} iterations, B=1), captured, ticks "
        f"2-{NODE_TICKS}: p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms against the {NODE_PERIOD_MS} ms period of the 100 Hz "
        f"timer ({p50 / NODE_PERIOD_MS:.2f}x); first tick (warm-up and capture) {lat[0]:.3f} ms; "
        f"{new_graphs} graph; launches per tick {per_tick}. Eager on the "
        f"card, same walk: p50 {e50:.3f} ms, p99 {e99:.3f} ms ({e50 / p50:.2f}x the captured "
        f"p50); commands bitwise equal to the captured ones: {same} (largest gap "
        f"{eager_gap:.3e})")
    if not same:
        fail(f"node: captured commands differ from the eager card path's by {eager_gap:.3e}")

    # One eager tick and NODE_PROFILED replayed ticks under the profiler.
    eager_odom.publish(poses[-1])
    with graph.eager():
        eager_prof, prof = profile_call(eager_loop.tick)
    by_op = launches_by_op(prof)
    # Each replayed tick's wall time and host synchronisations, one profile
    # each; its kernels and device time from whole ticks between recorded
    # markers (a profile of one tick can lose its first kernels, the
    # build's among them).
    replayed = []
    for k in range(NODE_PROFILED):
        odom.publish(poses[-1 - k])
        before = counts()
        stats, _ = profile_call(loop.tick)
        counted = moved(before)
        replayed.append({key: stats[key] for key in ("wall_ms", "host_syncs", "runtime_calls")}
                        | {"counted": counted})
        if counted != per_tick:
            fail(f"node: a replayed tick ran {counted} kernels by the counter, expected "
                 f"{per_tick}")
        if stats["host_syncs"] > NODE_LEAVES_READ:
            fail(f"node: a replayed tick synchronised {stats['host_syncs']} times, more than "
                 f"the {NODE_LEAVES_READ} leaves it reads back")
    poses_left = iter(poses[::-1])

    def marked_tick():
        odom.publish(next(poses_left))
        return loop.tick()

    runs = marked_runs(marked_tick, NODE_PROFILED + 1, copies=True)
    if len(runs) < NODE_PROFILED:
        fail(f"node: {len(runs)} whole replayed ticks between recorded markers, expected "
             f"{NODE_PROFILED}")
    for k, run in enumerate(runs[-NODE_PROFILED:]):
        stats = run_stats(run)
        stats["ipm_loop_kernels"] = sum(stats[f"{n}_kernels"] for n in ("condense", "riccati",
                                                                        "step"))
        replayed[k].update(stats)
        log(f"[12] replayed node tick {k} under the profiler: {json.dumps(replayed[k])}")
        traced = {n: stats[f"{n}_kernels"] for n in KERNEL_NAMES}
        if traced != per_tick:
            fail(f"node: a replayed tick ran {traced} kernels by the trace, expected "
                 f"{per_tick}")
    rep = {key: float(np.median([r[key] for r in replayed]))
           for key in ("wall_ms", "kernels", "busy_ms", "riccati_ms", "condense_ms", "step_ms",
                       "build_ms", "init_ms", "diagnostics_ms", "ipm_loop_kernels",
                       "host_syncs")}
    rep["idle_share"] = 1.0 - rep["busy_ms"] / rep["wall_ms"]
    # Kernels a tick could keep and fit the period, at its mean kernel time.
    keep = int(rep["kernels"] * NODE_PERIOD_MS / rep["busy_ms"])
    result.update(eager_profiled=eager_prof, eager_kernels_per_iteration=
                  eager_prof["kernels"] / iters, eager_launches_by_op=by_op,
                  replayed_profiled=replayed, replayed_median=rep,
                  idle_share_at_p50=1.0 - rep["busy_ms"] / p50,
                  kernels_within_period=keep, kernels_to_remove=rep["kernels"] - keep)
    log(f"[12] one eager node tick under the profiler: {json.dumps(eager_prof)}; "
        f"{eager_prof['kernels'] / iters:.1f} kernels per iteration")
    log(f"[12] the eager tick's kernel launches by op: {json.dumps(by_op)}")
    log(f"[12] replayed ticks (median of {NODE_PROFILED}): {rep['wall_ms']:.3f} ms, "
        f"{rep['kernels']:.0f} kernels, card busy {rep['busy_ms']:.3f} ms (idle "
        f"{rep['idle_share']:.5f}; against the unprofiled p50 "
        f"{result['idle_share_at_p50']:.5f}), {rep['host_syncs']:.0f} host syncs; the IPM "
        f"loop {rep['ipm_loop_kernels']:.0f} kernels: condensation {rep['condense_ms']:.4f} "
        f"ms, Riccati {rep['riccati_ms']:.4f} ms, step {rep['step_ms']:.4f} ms; build "
        f"{rep['build_ms']:.4f} ms, init {rep['init_ms']:.4f} ms, diagnostics "
        f"{rep['diagnostics_ms']:.4f} ms; at the mean "
        f"kernel time {keep} kernels fit the {NODE_PERIOD_MS} ms period; replayed tick p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms against it")

    # The tick's program eagerly under the sync debug mode.
    eager_odom.publish(poses[0])
    with sync_checked_programs() as ran:
        eager_loop.tick()
        torch.cuda.synchronize()
    if ran != ["io.Model"]:
        fail(f"node: the sync-checked tick ran the programs {ran}")
    log("[12] the node tick's program ran on the card under set_sync_debug_mode('error')")

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
    split = split_kernels_check(model.cfg, model.last_problem, 8, ipm_split._library(),
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    log(f"[12] the split kernels on the last tick's problem (B=1, N={model.cfg.horizon}): "
        f"{describe_split_check(split)}")
    if not split["ok"]:
        fail("node: the split kernels disagree with their plain halves on the tick's problem")
    result.update(cpu_check_max_gap=gap, riccati_gate_err=gate["err"],
                  split_condense_err=split["condense"]["err"], split_step_err=split["step"]["err"])
    log("[12] node: " + json.dumps(result))
    return result


def phase_data_parallel(cfg, pool):
    """Phase 13: `parallel.fleet` over a one-rank NCCL group (an in-process
    store, no port), each fleet call one CUDA graph with its two
    collectives: the fleet solver on the K=8 cell at B=8192 bitwise against
    the captured `make_batch_solver`, the stepper for DP_TICKS ticks at
    FLEET_BATCH bitwise against phase 7's captured tick, both programs
    under the sync debug mode, and the health check."""
    import datetime

    import torch
    import torch.distributed as dist

    from kissmpc_tpu_torch import make_batch_solver
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.obstacles import advance
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.parallel import fleet, multihost
    from kissmpc_tpu_torch.solver import graph
    from kissmpc_tpu_torch.solver.problem import gather

    def same(a, b):
        return all(bitwise_equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = fleet.make_mesh()
        batch = gather(pool, torch.arange(BATCH, device="cuda"))
        solver, batch_solver = fleet.make_fleet_solver(cfg, mesh), make_batch_solver(cfg)
        with sync_checked_programs() as ran:
            solver(batch)
            torch.cuda.synchronize()
        if ran != ["make_fleet_solver"]:
            fail(f"the sync-checked fleet solver ran the programs {ran}")
        graphs = graph.captured()
        ref, (sol, metrics) = batch_solver(batch), solver(batch)
        torch.cuda.synchronize()
        if not same(sol, ref):
            fail("the fleet solver's solution differs from make_batch_solver's")
        d = ref.diagnostics
        own = (d.converged.float().mean(), d.kkt_stationarity.amax(), d.kkt_feasibility.amax(),
               d.final_cost.mean())
        if not all(torch.equal(a, b) for a, b in zip(metrics, own)):
            fail(f"fleet metrics {[float(x) for x in metrics]} differ from the diagnostics' "
                 f"{[float(x) for x in own]}")
        lat = {"make_batch_solver": [], "fleet": []}
        solve_batch_fused.launches = fleet_launches = 0
        for _ in range(DP_CALLS):
            for name, call in (("make_batch_solver", lambda: batch_solver(batch)),
                               ("fleet", lambda: solver(batch))):
                before = solve_batch_fused.launches, fleet.fleet_metrics.collectives
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e3)
                if name == "fleet":
                    fleet_launches += solve_batch_fused.launches - before[0]
                    if fleet.fleet_metrics.collectives - before[1] != 2:
                        fail("a fleet solver replay did not count its 2 collectives")
                    if not same(out[0], ref):
                        fail("a fleet solver replay differs from make_batch_solver's")
        expected = (1 + len(cfg.solver.refine_stages)) * DP_CALLS
        if fleet_launches != expected:
            fail(f"the fleet solver launched the fused kernel {fleet_launches} times in "
                 f"{DP_CALLS} calls, expected {expected}")
        p50 = {name: float(np.percentile(v, 50)) for name, v in lat.items()}
        # What the fleet adds to a call, alone: the metric reduction, eager.
        metrics_ms = cuda_ms(lambda: fleet.fleet_metrics(d, fleet.mesh_group(mesh)), reps=20)
        log(f"[13] fleet solver, one NCCL rank, k8_dyn2 B={BATCH}, one CUDA graph with its 2 "
            f"collectives: solution bitwise equal to the captured make_batch_solver's, metrics "
            f"equal to its diagnostics' (converged {float(metrics.converged_fraction):.5f}); "
            f"2 collectives per replay, {fleet_launches} fused launches in its {DP_CALLS} calls; "
            f"p50 {p50['fleet']:.3f} ms against make_batch_solver's "
            f"{p50['make_batch_solver']:.3f} ms (+{p50['fleet'] - p50['make_batch_solver']:.3f} "
            f"ms); the metric reduction alone, eager, {metrics_ms:.4f} ms (CUDA events, one call "
            f"per pair)")

        fcfg, params = fleet_config()
        env, obstacles, _ = fleet_worlds(fcfg, FLEET_BATCH, 2, "cuda")
        stepper = fleet.make_fleet_env_stepper(fcfg, params, mesh)
        with sync_checked_programs() as ran:
            stepper(env, obstacles)
            torch.cuda.synchronize()
        if ran != ["make_fleet_env_stepper"]:
            fail(f"the sync-checked fleet stepper ran the programs {ran}")
        chains = {"fleet_tick": [env, obstacles], "stepper": [env, obstacles]}
        tick_ms = {name: [] for name in chains}
        solve_batch_fused.launches = stepper_launches = 0
        for tick in range(DP_TICKS):
            for name, chain in chains.items():
                before = solve_batch_fused.launches, fleet.fleet_metrics.collectives
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "stepper":
                    new_env, _, step_metrics = stepper(*chain)
                    chain[:] = [new_env, advance(chain[1], fcfg.time_step)]
                else:
                    chain[:] = fleet_tick(fcfg, params, *chain, "cuda")[:2]
                torch.cuda.synchronize()
                tick_ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "stepper":
                    stepper_launches += solve_batch_fused.launches - before[0]
                    if fleet.fleet_metrics.collectives - before[1] != 2:
                        fail("a fleet stepper replay did not count its 2 collectives")
            if not same(*chains.values()):
                fail(f"the fleet stepper's state differs from the captured tick's at {tick}")
        graphs = graph.captured() - graphs
        tick_p50 = {name: float(np.percentile(v[1:], 50)) for name, v in tick_ms.items()}
        expected = (1 + len(fcfg.solver.refine_stages)) * DP_TICKS
        if stepper_launches != expected:
            fail(f"the fleet stepper launched the fused kernel {stepper_launches} times in "
                 f"{DP_TICKS} ticks, expected {expected}")
        log(f"[13] fleet stepper B={FLEET_BATCH}, {DP_TICKS} ticks, one CUDA graph with its 2 "
            f"collectives: EnvState and obstacles bitwise equal to the captured fleet tick's "
            f"every tick; tick p50 (ticks 2-{DP_TICKS}) {tick_p50['stepper']:.3f} ms against the "
            f"captured tick's {tick_p50['fleet_tick']:.3f} ms; {stepper_launches} fused launches "
            f"in its {DP_TICKS} ticks; last tick converged "
            f"{float(step_metrics.converged_fraction):.5f}; graphs captured in this phase "
            f"{graphs}")
        t0 = time.perf_counter()
        healthy = multihost.health_check(mesh, timeout_s=GROUP_TIMEOUT_S)
        health_s = time.perf_counter() - t0
        log(f"[13] health check: {healthy} in {health_s:.4f} s")
        if not healthy:
            fail("the one-rank health check failed")
    finally:
        dist.destroy_process_group()
    return {"batch": BATCH, "calls": DP_CALLS, "collectives_per_call": 2,
            "fused_launches": fleet_launches, "stepper_fused_launches": stepper_launches,
            "fleet_p50_ms": p50["fleet"], "make_batch_solver_p50_ms": p50["make_batch_solver"],
            "fleet_minus_make_batch_solver_ms": p50["fleet"] - p50["make_batch_solver"],
            "metrics_ms": metrics_ms, "graphs_captured": graphs,
            "stepper_batch": FLEET_BATCH, "stepper_ticks": DP_TICKS,
            "stepper_tick_p50_ms": tick_p50["stepper"],
            "fleet_tick_p50_ms": tick_p50["fleet_tick"], "health_check_s": health_s}


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


def phase_utils_cli(tmpdir):
    """Phase 15: the CLI's demo, map and lab on the card, a profiler trace
    of one fleet tick, and a checkpoint of the fleet's EnvState resumed
    bitwise."""
    import glob

    import torch

    from kissmpc_tpu_torch import MPCConfig, cli, environment
    from kissmpc_tpu_torch import agent as agent_mod
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.agent import AgentParams
    from kissmpc_tpu_torch.solver import graph
    from kissmpc_tpu_torch.utils import profiling
    from kissmpc_tpu_torch.utils.checkpoint import CheckpointManager, FleetCheckpoint

    result = {}
    # The demo's tick program (`agent.step` at its defaults: N=20, dt 0.1,
    # no obstacles) eagerly under the sync debug mode.
    dcfg = MPCConfig(horizon=20, time_step=0.1)
    start = agent_mod.init_agent(dcfg, [0.0, 0.0, 0.0], [1.2, 0.4, 0.0])
    with sync_checked_programs() as ran:
        agent_mod.step(dcfg, AgentParams(radius=0.15), start)
        torch.cuda.synchronize()
    if ran != ["agent.step"]:
        fail(f"the sync-checked agent.step ran the programs {ran}")
    log("[15] agent.step's program ran on the card under set_sync_debug_mode('error')")
    path = f"{tmpdir}/synthetic_lab.pgm"
    write_synthetic_map(path)  # phase 9's map: the same shape and seed
    lab_argv = ["lab", "--map", path, "--batch", str(CLI_LAB_BATCH)]
    with sync_checked_programs() as ran:
        rc = cli.main(lab_argv + ["--ticks", "1"])
        torch.cuda.synchronize()
    if rc != 0 or "cli.lab" not in ran:
        fail(f"the sync-checked lab returned {rc} and ran the programs {ran}")
    log(f"[15] lab's programs {ran} ran on the card under set_sync_debug_mode('error')")
    for name, argv in (("demo", ["demo", "--ticks", str(DEMO_TICKS)]),
                       ("map", ["map", path, "-o", f"{tmpdir}/circles.npz"]),
                       ("lab", lab_argv + ["--ticks", str(CLI_LAB_TICKS)])):
        zero_counts()
        graphs = graph.captured()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        result[f"{name}_s"] = time.perf_counter() - t0
        launches = counts()
        result[f"{name}_launches"] = launches
        result[f"{name}_graphs"] = graph.captured() - graphs
        log(f"[15] cli {' '.join(argv[:1] + argv[2:] if name == 'map' else argv)}: rc {rc} in "
            f"{result[f'{name}_s']:.3f} s; kernel launches {launches}; CUDA graphs captured "
            f"{result[f'{name}_graphs']}")
        if rc != 0:
            fail(f"cli {name} returned {rc}")
        # demo solves split (agent.step's program, one CUDA graph), lab
        # through fleet_step (one CUDA graph of the tick, 3 fused launches
        # per replay; its world build's planner fields are graphs too).
        kernels = {"demo": ("build", "init", "riccati", "condense", "step", "diagnostics"),
                   "lab": ("build", "fused")}.get(name, ())
        if not all(launches[k] for k in kernels):
            fail(f"cli {name} never launched one of the kernels {kernels}: {launches}")
        if name == "demo" and result["demo_graphs"] != 1:
            fail(f"cli demo captured {result['demo_graphs']} CUDA graphs, expected 1")
        if name == "lab" and (launches["fused"] != 3 * CLI_LAB_TICKS
                              or graph.captured("cli.lab") != 1):
            fail(f"cli lab: {launches['fused']} fused launches in {CLI_LAB_TICKS} ticks, "
                 f"expected {3 * CLI_LAB_TICKS}, and {graph.captured('cli.lab')} tick graphs, "
                 f"expected 1")
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


def build_pools(fused_cfgs):
    """The benchmark's pools of POOL scenarios (seed 0), free and K=8; the
    K=8 build is one CUDA graph (`scenarios.obstacle_problems`, as the
    reference jits it): its program first under the sync debug mode, then
    the first call (warm-up and capture), then a second K=8 pool from
    SECOND_POOL_SEED built by a replay and eagerly (`graph.eager()`),
    bitwise equal, and different from the first.  Returns (pools, what was
    measured)."""
    import torch

    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver import graph

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = fused_cfgs["k8_dyn2"]
    k8 = lambda seed: obstacle_problems(cfg, POOL, seed=seed, n_dynamic=2)  # noqa: E731
    free, free_s = timed(lambda: free_problems(fused_cfgs["free"], POOL, seed=0))
    with sync_checked_programs() as ran:
        k8(0)
        torch.cuda.synchronize()
    if ran != ["scenarios.obstacle_problems"]:
        fail(f"the sync-checked pool build ran the programs {ran}")
    graphs = graph.captured("scenarios.obstacle_problems")
    first, first_s = timed(lambda: k8(0))
    second, replay_s = timed(lambda: k8(SECOND_POOL_SEED))
    with graph.eager():
        eager, eager_s = timed(lambda: k8(SECOND_POOL_SEED))
    equal = all(bitwise_equal(a, b) for a, b in zip(leaves(second), leaves(eager), strict=True))
    moved = not bitwise_equal(first.initial_state, second.initial_state)
    record = {"free_build_s": free_s, "k8_first_call_s": first_s, "k8_replay_s": replay_s,
              "k8_eager_s": eager_s, "replay_bitwise_equal_to_eager": equal,
              "graphs": graph.captured("scenarios.obstacle_problems") - graphs,
              "static_output_bytes": sum(x.numel() * x.element_size() for x in leaves(first))}
    log(f"pools of {POOL} on the card: free {free_s:.3f} s (eager); K=8 one CUDA graph, "
        f"its program under set_sync_debug_mode('error'), first call (warm-up and capture) "
        f"{first_s:.3f} s, a second pool (seed {SECOND_POOL_SEED}) by a replay {replay_s:.3f} s "
        f"and eagerly {eager_s:.3f} s, bitwise equal: {equal}; the graph keeps "
        f"{record['static_output_bytes']} bytes of static outputs")
    if record["graphs"] != 1:
        fail(f"the pool build captured {record['graphs']} graphs, expected 1")
    if not equal:
        fail("the replayed pool build differs from the eager one")
    if not moved:
        fail("the replayed pool build returned the first pool's scenarios")
    pools = {"free": free, "k8_dyn2": first}
    pools["k8_dyn2_elastic"] = first  # the same scenarios, elastic constraints
    return pools, record


def phase_captured_solver(cfg, pool):
    """Phase 16: `make_solver` (one CUDA graph) against the eager
    `ipm.solve` on ``cfg`` (k8_dyn2 on split, N=50, float32) at B=8192:
    its program under the sync debug mode, the first call (warm-up and
    capture) timed, every result bitwise equal to the eager one, the first
    unchanged by later calls, CAPTURED_CALLS eager calls and replays in
    turns, and one replay's condensation, Riccati and step kernels by the
    profiler."""
    import torch

    from kissmpc_tpu_torch import make_solver
    from kissmpc_tpu_torch._tree import leaves
    from kissmpc_tpu_torch.solver import graph
    from kissmpc_tpu_torch.solver.problem import gather

    idx = torch.as_tensor(np.random.default_rng(16).permutation(POOL)[:BATCH], device="cuda")
    batch = gather(pool, idx)
    iters = cfg.solver.iterations
    solve = make_solver(cfg)
    with sync_checked_programs() as ran:
        ref = solve(batch)
        torch.cuda.synchronize()
    if ran != ["make_solver"]:
        fail(f"the sync-checked make_solver ran the programs {ran}")
    log(f"[16] make_solver's program (B={BATCH}) ran on the card under "
        f"set_sync_debug_mode('error')")

    def timed(eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graph.eager() if eager else contextlib.nullcontext():
            sol = solve(batch)
        torch.cuda.synchronize()
        return sol, (time.perf_counter() - t0) * 1e3

    def same(sol):
        return all(bitwise_equal(a, b) for a, b in zip(leaves(sol), leaves(ref)))

    graphs = graph.captured()
    zero_counts()
    first, first_ms = timed(False)
    kept = [x.clone() for x in leaves(first)]
    eager_ms, replay_ms, equal = [], [], [same(first)]
    for _ in range(CAPTURED_CALLS):
        sol, ms = timed(True)
        eager_ms.append(ms)
        equal.append(same(sol))
        sol, ms = timed(False)
        replay_ms.append(ms)
        equal.append(same(sol))
    launches = counts()
    per_call = split_solve_launches(iters)
    expected = {k: n * (1 + 2 * CAPTURED_CALLS) for k, n in per_call.items()}
    unchanged = all(bitwise_equal(a, b) for a, b in zip(leaves(first), kept))
    before = counts()
    stats, _ = profile_call(lambda: solve(batch))
    counted = moved(before)
    traced = traced_launches(lambda: solve(batch))
    result = {"batch": BATCH, "horizon": N, "iterations": iters,
              "graphs_captured": graph.captured() - graphs, "first_call_ms": first_ms,
              "eager_p50_ms": float(np.percentile(eager_ms, 50)),
              "replay_p50_ms": float(np.percentile(replay_ms, 50)),
              "eager_ms": eager_ms, "replay_ms": replay_ms,
              "bitwise_equal": all(equal), "first_result_unchanged": unchanged,
              "riccati_launches": launches["riccati"], "launches": launches,
              "replay_profiled": stats, "replay_counted": counted,
              "converged_fraction": float(ref.diagnostics.converged.float().mean())}
    result["eager_over_replay_p50"] = result["eager_p50_ms"] / result["replay_p50_ms"]
    log(f"[16] make_solver k8_dyn2 split, N={N}, f32, B={BATCH}, {iters} iterations: first "
        f"call (warm-up and capture) {first_ms:.3f} ms; p50 eager ipm.solve "
        f"{result['eager_p50_ms']:.3f} ms, replay {result['replay_p50_ms']:.3f} ms "
        f"({result['eager_over_replay_p50']:.3f}x); bitwise equal to eager in all "
        f"{len(equal)} calls: {all(equal)}; first result unchanged: {unchanged}; one replay "
        f"under the profiler: kernels {traced} by the trace, {counted} by the counters, "
        f"{stats['kernels']} kernels in all, idle {stats['idle_share']:.5f}")
    if result["graphs_captured"] != 1:
        fail(f"make_solver captured {result['graphs_captured']} graphs, expected 1")
    if not all(equal):
        fail("make_solver's replay differs from the eager ipm.solve")
    if not unchanged:
        fail("a later make_solver call changed the first call's result")
    if launches != expected:
        fail(f"make_solver: launches {launches} counted, expected {expected}")
    if not traced == counted == per_call:
        fail(f"make_solver: a replay ran {traced} kernels by the trace and {counted} by the "
             f"counters, expected {per_call}")
    log("[16] captured solver: " + json.dumps(result))
    return result


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")

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
    pools, pool_build = build_pools(fused_cfgs)

    riccati = phase_kernel(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    t0 = time.perf_counter()
    split_condense, split_step = phase_split_kernels(split_cfgs, pools)
    log(f"phase 17 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    build, split_init, split_diag = phase_build_once(split_cfgs, pools)
    log(f"phase 18 took {time.perf_counter() - t0:.3f} s")
    probe = phase_probe()
    fused = phase_fused_kernel(fused_cfgs, pools)
    fused_stages = phase_fused_stages(fused_cfgs, pools)
    t0 = time.perf_counter()
    fused_results, fused_launches = phase_main_path("fused", fused_cfgs, pools, CALLS)
    t1 = time.perf_counter()
    hard = ("free", "k8_dyn2")
    split_results, split_launches = phase_main_path(
        "split", {name: split_cfgs[name] for name in hard}, pools, CALLS)
    log(f"phase 5 took {t1 - t0:.3f} s fused, {time.perf_counter() - t1:.3f} s split")
    riccati["launches"] = split_launches["riccati"]
    split_condense["launches"] = split_launches["condense"]
    split_step["launches"] = split_launches["step"]
    split_init["launches"] = split_launches["init"]
    split_diag["launches"] = split_launches["diagnostics"]
    mehrotra = phase_mehrotra(split_cfgs["free"], pools["free"])
    for name, cfg in fused_cfgs.items():
        idx = torch.as_tensor(np.random.default_rng(1).permutation(POOL)[:BATCH], device="cuda")
        stage_ms = timed_stages(cfg, gather(pools[name], idx))
        fused_results[name]["stage_ms"] = stage_ms
        log(f"[5] fused {name}: CUDA-event time of each stage's launch (B, ms): {stage_ms}")
    phase_cpu_check(fused_cfgs, split_cfgs, pools)
    t0 = time.perf_counter()
    fleet = phase_fleet()
    t1 = time.perf_counter()
    planner = phase_planner()
    log(f"phases 7 and 8 took {t1 - t0:.3f} / {time.perf_counter() - t1:.3f} s")
    with tempfile.TemporaryDirectory() as tmpdir:
        lab = phase_lab(tmpdir)
    ric_edges, fused_edges = phase_horizons(fused_cfgs)
    riccati.update(long_horizon=ric_edges)
    with tempfile.TemporaryDirectory() as tmpdir:
        perception = phase_perception(tmpdir)
        node = phase_node(tmpdir)
    riccati.update(node_launches_per_tick=node["riccati_launches_per_tick"],
                   node_launches=node["riccati_launches_per_tick"] * node["ticks"])
    for entry, key in ((split_condense, "condense"), (split_step, "step"), (split_init, "init"),
                       (split_diag, "diagnostics")):
        entry.update(node_launches_per_tick=node["launches_per_tick"][key],
                     node_launches=node["launches_per_tick"][key] * node["ticks"],
                     mehrotra_launches={m: r["launches"][key] for m, r in mehrotra.items()})
    # The build's main path is the node tick (this slice's path): one launch
    # per tick; the fleet and perception ticks build once per tick too.
    build.update(launches=node["launches_per_tick"]["build"] * node["ticks"],
                 node_launches_per_tick=node["launches_per_tick"]["build"],
                 fleet_launches_per_tick=fleet["launches_per_tick"]["build"],
                 perception_launches_per_tick=perception["with_perception"][
                     "launches_per_tick"]["build"])
    t0 = time.perf_counter()
    data_parallel = phase_data_parallel(fused_cfgs["k8_dyn2"], pools["k8_dyn2"])
    data_parallel["phase_s"] = t1 = time.perf_counter() - t0
    lqr_pt = phase_lqr_pt(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    lqr_pt["phase_s"] = t2 = time.perf_counter() - t0 - t1
    with tempfile.TemporaryDirectory() as tmpdir:
        utils_cli = phase_utils_cli(tmpdir)
    utils_cli["phase_s"] = time.perf_counter() - t0 - t1 - t2
    t0 = time.perf_counter()
    captured = phase_captured_solver(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    captured["phase_s"] = time.perf_counter() - t0
    log(f"phases 13-16 took {t1:.3f} / {t2:.3f} / {utils_cli['phase_s']:.3f} / "
        f"{captured['phase_s']:.3f} s")
    riccati.update(cli_demo_launches=utils_cli["demo_launches"]["riccati"],
                   captured_solver_launches=captured["riccati_launches"])
    for entry, key in ((split_condense, "condense"), (split_step, "step"), (split_init, "init"),
                       (split_diag, "diagnostics"), (build, "build")):
        entry.update(cli_demo_launches=utils_cli["demo_launches"][key],
                     captured_solver_launches=captured["launches"][key])

    # The fused row is the K=8 cell's, with the elastic branch's numbers
    # beside it; its launches are the fused main path's (all three cells).
    fused_k8, elastic = fused["k8_dyn2"], fused["k8_dyn2_elastic"]
    for entry in fused.values():
        entry["launches"] = fused_launches["fused"]
    fused_k8.update(elastic_ms=elastic["ms"], elastic_plain_ms=elastic["plain_ms"],
                    elastic_bound_ms=elastic["bound_ms"],
                    elastic_max_abs_err=elastic["max_abs_err"], stage_ms=fused_stages,
                    longest_horizon=fused_edges, fleet_launches=fleet["fused_launches"],
                    perception_launches_per_tick=perception["with_perception"][
                        "fused_launches_per_tick"],
                    perception_launches=perception["fused_launches"],
                    data_parallel_launches=data_parallel["fused_launches"],
                    data_parallel_stepper_launches=data_parallel["stepper_fused_launches"],
                    cli_lab_launches=utils_cli["lab_launches"]["fused"])
    log(json.dumps({"build_s": build_s, "fused_occupancy": occupancy,
                    "fused_free_kernel": fused["free"],
                    "main_path": {"fused": fused_results, "split": split_results,
                                  "split_mehrotra": mehrotra},
                    "pool_build": pool_build, "fleet": fleet, "planner": planner, "lab_worlds": lab,
                    "perception_tick": perception, "node_tick": node,
                    "data_parallel": data_parallel, "lqr_pt": lqr_pt, "utils_cli": utils_cli,
                    "captured_solver": captured,
                    "total_s": time.perf_counter() - t_start}))
    kernels = [riccati, probe, fused_k8, split_condense, split_step, build, split_init,
               split_diag]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        missing = [k for k in keys if k not in entry]
        if missing or not isinstance(entry["launches"], int):
            fail(f"the kernels line's {entry.get('name')} entry lacks {missing} or an integer "
                 f"count of launches ({entry.get('launches')!r})")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
