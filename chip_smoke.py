#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`kissmpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. build the three CUDA libraries from `kissmpc_tpu_torch/csrc/` (one nvcc
   per source, all started together) and print each ptxas register/spill
   line;
2. hold the Riccati kernel against its plain PyTorch version (`ops/lqr.py`)
   on the card: B=8192, N=50, float32 on LQR data from a real IPM iterate of
   the K=8 benchmark batch, and float64 at B=64; time both with CUDA events;
3. the trip-count probe: counts 7 and then 31 read from device memory by
   one loaded library; the results must be exactly 7.0 and 31.0;
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
   1e-3 (free) / 2e-3 (K=8, both branches); time each at 32 iterations;
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
   by the "detour" router, 50 ticks), 3 fused launches per tick, each
   launch timed by CUDA events to give the fused stages' share of a tick;
   then 64
   episodes x 5 ticks on the card and on the CPU port, whose waypoint
   indices must match on 95% of episode-ticks and whose executed states
   must agree within 1e-3 on 95% of them.

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
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Floating-point operations of one Riccati step per scenario, counted from
# csrc/riccati.cu (an FMA is two): backward sweep 395, forward rollout 50.
RICCATI_FLOPS_PER_STEP = 445
FUSED_ITERATIONS = 32
PROBE_TRIPS = (7, 31)
# Closed loop of scripts/bench_fleet_episodes.py:81-112, cut to 50 ticks and
# the "detour" router (the grid planner is not ported yet).
FLEET_BATCH = 4096
FLEET_TICKS = 50
FLEET_STAGES = ((0.125, 64, 0.2), (0.02, 96, 0.7))
FLEET_CHECK = (64, 5)  # episodes x ticks held against the CPU port


def fused_ops_per_iteration(n, k, ls_iters, elastic=False):
    """Operations of one IPM iteration per scenario, counted from
    csrc/ipm_fused.cu.  Each add, multiply, compare-and-select, min, max,
    abs, division, sqrt, sin, cos and log counts as one operation and an
    FMA as two, so the bound is optimistic: the card spends several
    instructions on each division and transcendental.  Per pass:

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
    once per iteration as the function needs it (the TPU kernel computes
    it once and reuses it; csrc/ipm_fused.cu recomputes it in each merit
    candidate and in the update, which is the kernel's own cost and not
    counted): +21 in the condensation (the elastic gradient in place of
    the hard one); its coefficients (el_coef, 23) and eliminated step
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


def cuda_ms(fn, reps, warmup=3):
    """Median over ``reps`` launches of ``fn``, each timed by CUDA events."""
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
    return build_s


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


def phase_kernel(cfg, pool):
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather

    reg = cfg.solver.reg
    data = lqr_from_iterate(cfg, gather(pool, torch.arange(BATCH, device="cuda")))
    got = solve_lqr_cuda(data, reg)
    ref = solve_lqr(data, reg)
    ref64 = solve_lqr(LQRData(*(x.double() for x in data)), reg)
    torch.cuda.synchronize()

    def max_err(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip((a.dx, a.du), (b.dx, b.du)))

    scale = max(1.0, float(ref.dx.abs().max()), float(ref.du.abs().max()))
    err = max_err(got, ref)
    err_kernel64 = max_err(got, ref64)
    err_plain64 = max_err(ref, ref64)
    # The two f32 versions sum in different orders over a 50-step
    # recurrence; they may disagree by ~1e-4 of the solution's scale plus
    # the f32 error of the system itself, which the f64 solve measures.
    tol = 1e-4 * scale + 2.0 * err_plain64
    finite = all(torch.isfinite(x).all() for x in (got.dx, got.du))
    log(f"[2] Riccati f32 B={BATCH} N={N}: max|kernel-plain| {err:.3e} "
        f"(tol {tol:.3e}, scale {scale:.3e}); vs f64: kernel {err_kernel64:.3e}, "
        f"plain {err_plain64:.3e}")
    if not finite or not err <= tol:
        fail(f"Riccati kernel disagrees with its plain version: {err} > {tol}")

    small = LQRData(*(x[:64].double().contiguous() for x in data))
    got64, ref64s = solve_lqr_cuda(small, reg), solve_lqr(small, reg)
    torch.cuda.synchronize()
    scale64 = max(1.0, float(ref64s.dx.abs().max()), float(ref64s.du.abs().max()))
    err64 = max_err(got64, ref64s)
    log(f"[2] Riccati f64 B=64 N={N}: max|kernel-plain| {err64:.3e} "
        f"(tol {1e-9 * scale64:.3e})")
    if not err64 <= 1e-9 * scale64:
        fail(f"f64 Riccati kernel disagrees with its plain version: {err64}")

    ms = cuda_ms(lambda: solve_lqr_cuda(data, reg), reps=30)
    plain_ms = cuda_ms(lambda: solve_lqr(data, reg), reps=5, warmup=1)
    n_bytes = sum(x.numel() * x.element_size() for x in data) + sum(
        x.numel() * x.element_size() for x in (got.dx, got.du))
    flops = RICCATI_FLOPS_PER_STEP * N * BATCH
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[2] Riccati kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({n_bytes} bytes -> {bytes_ms:.4f} ms; "
        f"{flops} flop -> {ops_ms:.4f} ms)")
    return {
        "name": "riccati",
        "route": "cuda",
        "source": "kissmpc_tpu_torch/csrc/riccati.cu",
        "replaces": "kissmpc_tpu/ops/pallas/riccati.py:98",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_probe():
    import torch

    from kissmpc_tpu_torch.ops.probe import dynamic_trip, dynamic_trip_plain

    x = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    for trips in PROBE_TRIPS:
        iters = torch.tensor([trips], dtype=torch.int32, device="cuda")
        got = dynamic_trip(x, iters)
        ref = dynamic_trip_plain(x, iters)
        torch.cuda.synchronize()
        vals = torch.unique(got).tolist()
        log(f"[3] probe, trip count {trips} from device memory: values {vals}")
        if vals != [float(trips)] or not torch.equal(got, ref):
            fail(f"probe kernel gave {vals} for {trips} trips")
    ms = cuda_ms(lambda: dynamic_trip(x, iters), reps=50)
    plain_ms = cuda_ms(lambda: dynamic_trip_plain(x, iters), reps=10)
    n_bytes = 2 * x.numel() * x.element_size() + iters.element_size()
    flops = PROBE_TRIPS[-1] * x.numel()
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    log(f"[3] probe kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({n_bytes} bytes -> "
        f"{bytes_ms:.3e} ms; {flops} flop -> {ops_ms:.3e} ms)")
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
        "library_ms": None,
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


def phase_fused_kernel(cfgs, pools):
    """The fused kernel against its plain version on the card, B=8192:
    {configuration: its kernels-line entry}."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
    from kissmpc_tpu_torch.solver.problem import gather

    entries = {}
    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3), ("k8_dyn2_elastic", 2e-3)):
        cfg = cfgs[name]
        batch = gather(pools[name], torch.arange(BATCH, device="cuda"))
        ref = plain_reference(cfg, batch)
        g = fused_gates(ref, solve_batch_fused(cfg, batch, iterations=1),
                        solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS), tol)
        torch.cuda.synchronize()
        log(f"[4] fused {name} iterations=1: max|kernel-plain| {g['err1']:.3e} "
            f"(tol {g['tol1']:.3e}, scale {g['scale']:.3e}, plain f32-f64 {ref['plain64']:.3e})")
        if not g["ok_one"]:
            fail(f"fused kernel disagrees with its plain version at one iteration ({name})")
        log(f"[4] fused {name} iterations={FUSED_ITERATIONS}: converged kernel "
            f"{g['converged']:.5f}, plain {g['plain_converged']:.5f}; flags differ on "
            f"{g['flips']} (limit {g['flip_limit']:g}; the plain version's flags change on "
            f"{ref['noises']} under a one-ulp nudge of x0 up, down); {g['within']:.5f} of "
            f"{g['both']} converged on both within {tol} (max {g['worst']:.3e}); max over all "
            f"{g['max_all']:.3e}")
        if not g["ok_full"]:
            fail(f"fused kernel disagrees with its plain version at {FUSED_ITERATIONS} "
                 f"iterations ({name})")

        ms = cuda_ms(lambda: solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS),
                     reps=5, warmup=1)
        plain_ms = cuda_ms(
            lambda: solve_batch_fused_plain(cfg, batch, iterations=FUSED_ITERATIONS),
            reps=1, warmup=0)
        K = cfg.max_obstacles
        elastic = cfg.solver.elastic_obstacles
        # Bytes the function must move: its inputs read once, its outputs
        # written once; the iterate scratch (~10 KB per scenario) is left out.
        in_rows = 27 + 3 * (N + 1) + 2 * N + (4 * K + 2 * K + 1 if K else 0)
        out_rows = 3 * (N + 1) + 2 * N + 6
        n_bytes = 4 * (in_rows + out_rows) * BATCH + 4
        ops = BATCH * (
            FUSED_ITERATIONS * fused_ops_per_iteration(N, K, cfg.solver.ls_iters, elastic)
            + fused_ops_once(N, K, elastic))
        bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
        log(f"[4] fused {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at B={BATCH}, "
            f"{FUSED_ITERATIONS} iterations; bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({n_bytes} bytes -> {bytes_ms:.4f} ms; {ops} operations -> {ops_ms:.4f} ms)")
        entries[name] = {
            "name": "ipm_fused",
            "route": "cuda",
            "source": "kissmpc_tpu_torch/csrc/ipm_fused.cu",
            "replaces": "kissmpc_tpu/ops/pallas/ipm_fused.py:108",
            "launches": None,
            "max_abs_err": g["err1"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
    return entries


@contextlib.contextmanager
def stage_events():
    """Time every fused launch that `solve_batch` makes inside the block with
    CUDA events (the wrapper's packing and transposes included); yields the
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


def fleet_worlds(cfg, batch, seed, device):
    from kissmpc_tpu_torch.scenarios import episode_worlds

    return episode_worlds(cfg, batch, n_waypoints=3, seed=seed, n_dynamic=2,
                          route_around_obstacles=True, router="detour", device=device)


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
    env, obstacles = fleet_worlds(cfg, FLEET_BATCH, 0, "cuda")
    torch.cuda.synchronize()
    log(f"[7] {FLEET_BATCH} episode worlds (W={env.waypoints.shape[1]}) built in "
        f"{time.perf_counter() - t0:.3f} s")
    expected = 1 + len(cfg.solver.refine_stages)
    solve_batch_fused.launches = 0
    solve_lqr_cuda.launches = 0
    lat, conv, usable, clear, stage_ms = [], [], [], [], []
    ever_final = torch.zeros(FLEET_BATCH, dtype=torch.bool, device="cuda")
    with stage_events() as events:
        for tick in range(FLEET_TICKS):
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
        "fused_stage_share_mean": float(np.mean(share)),
        "last_tick_stage_ms": stage_ms[-1],
    }
    log("[7] fleet: " + json.dumps(result))

    # The same closed loop on the card and on the CPU port (the fused plain
    # version, f32).  Float32 solves on both sides agree within 2e-3 in the
    # controls (phase 6), so one tick moves an executed state by at most
    # ~dt * 2e-3 ~ 1e-4, and five ticks, each starting from the last, by
    # ~5e-4: the states are held to 1e-3 on 95% of episode-ticks; a solve
    # converged on one side only, or gated to the fallback on one side
    # only, may differ more, which the 5% allows.
    n_ep, n_ticks = FLEET_CHECK
    worlds = {dev: fleet_worlds(cfg, n_ep, 1, dev) for dev in ("cuda", "cpu")}
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

    build_s = phase_build()
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

    # The fused row is the K=8 cell's, with the elastic branch's numbers
    # beside it; its launches are the fused main path's (all three cells).
    fused_k8, elastic = fused["k8_dyn2"], fused["k8_dyn2_elastic"]
    for entry in fused.values():
        entry["launches"] = fused_launches
    fused_k8.update(elastic_ms=elastic["ms"], elastic_plain_ms=elastic["plain_ms"],
                    elastic_bound_ms=elastic["bound_ms"],
                    elastic_max_abs_err=elastic["max_abs_err"])
    log(json.dumps({"build_s": build_s, "fused_free_kernel": fused["free"],
                    "main_path": {"fused": fused_results, "split": split_results,
                                  "split_mehrotra": mehrotra},
                    "fleet": fleet, "total_s": time.perf_counter() - t_start}))
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
