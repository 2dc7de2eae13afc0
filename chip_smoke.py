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
   B=8192, N=50, float32, for both benchmark configurations: at one
   iteration within 1e-4 of the solution's scale plus twice the plain
   version's own f32-vs-f64 gap; at 32 iterations converged flags differ on
   at most 1% of scenarios and 95% of the scenarios converged on both agree
   within 1e-3 (free) / 2e-3 (K=8); time both at 32 iterations;
5. drive the main path, `solve_batch` with the default ("fused") backend, at
   the benchmark's configurations (`bench.py`): N=50, B=8192, float32,
   32 IPM iterations plus staged refinement, obstacle-free and K=8 circles
   with 2 dynamic tracks.  One warm-up and 5 timed calls each, on distinct
   batches drawn from a pool of 16384.  Every call launches the fused kernel
   once per solve stage and the Riccati kernel never.  Then the same for
   the "split" backend, whose Riccati launches must equal the IPM
   iterations run;
6. check 64 scenarios of each configuration against the port's CPU path:
   the fused kernel against its plain version on the CPU in float32, and
   the split path in float64 and float32.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import concurrent.futures
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


def fused_ops_per_iteration(n, k, ls_iters):
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
    """
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    return (
        11 * box + 22 * obst
        + (360 + 53 * k) * n + 96 + 53 * k
        + 55 * n
        + 24 * box + 41 * obst
        + ls_iters * (80 * t1 + 69 * n + 47 * obst)
        + 26 * box + 45 * obst + 6 * t1 + 4 * n
    )


def fused_ops_once(n, k):
    """Init and diagnostics, once per solve: about three merit passes and
    two reductions (see fused_ops_per_iteration)."""
    t1 = n + 1
    box, obst = 4 * n + 6 * t1, k * n
    return 3 * (80 * t1 + 69 * n + 47 * obst) + 2 * (11 * box + 22 * obst)


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
    """The benchmark's two configurations (bench.py:103-129) on ``backend``
    ("fused" leaves SolverConfig's default in place)."""
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


def phase_fused_kernel(cfgs, pools):
    """The fused kernel against its plain version on the card, B=8192."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    entry = None
    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3)):
        cfg = cfgs[name]
        batch = gather(pools[name], torch.arange(BATCH, device="cuda"))
        got = solve_batch_fused(cfg, batch, iterations=1)
        ref = solve_batch_fused_plain(cfg, batch, iterations=1)
        ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in batch)), iterations=1)
        torch.cuda.synchronize()

        def gap(a, b):
            return max(float((x.double() - y.double()).abs().max())
                       for x, y in ((a.states, b.states), (a.controls, b.controls)))

        scale = max(1.0, float(ref.states.abs().max()), float(ref.controls.abs().max()))
        err1, plain64 = gap(got, ref), gap(ref, ref64)
        tol1 = 1e-4 * scale + 2.0 * plain64
        finite = bool(torch.isfinite(got.states).all() and torch.isfinite(got.controls).all())
        log(f"[4] fused {name} iterations=1: max|kernel-plain| {err1:.3e} (tol {tol1:.3e}, "
            f"scale {scale:.3e}, plain f32-f64 {plain64:.3e})")
        if not finite or not err1 <= tol1:
            fail(f"fused kernel disagrees with its plain version at one iteration ({name})")

        got = solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS)
        ref = solve_batch_fused_plain(cfg, batch, iterations=FUSED_ITERATIONS)
        torch.cuda.synchronize()
        c_k, c_p = got.diagnostics.converged, ref.diagnostics.converged
        both = c_k & c_p
        diff = (got.controls - ref.controls).abs().flatten(1).amax(dim=1)
        flips = int((c_k != c_p).sum())
        within = float((diff[both] <= tol).float().mean()) if bool(both.any()) else 0.0
        worst = float(diff[both].max()) if bool(both.any()) else float("nan")
        log(f"[4] fused {name} iterations={FUSED_ITERATIONS}: converged kernel "
            f"{float(c_k.float().mean()):.5f}, plain {float(c_p.float().mean()):.5f}; flags "
            f"differ on {flips}; {within:.5f} of {int(both.sum())} converged on both within "
            f"{tol} (max {worst:.3e}); max over all {float(diff.max()):.3e}")
        if flips > 0.01 * BATCH or within < 0.95:
            fail(f"fused kernel disagrees with its plain version at {FUSED_ITERATIONS} "
                 f"iterations ({name})")

        ms = cuda_ms(lambda: solve_batch_fused(cfg, batch, iterations=FUSED_ITERATIONS),
                     reps=5, warmup=1)
        plain_ms = cuda_ms(
            lambda: solve_batch_fused_plain(cfg, batch, iterations=FUSED_ITERATIONS),
            reps=1, warmup=0)
        K = cfg.max_obstacles
        # Bytes the function must move: its inputs read once, its outputs
        # written once; the iterate scratch (~10 KB per scenario) is left out.
        in_rows = 27 + 3 * (N + 1) + 2 * N + (4 * K + 2 * K + 1 if K else 0)
        out_rows = 3 * (N + 1) + 2 * N + 6
        n_bytes = 4 * (in_rows + out_rows) * BATCH + 4
        ops = BATCH * (FUSED_ITERATIONS * fused_ops_per_iteration(N, K, cfg.solver.ls_iters)
                       + fused_ops_once(N, K))
        bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
        log(f"[4] fused {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at B={BATCH}, "
            f"{FUSED_ITERATIONS} iterations; bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({n_bytes} bytes -> {bytes_ms:.4f} ms; {ops} operations -> {ops_ms:.4f} ms)")
        entry = {
            "name": "ipm_fused",
            "route": "cuda",
            "source": "kissmpc_tpu_torch/csrc/ipm_fused.cu",
            "replaces": "kissmpc_tpu/ops/pallas/ipm_fused.py:108",
            "launches": None,
            "max_abs_err": err1,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        if K == 0:
            free_entry = entry
    return free_entry, entry


def timed_stages(cfg, batch):
    """One solve_batch call with each fused launch timed by CUDA events
    (the wrapper's packing and transposes included): [(B, ms), ...]."""
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
        api.solve_batch(cfg, batch)
        torch.cuda.synchronize()
    finally:
        api.solve_batch_fused = real
    return [(b, s.elapsed_time(e)) for b, s, e in stages]


def phase_main_path(backend, cfgs, pools, calls):
    """``calls`` timed solve_batch calls per configuration after a warm-up,
    with the launch counts of both kernels read around every call."""
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
        lat, conv = [], []
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
            log(f"[5] {backend} {name} call {call}{' (warm-up)' if call == 0 else ''}: "
                f"{elapsed * 1e3:.3f} ms, converged {frac:.5f}, launches {launched}")
            if call:
                lat.append(elapsed * 1e3)
                conv.append(frac)
        p50 = float(np.percentile(lat, 50))
        results[name] = {
            "backend": backend,
            "batch": BATCH,
            "calls": calls,
            "latency_p50_ms": p50,
            "latency_max_ms": max(lat),
            "solves_per_s": BATCH / (p50 / 1e3),
            "converged_fraction": float(np.mean(conv)),
            "launches_per_call": expected,
        }
        log(f"[5] {backend} {name}: " + json.dumps(results[name]))
    floors = {"free": 0.95, "k8_dyn2": 0.90}
    for name, floor in floors.items():
        if results[name]["converged_fraction"] < floor:
            fail(f"{backend} {name}: converged fraction "
                 f"{results[name]['converged_fraction']} < {floor}")
    launches = {"fused": solve_batch_fused.launches, "riccati": solve_lqr_cuda.launches}
    key = "fused" if backend == "fused" else "riccati"
    if launches[key] == 0:
        fail(f"the {backend} main path never launched its kernel")
    return results, launches[key]


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

    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3)):
        sub = gather(pools[name], torch.arange(64, device="cuda"))
        check_f32(f"fused {name}", fused_cfgs[name], sub, tol)

        cfg = split_cfgs[name]
        c_card, c_cpu, diff = compare(cfg, Problem(*(x.double() for x in sub)))
        log(f"[6] split {name} f64: flags agree {int((c_card == c_cpu).sum())}/64, "
            f"converged {int(c_card.sum())}, max control diff {float(diff.max()):.3e} "
            f"(tol 1e-6)")
        if (c_card != c_cpu).any() or not float(diff.max()) <= 1e-6:
            fail(f"{name}: card and CPU paths disagree in float64")
        check_f32(f"split {name}", cfg, sub, tol)


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
    torch.cuda.synchronize()
    log(f"pools of {POOL} built on the card in {time.perf_counter() - t0:.3f} s")

    riccati = phase_kernel(split_cfgs["k8_dyn2"], pools["k8_dyn2"])
    probe = phase_probe()
    fused_free, fused_k8 = phase_fused_kernel(fused_cfgs, pools)
    fused_results, fused_launches = phase_main_path("fused", fused_cfgs, pools, CALLS)
    split_results, riccati_launches = phase_main_path("split", split_cfgs, pools, CALLS)
    riccati["launches"] = riccati_launches
    for name, cfg in fused_cfgs.items():
        idx = torch.as_tensor(np.random.default_rng(1).permutation(POOL)[:BATCH], device="cuda")
        stage_ms = timed_stages(cfg, gather(pools[name], idx))
        fused_results[name]["stage_ms"] = stage_ms
        log(f"[5] fused {name}: CUDA-event time of each stage's launch (B, ms): {stage_ms}")
    fused_free["launches"] = fused_k8["launches"] = fused_launches
    phase_cpu_check(fused_cfgs, split_cfgs, pools)

    log(json.dumps({"build_s": build_s, "fused_free_kernel": fused_free,
                    "main_path": {"fused": fused_results, "split": split_results},
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
