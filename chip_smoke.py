#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`kissmpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. build the CUDA Riccati kernel from `kissmpc_tpu_torch/csrc/riccati.cu`;
2. hold the kernel against its plain PyTorch version (`ops/lqr.py`) on the
   card: B=8192, N=50, float32 on LQR data from a real IPM iterate of the
   K=8 benchmark batch, and float64 at B=64; time both with CUDA events;
3. drive the main path, `solve_batch` with the "split" backend, at the
   benchmark's configurations (`bench.py`): N=50, B=8192, float32,
   32 IPM iterations plus staged refinement, obstacle-free and K=8 circles
   with 2 dynamic tracks.  One warm-up and 5 timed calls each, on distinct
   batches drawn from a pool of 16384.  The Riccati kernel's launch count
   must equal the IPM iterations run;
4. check 64 scenarios of each configuration against the port's CPU path,
   in float64 and in float32.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

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


def configs():
    from kissmpc_tpu_torch import MPCConfig

    def make(K, stages, **solver):
        cfg = MPCConfig(horizon=N, time_step=0.041, max_obstacles=K)
        return cfg.replace(solver=dataclasses.replace(
            cfg.solver, iterations=32, refine_stages=stages,
            solve_backend="split", **solver,
        ))

    return {
        "free": make(0, STAGES_FREE),
        "k8_dyn2": make(8, STAGES_OBST, mu_sigma_max=0.7),
    }


def phase_build():
    from kissmpc_tpu_torch.ops import riccati

    t0 = time.perf_counter()
    lib = riccati.build()
    riccati._library()
    build_s = time.perf_counter() - t0
    report = lib.with_suffix(".log").read_text().splitlines()
    for line in report:
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"[1] built {lib.name} in {build_s:.3f} s")
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


def phase_main_path(cfgs, pools):
    import torch

    from kissmpc_tpu_torch import solve_batch
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.solver.problem import gather

    rng = np.random.default_rng(0)
    results = {}
    solve_lqr_cuda.launches = 0
    for name, cfg in cfgs.items():
        pool = pools[name]
        expected = cfg.solver.iterations + sum(it for _, it, _ in cfg.solver.refine_stages)
        lat, conv = [], []
        for call in range(1 + CALLS):
            idx = torch.as_tensor(rng.permutation(POOL)[:BATCH], device="cuda")
            batch = gather(pool, idx)
            torch.cuda.synchronize()
            before = solve_lqr_cuda.launches
            t0 = time.perf_counter()
            sol = solve_batch(cfg, batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launched = solve_lqr_cuda.launches - before
            if launched != expected:
                fail(f"{name}: Riccati launched {launched} times, expected {expected}")
            if sol.controls.shape != (BATCH, N, 2) or sol.states.shape != (BATCH, N + 1, 3):
                fail(f"{name}: solution shapes {sol.states.shape} {sol.controls.shape}")
            if not (torch.isfinite(sol.controls).all() and torch.isfinite(sol.states).all()):
                fail(f"{name}: non-finite solution")
            frac = float(sol.diagnostics.converged.float().mean())
            log(f"[3] {name} call {call}{' (warm-up)' if call == 0 else ''}: "
                f"{elapsed * 1e3:.3f} ms, converged {frac:.4f}, {launched} Riccati launches")
            if call:
                lat.append(elapsed * 1e3)
                conv.append(frac)
        p50 = float(np.percentile(lat, 50))
        results[name] = {
            "batch": BATCH,
            "calls": CALLS,
            "latency_p50_ms": p50,
            "latency_max_ms": max(lat),
            "solves_per_s": BATCH / (p50 / 1e3),
            "converged_fraction": float(np.mean(conv)),
            "riccati_launches_per_call": expected,
        }
        log(f"[3] {name}: " + json.dumps(results[name]))
    total = solve_lqr_cuda.launches
    floors = {"free": 0.95, "k8_dyn2": 0.90}
    for name, floor in floors.items():
        if results[name]["converged_fraction"] < floor:
            fail(f"{name}: converged fraction {results[name]['converged_fraction']} < {floor}")
    if total == 0:
        fail("the main path never launched the Riccati kernel")
    return results, total


def phase_cpu_check(cfgs, pools):
    """64 scenarios of each configuration through the base solve on the
    card and on the CPU (no refinement, so both solve the same batch).

    float64: the same code must agree to round-off on every scenario, with
    identical converged flags (controls to 1e-6, the CPU parity budget of
    tests/test_torch_ipm.py).  float32, the main path's type: converged flags
    agree on at least 62 of 64, and the controls of the scenarios both
    report converged agree within the f32 budget of tests/test_ipm_fused.py
    (1e-3 free, 2e-3 with obstacles) for at least 95% of them.  f32 reports
    convergence at a stationarity of 50*sqrt(eps) ~ 1.7e-2, so two
    converged f32 solves can differ near 1e-3 in flat directions, and
    unconverged ones stop at iterates that drift apart under any change of
    summation order: the maximum is printed, not gated.
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

    for name, tol in (("free", 1e-3), ("k8_dyn2", 2e-3)):
        cfg = cfgs[name]
        sub = gather(pools[name], torch.arange(64, device="cuda"))

        c_card, c_cpu, diff = compare(cfg, Problem(*(x.double() for x in sub)))
        log(f"[4] {name} f64: flags agree {int((c_card == c_cpu).sum())}/64, "
            f"converged {int(c_card.sum())}, max control diff {float(diff.max()):.3e} "
            f"(tol 1e-6)")
        if (c_card != c_cpu).any() or not float(diff.max()) <= 1e-6:
            fail(f"{name}: card and CPU paths disagree in float64")

        c_card, c_cpu, diff = compare(cfg, sub)
        both = c_card & c_cpu
        within = float(np.mean(diff[both] <= tol)) if both.any() else 0.0
        log(f"[4] {name} f32: flags agree {int((c_card == c_cpu).sum())}/64, converged "
            f"{int(both.sum())} on both, {within:.4f} of them within {tol} "
            f"(max {float(diff[both].max()) if both.any() else float('nan'):.3e}), "
            f"{float(diff.max()):.3e} over all")
        if (c_card != c_cpu).sum() > 2 or within < 0.95:
            fail(f"{name}: card and CPU paths disagree in float32")


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")

    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    build_s = phase_build()
    cfgs = configs()
    t0 = time.perf_counter()
    pools = {
        "free": free_problems(cfgs["free"], POOL, seed=0),
        "k8_dyn2": obstacle_problems(cfgs["k8_dyn2"], POOL, seed=0, n_dynamic=2),
    }
    torch.cuda.synchronize()
    log(f"pools of {POOL} built on the card in {time.perf_counter() - t0:.3f} s")

    kernel = phase_kernel(cfgs["k8_dyn2"], pools["k8_dyn2"])
    results, launches = phase_main_path(cfgs, pools)
    kernel["launches"] = launches
    for r in results.values():
        # Share of the call's wall time that its Riccati launches take, at
        # the kernel's B=8192 time (refinement sub-batches are smaller).
        r["riccati_share_est"] = r["riccati_launches_per_call"] * kernel["ms"] / r["latency_p50_ms"]
    phase_cpu_check(cfgs, pools)

    log(json.dumps({"build_s": build_s, "main_path": results,
                    "total_s": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
