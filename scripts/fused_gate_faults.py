#!/usr/bin/env python3
"""Planted faults of the fused kernel's elastic branch against the gates of
chip_smoke.py's phase 4, on one NVIDIA GPU.

    python3 scripts/fused_gate_faults.py

Phase 4 holds the fused kernel against its plain version with two gates: at
one iteration the solutions agree within 1e-4 of their scale plus twice the
plain version's own f32-vs-f64 gap; at 32 iterations the converged flags
differ on at most max(1% of the batch, twice the plain version's own flag
changes under a one-ulp nudge of x0, up or down), and 95% of the scenarios
converged on both agree within 2e-3.  This script shows where a faulty
elastic branch lands against those limits.  It compiles
`kissmpc_tpu_torch/csrc/ipm_fused.cu` and one copy per planted fault into a
temporary directory (the checkout is left as it is), runs each build on
k8_dyn2_elastic (N=50, B=8192, float32, the first half of chip_smoke.py's
pool) and prints both gates' readings per build, then one JSON line.  It
exits non-zero if the kernel as written fails a gate or a planted fault
passes both.
"""

import concurrent.futures
import contextlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> (text of ipm_fused.cu, its replacement); each text occurs once.
FAULTS = {
    "as written": (),
    "e update dropped": ("Eob[row] = Eob[row] + alpha * st.de;", "(void)st.de;"),
    "rho_e * e left out of the merit": ("if (ELASTIC) obj = obj + p.rho_e * s_el;", ""),
    "no fraction to the boundary on e": ("alpha_s = minp(alpha_s, ftb(e, st.de));", ""),
    "sig_e = mu / e instead of mu / e^2": (
        "clipp(mu / (e_safe * e_safe), 0.f, kSigmaMax)", "clipp(mu / e_safe, 0.f, kSigmaMax)"),
}


def build_all(tmp: Path):
    """One library per entry of FAULTS, compiled in parallel into ``tmp``."""
    from kissmpc_tpu_torch.ops import _build, ipm_fused

    text = ipm_fused.SOURCE.read_text()

    def one(i, fault):
        src = text
        if fault:
            old, new = fault
            if src.count(old) != 1:
                raise SystemExit(f"fused_gate_faults: {old!r} is not in ipm_fused.cu once")
            src = src.replace(old, new)
        path = tmp / f"fault{i}.cu"
        path.write_text(src)
        return ipm_fused.bind(_build.load(path, f"fault{i}", build_dir=tmp))

    with concurrent.futures.ThreadPoolExecutor(len(FAULTS)) as pool:
        return list(pool.map(one, range(len(FAULTS)), FAULTS.values()))


@contextlib.contextmanager
def kernel_library(lib):
    """Route `solve_batch_fused` to the loaded library ``lib``."""
    from kissmpc_tpu_torch.ops import ipm_fused

    real = ipm_fused._library
    ipm_fused._library = lambda: lib
    try:
        yield
    finally:
        ipm_fused._library = real


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_gate_faults: CUDA is not available")

    import chip_smoke as cs
    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfg = cs.configs("fused")["k8_dyn2_elastic"]
    pool = obstacle_problems(cfg, cs.POOL, seed=0, n_dynamic=2)
    batch = gather(pool, torch.arange(cs.BATCH, device="cuda"))
    ref = cs.plain_reference(cfg, batch)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        results = {}
        for (name, fault), lib in zip(FAULTS.items(), libs):
            with kernel_library(lib):
                g = cs.fused_gates(ref, solve_batch_fused(cfg, batch, iterations=1),
                                   solve_batch_fused(cfg, batch, iterations=cs.FUSED_ITERATIONS),
                                   2e-3)
            torch.cuda.synchronize()
            results[name] = {k: v for k, v in g.items() if k != "scale"}
            print(f"{name}: one iteration max|kernel-plain| {g['err1']:.3e} (tol {g['tol1']:.3e}) "
                  f"{'passes' if g['ok_one'] else 'FAILS'}; {cs.FUSED_ITERATIONS} iterations: "
                  f"converged {g['converged']:.5f} (plain {g['plain_converged']:.5f}), flags "
                  f"differ on {g['flips']} (limit {g['flip_limit']:g}), {g['within']:.5f} of "
                  f"{g['both']} converged on both within 2e-3 "
                  f"{'passes' if g['ok_full'] else 'FAILS'}", flush=True)
    print(json.dumps({"batch": cs.BATCH, "flag_noise_up_down": ref["noises"],
                      "builds": results}), flush=True)
    written = results["as written"]
    if not (written["ok_one"] and written["ok_full"]):
        raise SystemExit("fused_gate_faults: the kernel as written fails phase 4's gates")
    escaped = [n for n, g in results.items() if n != "as written" and g["ok_one"] and g["ok_full"]]
    if escaped:
        raise SystemExit(f"fused_gate_faults: planted faults pass both gates: {escaped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
