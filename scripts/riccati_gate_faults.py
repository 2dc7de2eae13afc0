#!/usr/bin/env python3
"""Whether chip_smoke.py's phase-2 gate fails a wrong Riccati kernel, and
how much of the kernel's gap to the float64 solve its fused multiply-adds
make, on one NVIDIA GPU.

    python3 scripts/riccati_gate_faults.py

On phase 2's LQR data (chip_smoke.py's `lqr_from_iterate` on the first
8192 scenarios of its K=8 pool, N=50), at B = 8192 and 164 in float32 and
float64, it holds four kinds of build to `chip_smoke.riccati_gate` (each
output dx, du, K, k of each scenario within its own tolerance):

- `kissmpc_tpu_torch/csrc/riccati.cu` as written;
- the same source with FMA contraction off (nvcc ``-fmad=false``);
- the earlier one-thread-per-scenario kernel
  (`scripts/riccati_design_sweep.py`'s EARLIER_SOURCE);
- copies of the source with one planted fault each (FAULTS below: three
  in the rollout, whose gains stay right, two in the sweep).

All are compiled into a temporary directory; the checkout is left as it
is.  Beside each verdict it prints the earlier gate's: one tolerance over
all four outputs of every scenario (1e-4 of the largest magnitude plus
twice the plain version's largest f32-vs-f64 gap; float64 1e-9 of the
largest magnitude), which one ill-conditioned scenario widens for all.
For each float32 case it prints, per output, the factor c that a
tolerance of 1e-4 of each scenario's scale plus c times the plain
version's own f32-vs-f64 gap there would need to pass the build, held
against the plain version and against the float64 solve, with the
scenarios that need the most; and, for the three correct builds, each
output's largest gap to the float64 solve beside the plain version's, and
in how many scenarios the build is the further of the two.  It ends with
one JSON line and exits non-zero if a correct build fails the gate or a
planted fault passes it.
"""

import concurrent.futures
import contextlib
import ctypes
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> (text of riccati.cu, its replacement); each text occurs once.
FAULTS = {
    "rollout: feedforward k halved": (
        "        T acc = cur.g[6 + i];\n", "        T acc = T(0.5) * cur.g[6 + i];\n"),
    "rollout: defect d 1% too large": (
        "        xn[i] = s1 + s2 + cur.dv[i];\n",
        "        xn[i] = s1 + s2 + T(1.01) * cur.dv[i];\n"),
    "rollout: B's columns swapped": (
        "for (int j = 0; j < 2; ++j) s2 += cur.bm[i * 2 + j] * u[j];",
        "for (int j = 0; j < 2; ++j) s2 += cur.bm[i * 2 + j] * u[1 - j];"),
    "sweep: qu left out of k": (
        "    T s = r < 3 ? T(0) : v.qu[i];\n", "    T s = T(0);\n"),
    "sweep: Quu of the step before": (
        "for (int i = 0; i < 4; ++i) v.quu[i] = x.Quu[k * 4 + i];",
        "for (int i = 0; i < 4; ++i) v.quu[i] = x.Quu[(k > 0 ? k - 1 : k) * 4 + i];"),
}
AS_WRITTEN = "as written"
NO_FMA = "as written, -fmad=false"
EARLIER = "earlier kernel"
CORRECT = (AS_WRITTEN, NO_FMA, EARLIER)


def builds(tmp):
    """{name: bound library}: the source, its FMA-off build and one copy
    per fault, compiled in parallel."""
    from kissmpc_tpu_torch.ops import _build, riccati

    text = riccati.SOURCE.read_text()
    sys.path.insert(0, str(ROOT / "scripts"))
    import riccati_design_sweep

    jobs = {AS_WRITTEN: (text, ()), NO_FMA: (text, ("-fmad=false",)),
            EARLIER: (riccati_design_sweep.EARLIER_SOURCE, ())}
    for name, (old, new) in FAULTS.items():
        if text.count(old) != 1:
            raise SystemExit(f"riccati_gate_faults: {old.strip()!r} is not in riccati.cu once")
        jobs[name] = (text.replace(old, new), ())

    def one(i, name, text, flags):
        path = tmp / f"build{i}.cu"
        path.write_text(text)
        lib = _build.load(path, f"build{i}", build_dir=tmp, flags=flags)
        if name == EARLIER:  # the same launchers, nothing else
            for fn in (lib.kissmpc_riccati_f32, lib.kissmpc_riccati_f64):
                fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_double, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            return lib
        return riccati.bind(lib)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(one, i, name, *job)
                   for i, (name, job) in enumerate(jobs.items())}
        return {name: f.result() for name, f in futures.items()}


@contextlib.contextmanager
def routed(lib):
    """Route `solve_lqr_cuda` to the loaded library ``lib``."""
    from kissmpc_tpu_torch.ops import riccati

    real_lib = riccati._library
    riccati._library = lambda: lib
    try:
        yield
    finally:
        riccati._library = real_lib


def needed_factors(got, data, reg, top=3):
    """Per output of a float32 solve: the least c with which every scenario
    b would pass 1e-4 scale_b + c |plain - f64|_b, held against the plain
    version ("vs plain") and against the f64 solve ("vs f64"), and the
    ``top`` scenarios nearest the limit at c = 2 vs plain, each (b,
    |build - plain|, |build - f64|, |plain - f64|, scale)."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr

    ref = solve_lqr(data, reg)
    ref64 = solve_lqr(LQRData(*(x.double() for x in data)), reg)
    B, out = data.A.shape[0], {}
    for name, g, r, r64 in zip(("dx", "du", "K", "k"), got, ref, ref64):
        g, r, r64 = (x.reshape(B, -1).double() for x in (g, r, r64))
        scale = r.abs().amax(1).clamp(min=1.0)
        err, k64, p64 = ((a - b).abs().amax(1) for a, b in ((g, r), (g, r64), (r, r64)))
        tiny = torch.finfo(torch.float64).tiny
        need = (err - 1e-4 * scale).clamp(min=0) / p64.clamp(min=tiny)
        need64 = (k64 - 1e-4 * scale).clamp(min=0) / p64.clamp(min=tiny)
        worst = (err / (1e-4 * scale + 2.0 * p64)).topk(min(top, B)).indices.tolist()
        out[name] = {"vs plain": float(need.max()), "vs f64": float(need64.max()),
                     "top": [(b, float(err[b]), float(k64[b]), float(p64[b]), float(scale[b]))
                             for b in worst]}
    return out


def earlier_gate(got, data, reg):
    """The gate phase 2 had before it held each output of each scenario to
    its own tolerance: (passes, max |kernel - plain|, tolerance)."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    ref = solve_lqr(data, reg)
    scale = max(1.0, *(float(x.abs().max()) for x in ref))
    err = gap(got, ref)
    if data.A.dtype == torch.float32:
        tol = 1e-4 * scale + 2.0 * gap(ref, solve_lqr(LQRData(*(x.double() for x in data)), reg))
    else:
        tol = 1e-9 * scale
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    return finite and err <= tol, err, tol


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("riccati_gate_faults: CUDA is not available")

    import chip_smoke as cs
    from kissmpc_tpu_torch.ops.lqr import LQRData
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfg = cs.configs("split")["k8_dyn2"]
    reg = cfg.solver.reg
    pool = obstacle_problems(cfg, cs.POOL, seed=0, n_dynamic=2)
    data = cs.lqr_from_iterate(cfg, gather(pool, torch.arange(cs.BATCH, device="cuda")))
    cases = [(dtype, B) for dtype in (torch.float32, torch.float64) for B in (cs.BATCH, 164)]
    results, wrong = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        libs = builds(Path(tmp))
        for name, lib in libs.items():
            results[name] = {}
            for dtype, B in cases:
                sub = LQRData(*(x.to(dtype)[:B].contiguous() for x in data))
                with routed(lib):
                    got = solve_lqr_cuda(sub, reg)
                    torch.cuda.synchronize()
                gate = cs.riccati_gate(got, sub, reg)
                old_ok, old_err, old_tol = earlier_gate(got, sub, reg)
                key = f"{str(dtype)[6:]} B={B}"
                results[name][key] = {"ok": gate["ok"], "outputs": gate["outputs"],
                                      "earlier_ok": old_ok, "earlier_err": old_err,
                                      "earlier_tol": old_tol}
                if dtype == torch.float32:
                    results[name][key]["needed"] = needed = needed_factors(got, sub, reg)
                worst, o = max(gate["outputs"].items(), key=lambda kv: kv[1]["ratio"])
                print(f"{name:>32} {key:>13}: gate {'passes' if gate['ok'] else 'FAILS'} "
                      f"({worst} of scenario {o['scenario']} at {o['ratio']:.4g} of its limit: "
                      f"{o['err_at']:.3e} against {o['tol_at']:.3e}); the earlier gate "
                      f"{'passes' if old_ok else 'fails'} ({old_err:.3e} against {old_tol:.3e})",
                      flush=True)
                if dtype == torch.float32:
                    for out, v in needed.items():
                        print(f"{'':>32} {key:>13}: {out:>2} needs c = {v['vs plain']:.4g} vs "
                              f"plain, {v['vs f64']:.4g} vs f64; most at (b, |build-plain|, "
                              f"|build-f64|, |plain-f64|, scale) " + ", ".join(
                                  f"({b}, {e:.3e}, {k:.3e}, {q:.3e}, {s:.3e})"
                                  for b, e, k, q, s in v["top"]), flush=True)
                if name in CORRECT:
                    if not gate["ok"]:
                        wrong.append((name, key))
                    if dtype == torch.float32:
                        for out, v in gate["outputs"].items():
                            print(f"{'':>32} {key:>13}: {out:>2} largest gap to the f64 solve: "
                                  f"kernel {v['kernel64']:.4e}, plain {v['plain64']:.4e}; the "
                                  f"kernel further in {v['kernel_further']} of {B} scenarios",
                                  flush=True)
                elif gate["ok"]:
                    wrong.append((name, key))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "builds": results}), flush=True)
    if wrong:
        raise SystemExit(f"riccati_gate_faults: a correct build failed or a fault passed: "
                         f"{wrong}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
