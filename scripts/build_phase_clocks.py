#!/usr/bin/env python3
"""Where the problem build kernel and the split init and diagnostics
kernels spend their time, on one NVIDIA GPU.

    python3 scripts/build_phase_clocks.py [--root DIR] [--only build|init|diagnostics]

The build: compiles a copy of ``DIR/kissmpc_tpu_torch/csrc/problem_build.cu``
(``DIR`` the checkout by default; another tree, such as an unpacked ``git
archive`` of an earlier commit, is measured with its own package) into a
temporary directory, in which the leading lane of every scenario reads
`clock64()` between the kernel's phases: the rows that do not depend on
the obstacles, the ranking, the tracks, the warm start, the repair passes,
the moved test and the completion rollout (the last one zero where the
scenario is not rolled out), and, in the kernel that stages its rows in
shared memory, the rows' store.  Each scenario's cycles land in a device
array; the script prints, per case, the mean over the scenarios rolled
out (its rollout phase over ROLLED_CYCLES) and over the others of each
phase, the slowest scenario's total, and
the launch's time by CUDA events (`chip_smoke.kernel_ms`).  The copy
computes what the source computes, so it is also held to chip_smoke.py's
gate (`build_kernel_check`).  The cases are phase 18's: the pool's inputs
(K=8, N=50, B=16384), the fleet's first tick (B=4096), the perception
tick's (B=2048), the node's (N=7, B=1) and 512 node-shaped scenarios, in
float32 and float64.

The init: there is no phase inside a scenario to clock (every family is
one pass over its entries), so its counterpart is event timing by family:
copies of ``csrc/ipm_split.cu`` whose init kernel skips one family (the
controls' box rows, the states' box rows, the obstacle rows) or all three
are timed with `kernel_ms` beside the source at k8_dyn2 B=8192, 1024, 328
and 164 (float32) and the node (B=1); a family's share is the time it
adds.  The edits are chosen by
the source's text: the earlier kernel (lanes over stages) and the kernel with
a marker comment before each family's loop have a set each.

The diagnostics: the same event timing by family, of copies of
``csrc/ipm_split.cu`` whose diagnostics kernel skips the box families (the
states' and the controls' entries), the obstacle constraints, the
per-stage rows (the linearisation and the defects; in the kernel with
chunks also the normal terms' sums), the adjoint sweep (lane 0's, or the
chunks' suffix scans), or all four, at k8_dyn2 B=8192 (float32 and
float64), 1024, 328 and 164 and the node, on the iterate after
SPLIT_CHECK_ITERATIONS plain iterations.  The earlier kernel (one warp per
scenario, lanes over stages) and the kernel with marker comments have a
set of edits each; their registers and stack come from the copies' ptxas
lines.  Run with ``--root`` on an unpacked ``git archive`` of an earlier
commit, in turns with this tree, to compare the two kernels in one call.
With ``--designs`` the kernel with marker comments is also timed with
other launch bounds.

Last, one JSON line with the card's name and power limit, the ptxas lines
of the copies, the clocks and the times.
"""

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PHASES = ("rows", "ranking", "tracks", "warm start", "repair", "moved", "rollout", "store")
CLK_MAX = 16384  # scenarios whose clocks are kept
CLOCK_DEFS = f"""
__device__ long long kissmpc_clk[{CLK_MAX} * 9];
#define CLK_START long long clk_[8] = {{0}}, clk_t0 = clock64(), clk_mark = clk_t0;
#define CLK(i) do {{ const long long now_ = clock64(); clk_[i] += now_ - clk_mark; \\
                     clk_mark = now_; }} while (0)
#define CLK_OUT(leader) do {{ if ((leader) && b < {CLK_MAX}) {{ \\
    for (int i_ = 0; i_ < 8; ++i_) kissmpc_clk[b * 9 + i_] = clk_[i_]; \\
    kissmpc_clk[b * 9 + 8] = clock64() - clk_t0; }} }} while (0)
"""
GETTERS = f"""
extern "C" int kissmpc_build_clocks(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, kissmpc_clk,
                                               sizeof(long long) * {CLK_MAX} * 9));
}}
extern "C" int kissmpc_build_clocks_zero() {{
  static long long zeros[{CLK_MAX} * 9];
  return static_cast<int>(cudaMemcpyToSymbol(kissmpc_clk, zeros, sizeof(zeros)));
}}
"""
INCLUDE = '#include "device_math.cuh"\n'

# The earlier build kernel: one warp per scenario, global rows; lane 0 reads
# the clock.  Every return after the start writes the clocks out.
BUILD_EDITS_WARP = [
    (INCLUDE, INCLUDE + CLOCK_DEFS),
    ("  if (b >= p.B) return;  // the whole warp: nothing below waits on it\n",
     "  if (b >= p.B) return;  // the whole warp: nothing below waits on it\n  CLK_START\n"),
    ("  // (1) The sensor's top K and their tracks.\n",
     "  CLK(0);\n  // (1) The sensor's top K and their tracks.\n"),
    ("    if (rank >= K) continue;\n", "    CLK(1);\n    if (rank >= K) continue;\n"),
    ("  // (2) The warm start.\n", "  CLK(2);\n  // (2) The warm start.\n"),
    ("  if (K == 0 || !(p.repair || p.complete)) return;\n",
     "  CLK(3);\n  if (K == 0 || !(p.repair || p.complete)) { CLK_OUT(lane == 0); return; }\n"),
    ("  if (!p.complete) return;\n", "  CLK(4);\n  if (!p.complete) { CLK_OUT(lane == 0); return; }\n"),
    ("  if (!(moved > p.threshold)) return;\n",
     "  CLK(5);\n  if (!(moved > p.threshold)) { CLK_OUT(lane == 0); return; }\n"),
    ("      W[(t + 1) * 3 + 2] = th;\n    }\n  }\n}\n",
     "      W[(t + 1) * 3 + 2] = th;\n    }\n  }\n  CLK(6);\n  CLK_OUT(lane == 0);\n}\n"),
]

# The kernel that stages its rows in shared memory: each edit replaces a
# "Phase clocks" comment line of the source; it leaves at one place.
BUILD_EDITS_MARKED = [(INCLUDE, INCLUDE + CLOCK_DEFS),
                      ("  // Phase clocks start here.\n", "  CLK_START\n")]
BUILD_EDITS_MARKED += [(f"  // Phase clocks: {ph}.\n", f"  CLK({i});\n")
                       for i, ph in enumerate(PHASES)]
BUILD_EDITS_MARKED += [("  // Phase clocks end here.\n", "  CLK_OUT(lane == 0);\n")]

# The earlier init kernel (lanes over stages): each family's block skipped.
INIT_EDITS_WARP = {
    "controls": [("    if (t < N) {\n      const long long urow",
                  "    if (false) {\n      const long long urow")],
    "states": [("#pragma unroll\n    for (int i = 0; i < 3; ++i) {\n      const Bound lo = bound(*at<D>(pr.xl",
                "#pragma unroll\n    for (int i = 0; i < 0; ++i) {\n      const Bound lo = bound(*at<D>(pr.xl")],
    "obstacles": [("    if (t >= 1) {\n      const long long orow",
                   "    if (false) {\n      const long long orow")],
}
# The init kernel with a marker comment before each family's loop.
INIT_EDITS_MARKED = {fam: [(f"  // Init family: {fam}.\n", "  if (false)\n")]
                     for fam in ("controls", "states", "obstacles")}
INIT_BATCHES = (8192, 1024, 328, 164)
# The earlier diagnostics kernel (one warp per scenario, lanes over stages,
# lane 0's sweep): each part's code skipped.
DIAG_EDITS_WARP = {
    "box": [("#pragma unroll\n      for (int i = 0; i < 3; ++i) {\n        const Bound lo = "
             "bound(*at<D>(pr.xl, b * 3 + i)), hi = bound(*at<D>(pr.xu, b * 3 + i));",
             "#pragma unroll\n      for (int i = 0; i < 0; ++i) {\n        const Bound lo = "
             "bound(*at<D>(pr.xl, b * 3 + i)), hi = bound(*at<D>(pr.xu, b * 3 + i));"),
            ("#pragma unroll\n        for (int j = 0; j < 2; ++j) {\n          const Bound lo = "
             "bound(*at<D>(pr.cl, b * 2 + j)), hi = bound(*at<D>(pr.cu, b * 2 + j));",
             "#pragma unroll\n        for (int j = 0; j < 0; ++j) {\n          const Bound lo = "
             "bound(*at<D>(pr.cl, b * 2 + j)), hi = bound(*at<D>(pr.cu, b * 2 + j));")],
    "obstacles": [("      if (t >= 1 && K > 0) {\n        const long long orow",
                   "      if (false) {\n        const long long orow")],
    "stage rows": [("        double sth, cth;\n        sincos_rd(X[t * 3 + 2], sth, cth);\n"
                    "        r[5] = cth * dt;\n        r[6] = sth * dt;\n"
                    "        r[7] = -v * sth * dt;\n        r[8] = v * cth * dt;\n"
                    "        const D* X1 = X + (t + 1) * 3;\n"
                    "        resid = maxp(resid, fabs(X[t * 3] + v * cth * dt - X1[0]));\n"
                    "        resid = maxp(resid, fabs(X[t * 3 + 1] + v * sth * dt - X1[1]));\n"
                    "        resid = maxp(resid, fabs(X[t * 3 + 2] + om * dt - X1[2]));\n",
                    "        r[5] = dt;\n        r[6] = 0.0;\n        r[7] = 0.0;\n"
                    "        r[8] = v * dt;\n        resid = maxp(resid, om);\n")],
    "sweep": [("    if (lane == 0) {\n      for (int j = 0; j < kLanes && top - j >= 0; ++j) {",
               "    if (false) {\n      for (int j = 0; j < kLanes && top - j >= 0; ++j) {")],
}
# The diagnostics kernel with marker comments: a family's loop or the stage
# rows' block behind `if (false)`, the scans' calls taken out.
DIAG_EDITS_MARKED = {
    "box": [(f"      // Diagnostics family: {fam}.\n", "      if (false)\n")
            for fam in ("states", "controls")],
    "obstacles": [("      // Diagnostics family: obstacles.\n", "      if (false)\n")],
    "stage rows": [("    // Diagnostics stage rows.\n", "    if (false)\n")],
    "sweep": [("    block_scan(g, c01, tot01, lane, warp);  // Diagnostics scan.\n", ""),
              ("    block_scan(h, c2, tot2, lane, warp);  // Diagnostics scan.\n", "")],
}
# With --designs, the kernel with marker comments also with its launch
# bounds asking for another count of resident blocks per SM, and with 1 or
# 2 warps per scenario in place of kOnceWarps' 4 (the same register cap:
# 16 or 32 resident blocks per SM).
DIAG_BOUNDS = "__global__ void __launch_bounds__(kOnceWarps * kLanes, {})\ndiagnostics_kernel("


def diag_warps(warps):
    """An edit of the source: the diagnostics kernel, its helpers, its
    launcher and its occupancy query with ``warps`` warps per scenario (the
    init keeps kOnceWarps)."""
    def edit(text):
        a = text.index("// Obstacle constraints of a diagnostics chunk at most")
        z = text.index("template <typename T, bool EL>\ncudaError_t launch_condense")
        region = text[a:z].replace(DIAG_BOUNDS.format(8), DIAG_BOUNDS.format(32 // warps))
        text = text[:a] + region.replace("kOnceWarps", str(warps)) + text[z:]
        for old in ("diagnostics_kernel<T><<<p.B, kOnceWarps * kLanes,",
                    "&blocks, diagnostics_kernel<T>, kOnceWarps",
                    "  out[0] = kOnceWarps;\n  out[1] = diag_chunk"):
            text = edited(text, [(old, old.replace("kOnceWarps", str(warps)))], "ipm_split.cu")
        return text
    return edit


DIAG_DESIGNS = {"bounds 6": [(DIAG_BOUNDS.format(8), DIAG_BOUNDS.format(6))],
                "2 warps": [diag_warps(2)], "1 warp": [diag_warps(1)]}
ROLLED_CYCLES = 1000  # a rollout phase longer than this ran the rollout


def edited(text, edits, what):
    """``text`` with each edit applied: a pair (old, new), where ``old``
    must appear once, or a function of the text."""
    for edit in edits:
        if callable(edit):
            text = edit(text)
            continue
        old, new = edit
        if text.count(old) != 1:
            raise SystemExit(f"build_phase_clocks: {old[:60]!r} is not in {what} once")
        text = text.replace(old, new)
    return text


def copy_source(tmp, source, text, name):
    """``text`` as ``tmp/<name>.cu`` beside copies of the shared headers."""
    for header in source.parent.glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    path = tmp / f"{name}.cu"
    path.write_text(text)
    return path


def ptxas_lines(tmp, name):
    log = next(tmp.glob(f"lib{name}-*.log")).read_text()
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "stack frame" in line or "Compiling entry" in line
            or "smem" in line]


def build_cases(cs, torch):
    """(label, cfg, inputs, options) of phase 18's build cases."""
    k8, node = cs.configs("split")["k8_dyn2"], cs.node_config()
    out = []
    for dtype in (torch.float32, torch.float64):
        d = str(dtype)[6:]
        out.append((f"pool {d}", k8, cs.pool_inputs(k8, cs.POOL, 0, dtype), {}))
        cfg, inputs = cs.fleet_inputs(dtype)
        out.append((f"fleet {d}", cfg, inputs, {}))
        if hasattr(cs, "perception_inputs"):  # an earlier tree's chip_smoke.py has none
            cfg, inputs = cs.perception_inputs(dtype)
            out.append((f"perception {d}", cfg, inputs, {}))
        node_opts = dict(sensor_radius=5.0, prediction_dt=None)
        for B, label in ((1, "node"), (cs.NODE_BUILD_BATCH, "node batch")):
            inputs = cs.build_inputs(node, B, 18, k_all=cs.NODE_BUILD_K_ALL, dtype=dtype)
            out.append((f"{label} {d}", node, inputs, node_opts))
    return out


def measure_build(args, cs, torch, tmp):
    from kissmpc_tpu_torch.ops import _build, problem_build

    text = problem_build.SOURCE.read_text()
    edits = BUILD_EDITS_MARKED if "// Phase clocks start here.\n" in text else BUILD_EDITS_WARP
    path = copy_source(tmp, problem_build.SOURCE, edited(text, edits, "problem_build.cu") + GETTERS,
                       "build_clocks")
    lib = problem_build.bind(_build.load(path, "build_clocks", build_dir=tmp))
    lib.kissmpc_build_clocks.argtypes = [ctypes.c_void_p]
    lib.kissmpc_build_clocks.restype = ctypes.c_int
    lib.kissmpc_build_clocks_zero.restype = ctypes.c_int
    ptxas = ptxas_lines(tmp, "build_clocks")
    for line in ptxas:
        print(f"ptxas (build copy): {line}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out, failed = {}, []
    for label, cfg, inputs, options in build_cases(cs, torch):
        res = cs.build_kernel_check(cfg, inputs, lib, stream(), **options)
        if not res["ok"]:
            failed.append(label)
        start, goal, obstacles, kw = res["launched"]
        run = lambda: problem_build._launch(lib, stream(), cfg, start, goal, obstacles, **kw)  # noqa: E731
        ms = cs.kernel_ms(run, reps=20, graph=True)
        _build.check_launch(lib, lib.kissmpc_build_clocks_zero(), "clock reset")
        run()
        torch.cuda.synchronize()
        B = res["B"]
        clk = (ctypes.c_longlong * (CLK_MAX * 9))()
        _build.check_launch(lib, lib.kissmpc_build_clocks(clk), "clock read")
        rows = torch.tensor(list(clk), dtype=torch.float64).reshape(CLK_MAX, 9)[:min(B, CLK_MAX)]
        rolled = rows[:, 6] > ROLLED_CYCLES
        entry = {"B": B, "ms": ms, "n_rolled": int(rolled.sum()),
                 "slowest_total": float(rows[:, 8].max()), "check": cs.describe_build_check(res)}
        for part, sel in (("rolled", rolled), ("not rolled", ~rolled)):
            if bool(sel.any()):
                mean = rows[sel].mean(0)
                entry[part] = {**{ph: float(mean[i]) for i, ph in enumerate(PHASES)},
                               "total": float(mean[8])}
        out[label] = entry
        parts = []
        for part in ("rolled", "not rolled"):
            if part in entry:
                e = entry[part]
                parts.append(f"{part}: total {e['total']:.0f}, " + ", ".join(
                    f"{ph} {e[ph]:.0f} ({e[ph] / max(e['total'], 1):.3f})" for ph in PHASES))
        print(f"build {label} B={B}: {ms:.5f} ms by events, {entry['n_rolled']} rolled out, "
              f"slowest scenario {entry['slowest_total']:.0f} cycles; mean cycles per scenario, "
              + "; ".join(parts), flush=True)
        print(f"  gate: {entry['check']}", flush=True)
    return out, ptxas, failed


def measure_init(args, cs, torch, tmp):
    from kissmpc_tpu_torch.ops import _build, ipm_split
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    text = ipm_split.SOURCE.read_text()
    sets = INIT_EDITS_MARKED if "  // Init family: controls.\n" in text else INIT_EDITS_WARP
    variants = {"source": []}
    variants.update({f"no {fam}": e for fam, e in sets.items()})
    variants["no family"] = [e for edits in sets.values() for e in edits]
    stems = {name: "init_" + name.replace(" ", "_") for name in variants}
    paths = {name: copy_source(tmp, ipm_split.SOURCE, edited(text, edits, "ipm_split.cu"),
                               stems[name]) for name, edits in variants.items()}
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:  # one nvcc per copy
        list(pool.map(lambda n: _build.build(paths[n], stems[n], build_dir=tmp), paths))
    libs = {name: ipm_split.bind(_build.load(paths[name], stems[name], build_dir=tmp))
            for name in variants}
    ptxas = [f"{name}: {line}" for name in variants for line in ptxas_lines(tmp, stems[name])]
    k8, node = cs.configs("split")["k8_dyn2"], cs.node_config()
    pool = obstacle_problems(k8, cs.BATCH, seed=0, n_dynamic=2)
    cases = [(f"k8_dyn2 B={B}", k8, gather(pool, torch.arange(B, device="cuda")))
             for B in INIT_BATCHES]
    cases.append(("node B=1", node, obstacle_problems(node, 1, seed=12, n_dynamic=2)))
    out = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, cfg, problems in cases:
        problems = Problem(*(x.contiguous() for x in problems))
        times = {}
        for turn in range(2):  # every variant twice, in turns
            for name, lib in libs.items():
                ms = cs.kernel_ms(lambda: ipm_split._init(lib, stream(), cfg, problems), reps=20,
                                  graph=True)
                times.setdefault(name, []).append(ms)
        med = {name: min(v) for name, v in times.items()}
        out[label] = {"ms": times, "added_ms": {
            fam: med["source"] - med[f"no {fam}"] for fam in sets}}
        print(f"init {label}: " + ", ".join(f"{n} {m:.5f}" for n, m in med.items())
              + " ms (best of two turns); added by " + ", ".join(
                  f"{fam} {v:.5f}" for fam, v in out[label]["added_ms"].items()), flush=True)
    return out, ptxas


def kernel_ptxas(tmp, name, kernel):
    """The ptxas lines of the entries of ``kernel`` in the copy ``name``."""
    out, keep = [], False
    for line in ptxas_lines(tmp, name):
        if "Compiling entry" in line:
            keep = kernel in line
        if keep:
            out.append(line)
    return out


def measure_diagnostics(args, cs, torch, tmp):
    from kissmpc_tpu_torch.ops import _build, ipm_split
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    text = ipm_split.SOURCE.read_text()
    sets = DIAG_EDITS_MARKED if "    // Diagnostics stage rows.\n" in text else DIAG_EDITS_WARP
    variants = {"source": []}
    variants.update({f"no {part}": e for part, e in sets.items()})
    variants["no part"] = [e for edits in sets.values() for e in edits]
    if args.designs and sets is DIAG_EDITS_MARKED:
        variants.update(DIAG_DESIGNS)
    stems = {name: "diag_" + name.replace(" ", "_") for name in variants}
    paths = {name: copy_source(tmp, ipm_split.SOURCE, edited(text, edits, "ipm_split.cu"),
                               stems[name]) for name, edits in variants.items()}
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:  # one nvcc per copy
        list(pool.map(lambda n: _build.build(paths[n], stems[n], build_dir=tmp), paths))
    libs = {name: ipm_split.bind(_build.load(paths[name], stems[name], build_dir=tmp))
            for name in variants}
    ptxas = [f"{name}: {line}" for name in variants
             for line in kernel_ptxas(tmp, stems[name], "diagnostics_kernel")]
    for line in ptxas:
        print(f"ptxas (diagnostics): {line}", flush=True)
    k8, node = cs.configs("split")["k8_dyn2"], cs.node_config()
    pool = obstacle_problems(k8, cs.BATCH, seed=0, n_dynamic=2)
    cases = [(f"k8_dyn2 B={B} float32", k8, gather(pool, torch.arange(B, device="cuda")))
             for B in INIT_BATCHES]
    cases.insert(1, ("k8_dyn2 B=8192 float64", k8,
                     Problem(*(x.to(torch.float64) for x in cases[0][2]))))
    cases.append(("node B=1 float32", node, obstacle_problems(node, 1, seed=12, n_dynamic=2)))
    out = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, cfg, problems in cases:
        problems = Problem(*(x.contiguous() for x in problems))
        it, _ = cs.split_iterate(cfg, problems, cs.SPLIT_CHECK_ITERATIONS)
        times = {}
        for turn in range(2):  # every variant twice, in turns
            for name, lib in libs.items():
                ms = cs.kernel_ms(lambda: ipm_split._diagnostics(lib, stream(), cfg, problems, it),
                                  reps=20, graph=True)
                times.setdefault(name, []).append(ms)
        best = {name: min(v) for name, v in times.items()}
        out[label] = {"ms": times, "added_ms": {
            part: best["source"] - best[f"no {part}"] for part in sets}}
        if args.designs:
            out[label]["designs_ms"] = {n: best[n] for n in variants if n in DIAG_DESIGNS}
        print(f"diagnostics {label}: " + ", ".join(f"{n} {m:.5f}" for n, m in best.items())
              + " ms (best of two turns); added by " + ", ".join(
                  f"{part} {v:.5f}" for part, v in out[label]["added_ms"].items()), flush=True)
    return out, ptxas


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree whose package and kernels are measured")
    ap.add_argument("--only", choices=("build", "init", "diagnostics"),
                    help="measure one kernel alone")
    ap.add_argument("--designs", action="store_true",
                    help="also time the diagnostics kernel's design variants (DIAG_DESIGNS)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("build_phase_clocks: CUDA is not available")
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        run = lambda kernel: args.only in (None, kernel)  # noqa: E731
        build, build_ptxas, failed = measure_build(args, cs, torch, tmp) if run("build") \
            else ({}, [], [])
        init, init_ptxas = measure_init(args, cs, torch, tmp) if run("init") else ({}, [])
        diag, diag_ptxas = measure_diagnostics(args, cs, torch, tmp) if run("diagnostics") \
            else ({}, [])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": str(args.root), "build_ptxas": build_ptxas,
                      "init_ptxas": init_ptxas, "diagnostics_ptxas": diag_ptxas, "build": build,
                      "init": init, "diagnostics": diag}), flush=True)
    if failed:
        raise SystemExit(f"build_phase_clocks: the instrumented copy fails the gate: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
