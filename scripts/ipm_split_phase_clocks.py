#!/usr/bin/env python3
"""Where one scenario of the split step kernel spends its time, by SM
clock, on one NVIDIA GPU.

    python3 scripts/ipm_split_phase_clocks.py [--root DIR]

Compiles a copy of ``DIR/kissmpc_tpu_torch/csrc/ipm_split.cu`` (``DIR`` the
checkout by default; another tree, such as an unpacked ``git archive`` of
an earlier commit, is measured with its own package) into a temporary
directory in which the first thread of block 0 reads `clock64()` between
the step kernel's phases: the loads, pass 1 (the steps, the fractions to
the boundary, their reductions), the adjoint sweep, pass 2 (the merits),
the acceptance, and pass 3 (the update and the next mu).  In the kernel
of one block per scenario, thread 0 runs the sweep beside pass 2: its
sweep is clocked alone, and "pass 2" is its wait at the barrier after the
merits.  In the earlier kernel of one warp per scenario, every lane waits
for lane 0's sweep.  The edits are chosen by the source's text: each of
the two designs has its set.

On the iterate after chip_smoke.py's SPLIT_CHECK_ITERATIONS plain
iterations it launches the copy through the tree's own wrapper at k8_dyn2
B=8192 and 164 and at the node (N=7, B=1), in float32 and float64, once
after a warm-up each, and prints each phase's cycles and share, the block's
total, the ptxas lines of the copy, and one JSON line with the card's name
and power limit.  The arithmetic is unchanged, so the copy is also held to
chip_smoke.py's gates (`split_kernels_check`).
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PHASES = ("loads", "pass 1", "sweep", "pass 2", "acceptance", "pass 3")
CLOCK = ("long long clk[6] = {0}, clk_t0 = clock64(), clk_mark = clk_t0;\n"
         "#define CLK(i) do { const long long now_ = clock64(); clk[i] += now_ - clk_mark; "
         "clk_mark = now_; } while (0)\n")
CLOCK_OUT = ("if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
             "    for (int i = 0; i < 6; ++i) kissmpc_clk[i] = clk[i];\n"
             "    kissmpc_clk[6] = clock64() - clk_t0;\n  }\n")
GLOBAL = ('#include "device_math.cuh"\n',
          '#include "device_math.cuh"\n\n__device__ long long kissmpc_clk[7];\n')
GETTER = """
extern "C" int kissmpc_split_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, kissmpc_clk, sizeof(long long) * 7));
}
"""

# The earlier step kernel: one warp per scenario, every lane through every
# phase; lane 0 of block 0's first warp (scenario 0) reads the clock.
EDITS_WARP = [
    GLOBAL,
    ("  if (b >= p.B) return;  // the whole warp leaves together\n",
     "  if (b >= p.B) return;  // the whole warp leaves together\n  " + CLOCK),
    ("  const T tau = T(p.tau);\n\n  // Pass 1:", "  const T tau = T(p.tau);\n  CLK(0);\n\n  // Pass 1:"),
    ("  step_inf = warp_max(step_inf);\n", "  step_inf = warp_max(step_inf);\n  CLK(1);\n"),
    ("  rho = __shfl_sync(kFull, rho, 0);\n", "  rho = __shfl_sync(kFull, rho, 0);\n  CLK(2);\n"),
    ("warp_sum(logs[c]) + rho * warp_sum(res[c]);\n",
     "warp_sum(logs[c]) + rho * warp_sum(res[c]);\n  CLK(3);\n"),
    ("  a_nu = minp(a_nu, alpha);\n\n  // Pass 3",
     "  a_nu = minp(a_nu, alpha);\n  CLK(4);\n\n  // Pass 3"),
    ("    alpha_out[b] = alpha;\n  }\n}\n",
     "    alpha_out[b] = alpha;\n  }\n  CLK(5);\n  " + CLOCK_OUT + "}\n"),
]

# The step kernel of one block per scenario: thread 0 runs the adjoint
# sweep while the other threads evaluate the merits.  Each edit replaces a
# "Phase clocks" comment line of the source.
EDITS_BLOCK = [
    GLOBAL,
    ("  // Phase clocks start here.\n", "  " + CLOCK),
    ("  // Phase clocks: loads.\n", "  CLK(0);\n"),
    ("  // Phase clocks: pass 1.\n", "  CLK(1);\n"),
    ("    // Phase clocks: sweep.\n", "    CLK(2);\n"),
    ("  // Phase clocks: pass 2.\n", "  CLK(3);\n"),
    ("  // Phase clocks: acceptance.\n", "  CLK(4);\n"),
    ("  // Phase clocks: pass 3.\n", "  CLK(5);\n  " + CLOCK_OUT),
]


def instrumented(text):
    """The source with the clock reads of its edit set, and the getter."""
    edits = EDITS_BLOCK if "// Phase clocks start here.\n" in text else EDITS_WARP
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ipm_split_phase_clocks: {old[:60]!r} is not in the source once")
        text = text.replace(old, new)
    return text + GETTER


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree whose package and kernel are measured")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ipm_split_phase_clocks: CUDA is not available")
    import chip_smoke as cs
    from kissmpc_tpu_torch.ops import _build, ipm_split
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem, gather

    k8 = cs.configs("split")["k8_dyn2"]
    node = cs.node_config()
    pool = obstacle_problems(k8, cs.BATCH, seed=0, n_dynamic=2)
    cases = [("k8_dyn2", k8, gather(pool, torch.arange(B, device="cuda")), B)
             for B in (cs.BATCH, cs.REFINE_CHECK_BATCH)]
    cases.append(("node", node, obstacle_problems(node, 1, seed=12, n_dynamic=2), 1))
    out, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ipm_split_clocks.cu"
        path.write_text(instrumented(ipm_split.SOURCE.read_text()))
        for header in ipm_split.SOURCE.parent.glob("*.cuh"):  # the copy's includes
            shutil.copy(header, Path(tmp) / header.name)
        lib = ipm_split.bind(_build.load(path, "ipm_split_clocks", build_dir=Path(tmp)))
        ptxas = [line.strip() for line in
                 next(Path(tmp).glob("libipm_split_clocks-*.log")).read_text().splitlines()
                 if "registers" in line or "stack frame" in line or "Compiling entry" in line]
        for line in ptxas:
            print(f"ptxas: {line}", flush=True)
        lib.kissmpc_split_clocks.argtypes = [ctypes.c_void_p]
        lib.kissmpc_split_clocks.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for dtype in (torch.float32, torch.float64):
            for name, cfg, problems, B in cases:
                problems = Problem(*(x.to(dtype) for x in problems))
                res = cs.split_kernels_check(cfg, problems, cs.SPLIT_CHECK_ITERATIONS, lib,
                                             stream)
                if not res["ok"]:
                    failed.append(f"{name} {str(dtype)[6:]} B={B}")
                pr, it, mu, corr, data, sol = res["launched"]
                ipm_split._step(lib, stream, cfg, pr, it, mu, data, sol, corr)
                torch.cuda.synchronize()
                clk = (ctypes.c_longlong * 7)()
                _build.check_launch(lib, lib.kissmpc_split_clocks(clk), "clock read")
                total = clk[6]
                key = f"{name} {str(dtype)[6:]} B={B}"
                out[key] = {**{ph: clk[i] for i, ph in enumerate(PHASES)}, "total": total}
                print(f"{key}: {total} cycles in block 0; " + ", ".join(
                    f"{ph} {clk[i]} ({clk[i] / max(total, 1):.3f})"
                    for i, ph in enumerate(PHASES)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": str(args.root), "ptxas": ptxas, "clocks": out}),
          flush=True)
    if failed:
        raise SystemExit(f"ipm_split_phase_clocks: the instrumented copy fails the gates: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
