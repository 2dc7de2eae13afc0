#!/usr/bin/env python3
"""Time the split iteration's kernels as written against edited copies, on
one NVIDIA GPU.

    python3 scripts/ipm_split_design_sweep.py [--batch 8192] [--turns 2]

Each variant is `kissmpc_tpu_torch/csrc/ipm_split.cu` with one edit, built
by nvcc into a temporary directory (`ops/_build.py::load`) and bound as the
package's own build is (`ops/ipm_split.py::bind`):

- ``as_written``: the source;
- ``unrolled``: ``#pragma unroll`` on the small loops over components and
  families of a stage (`stage_steps`), so their indices into the
  scenario's arrays are constants;
- ``four_blocks``: the step kernel's launch bounds ask for 4 resident
  blocks per SM (at most 128 registers a thread);
- ``float_compute``: the float32 instance computes in float, as the data
  is stored (the arithmetic type the source replaced).

For each variant it prints ptxas' registers, stack and spills per kernel,
holds both kernels to chip_smoke.py's gates against the plain halves
(`split_kernels_check`, k8_dyn2 at ``--batch``, float32), and times each
kernel by `chip_smoke.kernel_ms` (20 launches in a CUDA graph) at k8_dyn2
``--batch`` in float32 and at the node's N=7, B=1, in turns over the
variants, ``--turns`` times.  One JSON line per variant and turn, then a
summary line with the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EDITS = {
    "as_written": [],
    "unrolled": [
        ("  for (int i = 0; i < 3; ++i) {\n    const int ix = t * 3 + i;",
         "#pragma unroll\n  for (int i = 0; i < 3; ++i) {\n    const int ix = t * 3 + i;"),
        ("    for (int fam = 2; fam < 4; ++fam) {", "#pragma unroll\n    for (int fam = 2; fam < 4; ++fam) {"),
        ("    for (int j = 0; j < 2; ++j) {\n      const int iu = t * 2 + j;",
         "#pragma unroll\n    for (int j = 0; j < 2; ++j) {\n      const int iu = t * 2 + j;"),
        ("      for (int fam = 0; fam < 2; ++fam) {", "#pragma unroll\n      for (int fam = 0; fam < 2; ++fam) {"),
    ],
    "four_blocks": [
        ("__global__ void __launch_bounds__(kWarps * kLanes)",
         "__global__ void __launch_bounds__(kWarps * kLanes, 4)"),
    ],
    "float_compute": [
        ("template <typename D> struct Compute {\n  using type = double;\n};",
         "template <typename D> struct Compute {\n  using type = D;\n};"),
    ],
}


def edited(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"ipm_split_design_sweep: {old[:60]!r} is not in the source once")
        source = source.replace(old, new)
    return source


def ptxas(log: str) -> list:
    """(kernel, registers, stack bytes, spill stores) per compiled entry."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = ("condense" if "condense_kernel" in name else "step") + (
                "<f32" if "IfLb" in name else "<f64") + (",el>" if "Lb1E" in name else ">")
        elif "stack frame" in line and name:
            frame = int(line.split()[0])
            spills = int(line.split(",")[1].split()[0])
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(line.split("Used")[1].split()[0]), frame, spills))
            name = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ipm_split_design_sweep: CUDA is not available")
    import chip_smoke as cs
    from kissmpc_tpu_torch.ops import _build, ipm_split
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver import ipm

    k8 = cs.configs("split")["k8_dyn2"]
    node = cs.node_config()
    cases = {"k8_dyn2": (k8, obstacle_problems(k8, args.batch, seed=0, n_dynamic=2)),
             "node": (node, obstacle_problems(node, 1, seed=12, n_dynamic=2))}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    inputs = {}
    for name, (cfg, pr) in cases.items():
        pr = ipm._contiguous(pr)
        it, mu = cs.split_iterate(cfg, pr, cs.SPLIT_CHECK_ITERATIONS)
        data = ipm.condense_plain(cfg, pr, it, mu)
        inputs[name] = (cfg, pr, it, mu, data, ipm.solve_lqr(data, cfg.solver.reg))

    source = ipm_split.SOURCE.read_text()
    libs, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant, edits in EDITS.items():
            path = Path(tmp) / f"ipm_split_{variant}.cu"
            path.write_text(edited(source, edits))
            lib = ipm_split.bind(_build.load(path, f"kissmpc_ipm_split_{variant}", Path(tmp)))
            log = next(Path(tmp).glob(f"libkissmpc_ipm_split_{variant}-*.log")).read_text()
            gate = cs.split_kernels_check(k8, cases["k8_dyn2"][1], cs.SPLIT_CHECK_ITERATIONS,
                                          lib, stream())
            torch.cuda.synchronize()
            libs[variant] = lib
            report[variant] = {"ptxas": ptxas(log), "gate_ok": gate["ok"],
                               "gate": cs.describe_split_check(gate)}
            print(json.dumps({"variant": variant, **report[variant]}), flush=True)
        times = {v: {} for v in EDITS}
        for turn in range(args.turns):
            for variant in (list(EDITS) if turn % 2 == 0 else list(EDITS)[::-1]):
                lib = libs[variant]
                for name, (cfg, pr, it, mu, data, sol) in inputs.items():
                    for kernel, fn in (
                            ("condense", lambda: ipm_split._condense(lib, stream(), cfg, pr, it,
                                                                    mu)),
                            ("step", lambda: ipm_split._step(lib, stream(), cfg, pr, it, mu,
                                                             data, sol))):
                        ms = cs.kernel_ms(fn, reps=20, graph=True)
                        times[variant].setdefault(f"{name}_{kernel}_ms", []).append(ms)
                print(json.dumps({"variant": variant, "turn": turn,
                                  **{k: v[-1] for k, v in times[variant].items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "batch": args.batch,
                      "best_of_turns_ms": {v: {k: min(x) for k, x in t.items()}
                                           for v, t in times.items()}}))


if __name__ == "__main__":
    main()
