#!/usr/bin/env python3
"""Time the split iteration's kernels as written against their design
choices and against an earlier tree's kernels, on one NVIDIA GPU.

    python3 scripts/ipm_split_design_sweep.py [--baseline DIR] [--turns 2]

Variants:

- ``as_written``: `kissmpc_tpu_torch/csrc/ipm_split.cu`, the step in the
  wrapper's layout for each batch (`ops/ipm_split.py::step_warps`);
- ``warps_1``, ``warps_2``, ``warps_4``: the same library,
  the step forced to that many warps per scenario at every batch;
- ``condense_4_blocks``: the condensation's launch bounds ask for 4
  resident blocks of 128 threads per SM (at most 128 registers a thread;
  the source asks for 5, at most 102);
- ``step_hard_4_blocks``: the hard step instances with the arena in shared
  memory ask for 4 resident blocks of 4 warps per SM (at most 128
  registers; the source asks for 5, at most 102);
- ``all_double``: the source with the float32 instance's merit
  transcendentals (the log of a trial slack, the trial point's obstacle
  distance) in double, as the float64 instance evaluates them;
- ``baseline`` (with ``--baseline DIR``): the kernels of another tree, such
  as an unpacked ``git archive`` of an earlier commit, launched through
  that tree's own `ops/ipm_split.py` (loaded beside this package's) from
  its own source.

Each edited source is built by nvcc into a temporary directory
(`ops/_build.py::load`) and bound as the package's own build is.  For each
library it prints ptxas' registers, stack and spills per kernel; each
variant but the baseline is held to chip_smoke.py's gates
(`split_kernels_check`: outputs, merits and rho) at k8_dyn2 B=8192 and at
the node, float32.  Then both kernels are timed by `chip_smoke.kernel_ms`
(20 launches in a CUDA graph) at k8_dyn2 float32 B = 8192, 1024, 328, 164
(the refine batches), free (K=0) at B=8192, and the node's configuration
(N=7, K=4) at B=1 and at B=8192 (a scenario small enough that one warp
covers it), in turns over the variants, ``--turns`` times.  One JSON line per variant and turn, then a
summary line with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCHES = (8192, 1024, 328, 164)
LAYOUTS = (1, 2, 4)
# (name, source edits) of the libraries built from this tree's source.
EDITS = {
    "as_written": [],
    "condense_4_blocks": [
        ("__global__ void __launch_bounds__(kCondenseThreads, 5)\ncondense_kernel(",
         "__global__ void __launch_bounds__(kCondenseThreads, 4)\ncondense_kernel("),
    ],
    "step_hard_4_blocks": [
        ("__global__ void __launch_bounds__(kMaxWarps * kLanes, EL || GLOBAL ? 3 : 5)\nstep_kernel(",
         "__global__ void __launch_bounds__(kMaxWarps * kLanes, EL || GLOBAL ? 3 : 4)\nstep_kernel("),
    ],
    "all_double": [
        ("  __device__ static double log(double x) { return logf(static_cast<float>(x)); }\n"
         "  __device__ static double sqrt(double x) { return sqrtf(static_cast<float>(x)); }\n",
         "  __device__ static double log(double x) { return ::log(x); }\n"
         "  __device__ static double sqrt(double x) { return ::sqrt(x); }\n"),
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
    out, name, frame, spills = [], None, 0, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kind = "condense" if "condense_kernel" in name else "step"
            name = f"{kind} {'f32' if 'IfL' in name else 'f64'} {name.split('I', 1)[1][:12]}"
        elif "stack frame" in line and name:
            frame = int(line.split()[0])
            spills = int(line.split(",")[1].split()[0])
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(line.split("Used")[1].split()[0]), frame, spills))
            name = None
    return out


def baseline_module(root: Path):
    """The wrapper module of the tree at ``root``, loaded beside this
    package's as `kissmpc_tpu_torch.ops.ipm_split_baseline` (its relative
    imports resolve in this package), with its SOURCE in that tree."""
    path = root / "kissmpc_tpu_torch" / "ops" / "ipm_split.py"
    spec = importlib.util.spec_from_file_location("kissmpc_tpu_torch.ops.ipm_split_baseline", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    module.SOURCE = root / "kissmpc_tpu_torch" / "csrc" / "ipm_split.cu"
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="a tree whose kernels are timed beside")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ipm_split_design_sweep: CUDA is not available")
    import chip_smoke as cs
    from kissmpc_tpu_torch.ops import _build, ipm_split
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver import ipm
    from kissmpc_tpu_torch.solver.problem import gather

    split = cs.configs("split")
    k8 = split["k8_dyn2"]
    node = cs.node_config()
    pool = obstacle_problems(k8, BATCHES[0], seed=0, n_dynamic=2)
    cases = {f"k8_dyn2_b{B}": (k8, gather(pool, torch.arange(B, device="cuda")))
             for B in BATCHES}
    cases["free_b8192"] = (split["free"], free_problems(split["free"], BATCHES[0], seed=0))
    cases["node"] = (node, obstacle_problems(node, 1, seed=12, n_dynamic=2))
    cases["node_b8192"] = (node, obstacle_problems(node, BATCHES[0], seed=12, n_dynamic=2))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    inputs = {}
    for name, (cfg, pr) in cases.items():
        pr = ipm._contiguous(pr)
        it, mu = cs.split_iterate(cfg, pr, cs.SPLIT_CHECK_ITERATIONS)
        data = ipm.condense_plain(cfg, pr, it, mu)
        inputs[name] = (cfg, pr, it, mu, data, ipm.solve_lqr(data, cfg.solver.reg))

    source = ipm_split.SOURCE.read_text()
    # variant -> (wrapper module, library, forced warps or None)
    variants, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for header in ipm_split.SOURCE.parent.glob("*.cuh"):  # the copies' includes
            shutil.copy(header, Path(tmp) / header.name)
        for edit, edits in EDITS.items():
            path = Path(tmp) / f"ipm_split_{edit}.cu"
            path.write_text(edited(source, edits))
            lib = ipm_split.bind(_build.load(path, f"kissmpc_ipm_split_{edit}", Path(tmp)))
            log = next(Path(tmp).glob(f"libkissmpc_ipm_split_{edit}-*.log")).read_text()
            for warps in (None,) + (LAYOUTS if edit == "as_written" else ()):
                variant = edit if warps is None else f"warps_{warps}"
                gates = {}
                for name in ("k8_dyn2_b8192", "node"):
                    cfg, pr = cases[name]
                    res = cs.split_kernels_check(cfg, pr, cs.SPLIT_CHECK_ITERATIONS, lib,
                                                 stream(), warps=warps)
                    torch.cuda.synchronize()
                    gates[name] = {"ok": res["ok"], "gate": cs.describe_split_check(res)}
                variants[variant] = (ipm_split, lib, warps)
                report[variant] = {"ptxas": ptxas(log), "gates": gates}
                print(json.dumps({"variant": variant, **report[variant]}), flush=True)
        if args.baseline:
            module = baseline_module(args.baseline.resolve())
            lib = module.bind(_build.load(module.SOURCE, "kissmpc_ipm_split_baseline", Path(tmp)))
            log = next(Path(tmp).glob("libkissmpc_ipm_split_baseline-*.log")).read_text()
            variants["baseline"] = (module, lib, None)
            report["baseline"] = {"ptxas": ptxas(log), "root": str(args.baseline)}
            print(json.dumps({"variant": "baseline", **report["baseline"]}), flush=True)
        times = {v: {} for v in variants}
        for turn in range(args.turns):
            order = list(variants) if turn % 2 == 0 else list(variants)[::-1]
            for variant in order:
                module, lib, warps = variants[variant]
                kw = {} if warps is None else {"warps": warps}
                for name, (cfg, pr, it, mu, data, sol) in inputs.items():
                    for kernel, fn in (
                            ("condense", lambda: module._condense(lib, stream(), cfg, pr, it, mu)),
                            ("step", lambda: module._step(lib, stream(), cfg, pr, it, mu, data,
                                                          sol, **kw))):
                        if kernel == "condense" and warps is not None:
                            continue  # the layout is the step's alone
                        ms = cs.kernel_ms(fn, reps=20, graph=True)
                        times[variant].setdefault(f"{name}_{kernel}_ms", []).append(ms)
                print(json.dumps({"variant": variant, "turn": turn,
                                  **{k: v[-1] for k, v in times[variant].items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    layout = {name: ipm_split.step_warps(pr.initial_state.shape[0], cfg.horizon,
                                         cfg.max_obstacles) for name, (cfg, pr) in cases.items()}
    print(json.dumps({"card": smi, "wrapper_layout": layout,
                      "best_of_turns_ms": {v: {k: min(x) for k, x in t.items()}
                                           for v, t in times.items()}}))
    failed = [v for v, r in report.items()
              if not all(g["ok"] for g in r.get("gates", {}).values())]
    if failed:
        raise SystemExit(f"ipm_split_design_sweep: variants failing the gates: {failed}")


if __name__ == "__main__":
    main()
