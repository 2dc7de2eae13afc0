#!/usr/bin/env python3
"""Where one block of the Riccati kernel spends its time, by SM clock, on
one NVIDIA GPU.

    python3 scripts/riccati_phase_clocks.py

Compiles a copy of `kissmpc_tpu_torch/csrc/riccati.cu` into a temporary
directory (the checkout is left as it is) in which thread 0 of block 0
reads `clock64()` between the kernel's phases and adds the cycles to eight
counters: the prologue (the first two chunks' copies issued, the terminal
P, p loaded); in the backward sweep, the wait for a chunk's copies, the
steps of the chunk, and the barrier and the next chunk's copies
issued; the gains written out with the rollout's prologue; and in the
rollout the same three.  On LQR data of a real IPM iterate
(chip_smoke.py's `lqr_from_iterate`, K=8, N=50) it launches that copy at
B = 8192 and 164 in float32 and float64, each once after a warm-up, and
prints each phase's cycles, its share, the cycles per step of the sweep
and the rollout, and one JSON line.  The kernel's arithmetic is unchanged,
so its result is held to chip_smoke.py's phase-2 gate too.
"""

import ctypes
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLOCK = ("  long long clk[8] = {0}, clk_t0 = clock64(), clk_mark = clk_t0;\n"
         "#define CLK(i) do { const long long now_ = clock64(); clk[i] += now_ - clk_mark; "
         "clk_mark = now_; } while (0)\n")
SYNC_BWD = "    __syncthreads();  // the buffer is read; the copies of chunk c + 2 may land in it\n"
SYNC_FWD = "    __syncthreads();  // the buffer is read; the copies of chunk c - 2 may land in it\n"
# (text of riccati.cu, its replacement); each text occurs once.
EDITS = [
    ("namespace {\n\nconstexpr int kThreads", "__device__ long long kissmpc_clk[9];\n\n"
     "namespace {\n\nconstexpr int kThreads"),
    ("  auto hi_of = [&](int c) { return N - c * C; };\n",
     "  auto hi_of = [&](int c) { return N - c * C; };\n" + CLOCK),
    ("  for (int c = 0; c < chunks; ++c) {\n    wait_for(c);\n",
     "  CLK(0);\n  for (int c = 0; c < chunks; ++c) {\n    wait_for(c);\n    CLK(1);\n"),
    ("      cur = next;\n    }\n" + SYNC_BWD, "      cur = next;\n    }\n    CLK(2);\n" + SYNC_BWD),
    ("hi_of(c + 2), &bars[c & 1]);\n  }\n", "hi_of(c + 2), &bars[c & 1]);\n    CLK(3);\n  }\n"),
    ("  for (int c = chunks - 1; c >= 0; --c) {\n    if (c < chunks - 1) wait_for(c);\n",
     "  CLK(4);\n  for (int c = chunks - 1; c >= 0; --c) {\n    if (c < chunks - 1) wait_for(c);\n"
     "    CLK(5);\n"),
    ("      cur = next;\n    }\n" + SYNC_FWD, "      cur = next;\n    }\n    CLK(6);\n" + SYNC_FWD),
    ("hi_of(c - 2), &bars[c & 1]);\n  }\n}\n",
     "hi_of(c - 2), &bars[c & 1]);\n    CLK(7);\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 8; ++i) kissmpc_clk[i] = clk[i];\n"
     "    kissmpc_clk[8] = clock64() - clk_t0;\n  }\n}\n"),
]
GETTER = """
extern "C" int kissmpc_riccati_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, kissmpc_clk, sizeof(long long) * 9));
}
"""
PHASES = ("prologue", "sweep: wait", "sweep: steps", "sweep: barrier + copies issued",
          "gains out + rollout prologue", "rollout: wait", "rollout: steps",
          "rollout: barrier + copies issued")


def instrumented(text):
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"riccati_phase_clocks: {old[:60]!r} is not in riccati.cu once")
        text = text.replace(old, new)
    return text + GETTER


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("riccati_phase_clocks: CUDA is not available")

    import chip_smoke as cs
    from kissmpc_tpu_torch.ops import _build, riccati
    from kissmpc_tpu_torch.ops.lqr import LQRData
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.scenarios import obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfg = cs.configs("split")["k8_dyn2"]
    pool = obstacle_problems(cfg, cs.BATCH, seed=0, n_dynamic=2)
    data = cs.lqr_from_iterate(cfg, gather(pool, torch.arange(cs.BATCH, device="cuda")))
    out, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "riccati_clocks.cu"
        path.write_text(instrumented(riccati.SOURCE.read_text()))
        lib = riccati.bind(_build.load(path, "riccati_clocks", build_dir=Path(tmp)))
        lib.kissmpc_riccati_clocks.argtypes = [ctypes.c_void_p]
        lib.kissmpc_riccati_clocks.restype = ctypes.c_int
        real = riccati._library
        riccati._library = lambda: lib
        try:
            for dtype, B in ((torch.float32, 8192), (torch.float32, 164), (torch.float64, 8192),
                             (torch.float64, 164)):
                sub = LQRData(*(x.to(dtype)[:B].contiguous() for x in data))
                gate = cs.riccati_gate(solve_lqr_cuda(sub, cfg.solver.reg), sub, cfg.solver.reg)
                if not gate["ok"]:
                    failed.append((str(dtype), B))
                solve_lqr_cuda(sub, cfg.solver.reg)
                torch.cuda.synchronize()
                clk = (ctypes.c_longlong * 9)()
                _build.check_launch(lib, lib.kissmpc_riccati_clocks(clk), "clock read")
                total = clk[8]
                row = {name: clk[i] for i, name in enumerate(PHASES)}
                row.update(total=total, sweep_cycles_per_step=(clk[1] + clk[2] + clk[3]) / cs.N,
                           rollout_cycles_per_step=(clk[5] + clk[6] + clk[7]) / cs.N,
                           steps_only_per_step=(clk[2] / cs.N, clk[6] / cs.N))
                key = f"{str(dtype)[6:]} B={B}"
                out[key] = row
                print(f"{key}: {total} cycles in block 0; " + ", ".join(
                    f"{name} {clk[i]} ({clk[i] / total:.3f})" for i, name in enumerate(PHASES))
                    + f"; per step: sweep {row['sweep_cycles_per_step']:.0f} (steps alone "
                    f"{clk[2] / cs.N:.0f}), rollout {row['rollout_cycles_per_step']:.0f} (steps "
                    f"alone {clk[6] / cs.N:.0f})", flush=True)
        finally:
            riccati._library = real
    print(json.dumps({"device": torch.cuda.get_device_name(0), "clocks": out}), flush=True)
    if failed:
        raise SystemExit(f"riccati_phase_clocks: the instrumented copy fails phase 2's gate: "
                         f"{failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
