#!/usr/bin/env python3
"""Where the build kernel's discrete flips come from, on the CPU.

    python3 scripts/build_flip_witness.py [--baseline-header PATH]

No GPU and no nvcc are needed, only g++ (C++20).  Two measurements:

1. `sincos_rd` (`kissmpc_tpu_torch/csrc/device_math.cuh`), compiled alone
   with g++, against the C library's and torch's sin and cos on random
   arguments in three ranges: how many results differ in the last bit.
2. The build kernel through `scripts/ipm_split_cpu_shim.py`'s g++ build,
   as in the source and with `sincos_rd` swapped for the C library's sin
   and cos, held to `build_plain` by chip_smoke.py's gate on the shim's
   cases (`BUILD_DT`: most scenarios rolled out) at their own batch and at
   B=64: the kernel's flips beside its witness's (`ulp_witness`: the plain
   version with the start moved one ulp) and the allowance.

A flip is a scenario whose rollout took a discrete decision the other way:
a step capped onto an inflated circle's boundary, whose next
inside-or-out test turns on the last bit.  The float32 kernel computes in
double and rounds what it stores, so against the float32 plain version its
flips follow the witness's; in float64 a last-bit difference in sin or cos
is enough, so the second column shows how many flips the kernel's own
sin and cos add.  ``--baseline-header`` names another tree's
`device_math.cuh`: its `sincos_rd` is measured beside the source's, in
both measurements (spliced into a copy of the source's header).
"""

import argparse
import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import ipm_split_cpu_shim as shim  # noqa: E402

SINCOS = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
using std::fabs; using std::fma; using std::rint; using std::sqrt; using std::max; using std::min;
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
template <class V> V __shfl_xor_sync(unsigned, V v, int) { return v; }
template <class V> V __shfl_sync(unsigned, V v, int) { return v; }
#include "device_math.cuh"
extern "C" void sincos_many(const double* x, double* s, double* c, int n) {
  for (int i = 0; i < n; ++i) sincos_rd(x[i], s[i], c[i]);
}
"""
LIBC_SINCOS = "#define sincos_rd(x, s, c) ((s) = std::sin(x), (c) = std::cos(x))\n"
INCLUDE = '#include "device_math.cuh"\n'
CASES = (("k4", 12, 4, 4), ("k4_n64", 64, 4, 6), ("k8_n50", 50, 8, 10))


SINCOS_RD = re.compile(r"__device__ __forceinline__ void sincos_rd\(.*?\n}\n", re.S)


def headers(tmp, baseline):
    """{label: a directory holding csrc's headers}: the source's, and with
    the baseline header's `sincos_rd` spliced in."""
    csrc = ROOT / "kissmpc_tpu_torch" / "csrc"
    out = {"sincos_rd": csrc}
    if baseline:
        text = (csrc / "device_math.cuh").read_text()
        [old] = SINCOS_RD.findall(text)
        [new] = SINCOS_RD.findall(Path(baseline).read_text())
        d = Path(tmp) / "baseline_header"
        d.mkdir()
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "device_math.cuh").write_text(text.replace(old, new))
        out["baseline sincos_rd"] = d
    return out


def sincos_agreement(tmp, torch, label, include):
    src = Path(tmp) / "sincos.cpp"
    src.write_text(SINCOS)
    lib = Path(tmp) / f"libsincos_{label.split()[0]}.so"
    subprocess.run(["g++", "-std=c++20", "-O0", "-shared", "-fPIC", "-w", f"-I{include}",
                    str(src), "-o", str(lib)], check=True)
    fn = ctypes.CDLL(str(lib)).sincos_many
    gen = torch.Generator().manual_seed(0)
    for scale in (4 * math.pi, 200.0, 1e6):
        x = (torch.rand(100_000, generator=gen, dtype=torch.float64) - 0.5) * scale
        s, c = torch.empty_like(x), torch.empty_like(x)
        fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(s.data_ptr()),
           ctypes.c_void_p(c.data_ptr()), len(x))
        ls = torch.tensor([math.sin(v) for v in x.tolist()], dtype=torch.float64)
        lc = torch.tensor([math.cos(v) for v in x.tolist()], dtype=torch.float64)
        print(f"{label} on {len(x):,} arguments in +-{scale / 2:g}: differs from the C "
              f"library's sin on {int((s != ls).sum()):,}, cos {int((c != lc).sum()):,}; "
              f"from torch's sin on {int((s != torch.sin(x)).sum()):,}, cos "
              f"{int((c != torch.cos(x)).sum()):,}", flush=True)


def build_libs(tmp, includes):
    from kissmpc_tpu_torch.ops import problem_build

    text = problem_build.SOURCE.read_text()
    if text.count(INCLUDE) != 1:
        raise SystemExit("build_flip_witness: device_math.cuh is not included once")
    libs = {}
    variants = [(label, inc, "") for label, inc in includes.items()]
    variants.append(("C library sin/cos", includes["sincos_rd"], LIBC_SINCOS))
    for name, inc, extra in variants:
        d = Path(tmp) / ("build_" + name.split()[0])
        d.mkdir()
        for header in Path(inc).glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "problem_build.cu").write_text(text.replace(INCLUDE, INCLUDE + extra))
        libs[name] = problem_build.bind(shim._compile(d, d / "problem_build.cu", None))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-header", type=Path,
                    help="another tree's csrc/device_math.cuh, whose sincos_rd is measured too")
    args = ap.parse_args()

    import torch

    import chip_smoke

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        includes = headers(tmp, args.baseline_header)
        for label, inc in includes.items():
            sincos_agreement(tmp, torch, label, inc)
        libs = build_libs(tmp, includes)
        own = {c[0]: c[3] for c in shim.BUILD_CASES + shim.BUILD_LONG_CASES}
        for name, n, K, k_all in CASES:
            cfg = shim.config(n, K, {}, {}).replace(time_step=shim.BUILD_DT)
            for B in sorted({own[name], 64}):
                for dtype in (torch.float32, torch.float64):
                    inputs = chip_smoke.build_inputs(cfg, B, 7, k_all=k_all, dtype=dtype,
                                                     device="cpu")
                    row = []
                    for label, lib in libs.items():
                        r = chip_smoke.build_kernel_check(cfg, inputs, lib, 0)
                        row.append(f"{label}: flips {r['flips']}")
                    print(f"build {name} B={B} {str(dtype)[6:]} ({r['rolled']} rolled out; "
                          f"witness {r['plain_flips']}, allowed {r['allowed']}): "
                          + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
