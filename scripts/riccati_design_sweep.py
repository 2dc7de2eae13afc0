#!/usr/bin/env python3
"""The Riccati kernel's design choices, and the one-thread-per-scenario
kernel it replaced, measured against each other on one NVIDIA GPU.

    python3 scripts/riccati_design_sweep.py [--calls 2]

`kissmpc_tpu_torch/csrc/riccati.cu` stages each block's inputs in shared
memory in chunks of kChunkSmall steps at B <= kSmallBatch and kChunkLarge
above, gives each scenario four lanes, and runs one warp per block.  This
script compiles into a temporary directory (the checkout is left as it is)
the source as written, one edited copy per alternative (1 and 2 lanes per
scenario, from the lane-generic step functions carried below as
LANES_SOURCE; 2 and 4 warps per block, from the CPU shim's `warp_edits`;
chunks of 8, 16 or 32 steps at every batch; a copy equal to the source is
skipped), and the earlier kernel, one thread per scenario reading global
memory, which is carried below as EARLIER_SOURCE.  Neither is part of the
package.  On LQR data of a real
IPM iterate (chip_smoke.py's `lqr_from_iterate`, K=8, N=50) each build is
held to chip_smoke.py's phase-2 gate and timed by its `kernel_ms` (20
launches captured in a CUDA graph between one event pair) at the batches
the split path hands the kernel, B = 8192, 1024, 410, 328, 164 in float32
and 8192, 164 in float64, the builds taken in turns, forward, backward,
forward, backward.  From those times it prints the Riccati device time of
one split call (free: 32 launches at 8192 and 64 at 410; K=8: 32 at 8192,
64 at 1024, 96 at 328, 128 at 164).  Then `solve_batch` on the split
backend (free, k8_dyn2, and free with mehrotra "pc" and "soc") runs with
the earlier kernel and the source as written on the same batches in turns
(earlier, new, new, earlier; ``--calls`` calls each), and the script
prints each side's converged fractions and host-clock latencies.  It ends
with one JSON line and exits non-zero if a build fails the gate or the
converged fractions of the two kernels differ by more than 0.001.  A
variant whose shared memory exceeds the card's at some batch (the
wrapper's ValueError) is reported as not fitting there and not timed.
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import riccati_cpu_shim as shim  # noqa: E402

EARLIER = "one thread per scenario (earlier kernel)"
# The step functions of riccati.cu for G lanes per scenario (1, 2 or 4),
# lane r taking columns r, r + G, ... of [A | d]: they replace the source's
# four-lane ones, from STEPS_BEGIN up to STEPS_END.
STEPS_BEGIN = "// Value v of lane ``src`` of this lane's group of kLanes."
STEPS_END = "// One forward step's inputs: the gains row, A, B and d."
LANES_SOURCE = r"""// Value v of lane ``src`` of this lane's group of G.
template <int G, typename T>
__device__ __forceinline__ T from_lane(T v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(kFull, v, src, G);
  }
}

// One backward step's inputs in registers, for lane r of a group of G:
// all of A, B, Quu and qu; column c = r, r + G, ... of [A | d] and of
// [Qxx | qx].
template <typename T, int G = kLanes>
struct StepIn {
  T a[9], bm[6], quu[4], qu[2], col[4 / G][3], qcol[4 / G][3];
};

// The staged row pointers of one chunk (time lo first).
template <typename T>
struct Rows {
  const T *a, *bm, *dv, *Qxx, *qx, *Quu, *qu;
};

template <typename T, int G>
__device__ __forceinline__ void load_step(StepIn<T, G>& v, const Rows<T>& x, int k, int r) {
#pragma unroll
  for (int i = 0; i < 9; ++i) v.a[i] = x.a[k * 9 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) v.bm[i] = x.bm[k * 6 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) v.quu[i] = x.Quu[k * 4 + i];
#pragma unroll
  for (int i = 0; i < 2; ++i) v.qu[i] = x.qu[k * 2 + i];
#pragma unroll
  for (int m = 0; m < 4 / G; ++m) {
    const int c = r + G * m;
    const T* col = c < 3 ? x.a + k * 9 + c : x.dv + k * 3;
    const T* q = c < 3 ? x.Qxx + k * 9 + c : x.qx + k * 3;
    const int cs = c < 3 ? 3 : 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v.col[m][i] = col[i * cs];
      v.qcol[m][i] = q[i * cs];
    }
  }
}

// One backward step: P, p <- the step's value function; the gains K
// (row-major 2 x 3) and k go to g[0..5], g[6..7].  Lane r of the group
// computes columns r, r + G, ... of the augmented system [A | d].
template <typename T, int G>
__device__ __forceinline__ void backward_step(T (&P)[9], T (&p)[3], const StepIn<T, G>& v, T* g,
                                              int r, T reg) {
  constexpr int M = 4 / G;  // columns per lane
  // Quu_hat = Quu + B'PB and its regularized closed-form inverse, per lane.
  T PB[6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T s = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * v.bm[x * 2 + j];
      PB[i * 2 + j] = s;
    }
  T Quh[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T s = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s += v.bm[x * 2 + i] * PB[x * 2 + j];
      Quh[i * 2 + j] = v.quu[i * 2 + j] + s;
    }
  const T ia = Quh[0] + reg, ib = Quh[1], ic = Quh[2], id = Quh[3] + reg;
  const T inv_det = T(1) / (ia * id - ib * ic);
  const T inv[4] = {id * inv_det, -ib * inv_det, -ic * inv_det, ia * inv_det};

  // Column c of P[A|d] (+ p in column 3), of B'P[A|d] (+ qu), of the gains.
  T PAc[M][3], Qc[M][2], Kc[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = r + G * m;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s = c < 3 ? T(0) : p[i];
#pragma unroll
      for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * v.col[m][x];
      PAc[m][i] = s;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T s = c < 3 ? T(0) : v.qu[i];
#pragma unroll
      for (int x = 0; x < 3; ++x) s += v.bm[x * 2 + i] * PAc[m][x];
      Qc[m][i] = s;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Kc[m][i] = -(inv[i * 2 + 0] * Qc[m][0] + inv[i * 2 + 1] * Qc[m][1]);
      g[c < 3 ? i * 3 + c : 6 + i] = Kc[m][i];
    }
  }
  // Every lane needs all of Qux = B'PA.
  T Qux[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) Qux[i][c] = from_lane<G>(Qc[c / G][i], c % G);
  // Column c of [P' | p'] = [Qxx | qx] + A'P[A|d] + Qux'[K | k].
  T Pc[M][3];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s1 += v.a[x * 3 + i] * PAc[m][x];
#pragma unroll
      for (int x = 0; x < 2; ++x) s2 += Qux[x][i] * Kc[m][x];
      Pc[m][i] = v.qcol[m][i] + s1 + s2;
    }
  }
  T Pn[3][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) Pn[i][c] = from_lane<G>(Pc[c / G][i], c % G);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[i * 3 + j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
    p[i] = Pn[i][3];
  }
}

"""


def lanes_edits(lanes):
    """Edits of riccati.cu, (text, replacement), that give each scenario
    ``lanes`` lanes; the first replaces the step functions (see
    LANES_SOURCE) and is marked by None."""
    return [(None, LANES_SOURCE),
            ("constexpr int kLanes = 4; ", f"constexpr int kLanes = {lanes}; "),
            ("      for (int m = 0; m < 2; ++m) {\n",
             "      for (int m = 0; m < (5 + kLanes - 1) / kLanes; ++m) {\n"),
            ("      if (i == r) dx_b[i] = xs[i];", "      if (i % kLanes == r) dx_b[i] = xs[i];")]


def chunk_edits(small, large):
    return [("constexpr int kChunkSmall = 32; ", f"constexpr int kChunkSmall = {small}; "),
            ("constexpr int kChunkLarge = 16; ", f"constexpr int kChunkLarge = {large}; ")]


# name -> its edits of riccati.cu.
VARIANTS = {
    "as written": [],
    "G=1": lanes_edits(1),
    "G=2": lanes_edits(2),
    "W=2": shim.warp_edits(2),
    "W=4": shim.warp_edits(4),
    "chunk 8 at every B": chunk_edits(8, 8),
    "chunk 16 at every B": chunk_edits(16, 16),
    "chunk 32 at every B": chunk_edits(32, 32),
}
TURNS = 4
# (launches, B) of one split call's Riccati solves (chip_smoke.py STAGES_*).
SPLIT_LAUNCHES = {"free": ((32, 8192), (64, 410)),
                  "k8_dyn2": ((32, 8192), (64, 1024), (96, 328), (128, 164))}

# The earlier kernel (one thread per scenario in 32-thread blocks, inputs read
# from global memory at each step, gains through a global scratch), as it
# stood in kissmpc_tpu_torch/csrc/riccati.cu before the redesign.
EARLIER_SOURCE = r"""// Batched Riccati solve of the IPM's Newton-KKT system, for Hopper (sm_90a).
//
// Replaces: kissmpc_tpu/ops/pallas/riccati.py::_riccati_kernel (the TPU
// kernel behind solve_lqr_pallas).  Contract: ops/lqr.py::solve_lqr of this
// package, its plain PyTorch version.  Per scenario b, one backward Riccati
// sweep (Quu/Qux/qu hats, closed-form regularized 2x2 inverse, gains K and
// k, P' symmetrized) and one forward rollout, nx = 3 and nu = 2.
//
// What bounds it: memory.  Per scenario in f32 it reads 1,815 values
// (A N*9, B N*6, d N*3, d0 3, Qxx (N+1)*9, qx (N+1)*3, Quu N*4, qu N*2 at
// N = 50) and writes 253 (dx (N+1)*3, du N*2): about 8.3 KB.  At B = 8192
// that is ~68 MB per call, so ~20 us at 3.35 TB/s is the bound, scratch
// traffic left out.  Its arithmetic (~450 flops per step, ~184 MFLOP per
// call) takes ~3 us at the f32 peak.
//
// Design.  One thread per scenario: the recurrence over N is sequential,
// and every step is 3x3 algebra that fits in registers (P: 9 values, p: 3),
// unrolled as riccati.py:40-95 unrolls it.  The gains go to a [B, N, 8]
// scratch that the wrapper allocates; the forward rollout reads them back.
//
// Layout: batch-major, as the IPM builds its tensors ([B, N, 3, 3] ...),
// with no transpose.  Neighbouring threads then read addresses ~1.8 KB
// apart (one scenario's A), so a warp's load is not coalesced.  But each
// thread walks its own rows in order, so every 32-byte sector it fetches
// is used whole over a few steps while it sits in L1: the bytes fetched
// from device memory stay those counted above.  The scenario-major layout
// of the TPU kernel (riccati.py:199-214) would coalesce each load but costs
// a transpose of all ~68 MB (read and write) per call, more than the sweep
// itself moves.  One gain row is 8 values = 32 bytes, one sector per step.
//
// Small blocks (32 threads) spread a B = 8192 batch over all 132 SMs
// (256 blocks); with only ~62 scenarios per SM the sweep is latency-bound
// before it is bandwidth-bound, which is the first thing a faster version
// would attack (several threads per scenario, or loads issued a step ahead).
//
// The TPU's artefacts are gone: no BT = 512 tile, no padding of the batch
// to a tile multiple, no VMEM specs.  The ragged edge is masked by b < B.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(32) riccati_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ d, const T* __restrict__ d0,
    const T* __restrict__ Qxx, const T* __restrict__ qx,
    const T* __restrict__ Quu, const T* __restrict__ qu,
    T* __restrict__ dx, T* __restrict__ du, T* __restrict__ gains,
    int B, int N, T reg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sb = static_cast<size_t>(b);
  const size_t n = static_cast<size_t>(N);
  const T* A_b = A + sb * n * 9;
  const T* B_b = Bm + sb * n * 6;
  const T* d_b = d + sb * n * 3;
  const T* Qxx_b = Qxx + sb * (n + 1) * 9;
  const T* qx_b = qx + sb * (n + 1) * 3;
  const T* Quu_b = Quu + sb * n * 4;
  const T* qu_b = qu + sb * n * 2;
  T* g_b = gains + sb * n * 8;

  // ---- backward sweep: V(dx) = 1/2 dx'P dx + p'dx ------------------------
  T P[9], p[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) P[i] = Qxx_b[n * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = qx_b[n * 3 + i];

  for (int t = N - 1; t >= 0; --t) {
    T a[9], bm[6], dv[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) a[i] = A_b[t * 9 + i];
#pragma unroll
    for (int i = 0; i < 6; ++i) bm[i] = B_b[t * 6 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) dv[i] = d_b[t * 3 + i];

    T pdp[3];  // P d + p
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * dv[x];
      pdp[i] = s + p[i];
    }
    T PA[9], PB[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T s = T(0);
#pragma unroll
        for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * a[x * 3 + j];
        PA[i * 3 + j] = s;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        T s = T(0);
#pragma unroll
        for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * bm[x * 2 + j];
        PB[i * 2 + j] = s;
      }
    }
    // Quu_hat = Quu + B'PB, Qux_hat = B'PA, qu_hat = qu + B'(Pd + p)
    T Quh[4], Qux[6], quh[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        T s = T(0);
#pragma unroll
        for (int x = 0; x < 3; ++x) s += bm[x * 2 + i] * PB[x * 2 + j];
        Quh[i * 2 + j] = Quu_b[t * 4 + i * 2 + j] + s;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T s = T(0);
#pragma unroll
        for (int x = 0; x < 3; ++x) s += bm[x * 2 + i] * PA[x * 3 + j];
        Qux[i * 3 + j] = s;
      }
      T s = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s += bm[x * 2 + i] * pdp[x];
      quh[i] = qu_b[t * 2 + i] + s;
    }
    // Closed-form regularized 2x2 inverse.
    const T ia = Quh[0] + reg, ib = Quh[1], ic = Quh[2], id = Quh[3] + reg;
    const T inv_det = T(1) / (ia * id - ib * ic);
    const T inv[4] = {id * inv_det, -ib * inv_det, -ic * inv_det, ia * inv_det};
    // K = -Quu_inv Qux_hat, k = -Quu_inv qu_hat
    T K[6], k[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        K[i * 3 + j] = -(inv[i * 2 + 0] * Qux[j] + inv[i * 2 + 1] * Qux[3 + j]);
      k[i] = -(inv[i * 2 + 0] * quh[0] + inv[i * 2 + 1] * quh[1]);
    }
    // P' = Qxx + A'PA + Qux'K, p' = qx + A'(Pd + p) + Qux'k
    T Pn[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T s1 = T(0), s2 = T(0);
#pragma unroll
        for (int x = 0; x < 3; ++x) s1 += a[x * 3 + i] * PA[x * 3 + j];
#pragma unroll
        for (int x = 0; x < 2; ++x) s2 += Qux[x * 3 + i] * K[x * 3 + j];
        Pn[i * 3 + j] = Qxx_b[t * 9 + i * 3 + j] + s1 + s2;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int x = 0; x < 3; ++x) s1 += a[x * 3 + i] * pdp[x];
#pragma unroll
      for (int x = 0; x < 2; ++x) s2 += Qux[x * 3 + i] * k[x];
      p[i] = qx_b[t * 3 + i] + s1 + s2;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        P[i * 3 + j] = T(0.5) * (Pn[i * 3 + j] + Pn[j * 3 + i]);
#pragma unroll
    for (int i = 0; i < 6; ++i) g_b[t * 8 + i] = K[i];
    g_b[t * 8 + 6] = k[0];
    g_b[t * 8 + 7] = k[1];
  }

  // ---- forward rollout: du = K dx + k, dx' = A dx + B du + d --------------
  T* dx_b = dx + sb * (n + 1) * 3;
  T* du_b = du + sb * n * 2;
  T x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = d0[sb * 3 + i];
    dx_b[i] = x[i];
  }
  for (int t = 0; t < N; ++t) {
    T g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = g_b[t * 8 + i];
    T u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) s += g[i * 3 + j] * x[j];
      u[i] = s + g[6 + i];
      du_b[t * 2 + i] = u[i];
    }
    T xn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) s1 += A_b[t * 9 + i * 3 + j] * x[j];
#pragma unroll
      for (int j = 0; j < 2; ++j) s2 += B_b[t * 6 + i * 2 + j] * u[j];
      xn[i] = s1 + s2 + d_b[t * 3 + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = xn[i];
      dx_b[(t + 1) * 3 + i] = x[i];
    }
  }
}

constexpr int kThreads = 32;

template <typename T>
int launch(const void* A, const void* Bm, const void* d, const void* d0,
           const void* Qxx, const void* qx, const void* Quu, const void* qu,
           void* dx, void* du, void* gains, int B, int N, double reg,
           void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    riccati_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(d), static_cast<const T*>(d0),
        static_cast<const T*>(Qxx), static_cast<const T*>(qx),
        static_cast<const T*>(Quu), static_cast<const T*>(qu),
        static_cast<T*>(dx), static_cast<T*>(du), static_cast<T*>(gains),
        B, N, static_cast<T>(reg));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kissmpc_riccati_f32(
    const void* A, const void* Bm, const void* d, const void* d0,
    const void* Qxx, const void* qx, const void* Quu, const void* qu,
    void* dx, void* du, void* gains, int B, int N, double reg, void* stream) {
  return launch<float>(A, Bm, d, d0, Qxx, qx, Quu, qu, dx, du, gains, B, N,
                       reg, stream);
}

extern "C" int kissmpc_riccati_f64(
    const void* A, const void* Bm, const void* d, const void* d0,
    const void* Qxx, const void* qx, const void* Quu, const void* qu,
    void* dx, void* du, void* gains, int B, int N, double reg, void* stream) {
  return launch<double>(A, Bm, d, d0, Qxx, qx, Quu, qu, dx, du, gains, B, N,
                        reg, stream);
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def edited(text, edits):
    """``text`` with each of ``edits`` applied, each text occurring once."""
    for old, new in edits:
        if old is None:
            begin, end = text.find(STEPS_BEGIN), text.find(STEPS_END)
            if begin < 0 or end < 0:
                raise SystemExit("riccati_design_sweep: the step functions are not in riccati.cu")
            text = text[:begin] + new + text[end:]
            continue
        if text.count(old) != 1:
            raise SystemExit(f"riccati_design_sweep: {old[:60]!r} is not in riccati.cu once")
        text = text.replace(old, new)
    return text


def sources(text):
    """{name: source text} of the variants, each distinct from the others."""
    out = {}
    for name, edits in VARIANTS.items():
        src = edited(text, edits)
        if src not in out.values():
            out[name] = src
    return out


def build_all(tmp, texts):
    """{name: loaded library}, compiled in parallel into ``tmp``."""
    from kissmpc_tpu_torch.ops import _build, riccati

    def one(i, name, text):
        path = tmp / f"variant{i}.cu"
        path.write_text(text)
        lib = _build.load(path, f"variant{i}", build_dir=tmp)
        if name == EARLIER:
            for fn in (lib.kissmpc_riccati_f32, lib.kissmpc_riccati_f64):
                fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_double, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            return lib
        return riccati.bind(lib)

    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        futures = {name: pool.submit(one, i, name, text)
                   for i, (name, text) in enumerate(texts.items())}
        return {name: f.result() for name, f in futures.items()}


@contextlib.contextmanager
def kernel_library(lib):
    """Route `solve_lqr_cuda` to the loaded library ``lib``."""
    from kissmpc_tpu_torch.ops import riccati

    real_lib = riccati._library
    riccati._library = lambda: lib
    try:
        yield
    finally:
        riccati._library = real_lib


def split_calls(cs, libs, pools, calls):
    """solve_batch on the split backend with the earlier kernel and the
    source as written, on the same batches, in turns: {cell: {build:
    {"ms": [...], "converged": [...]}}}."""
    import torch

    from kissmpc_tpu_torch import solve_batch
    from kissmpc_tpu_torch.solver.problem import gather

    cfgs = cs.configs("split")
    cells = {"free": (cfgs["free"], pools["free"]), "k8_dyn2": (cfgs["k8_dyn2"], pools["k8_dyn2"])}
    for mode in ("pc", "soc"):
        cells[f"free mehrotra={mode}"] = (
            cfgs["free"].replace(solver=dataclasses.replace(cfgs["free"].solver, mehrotra=mode)),
            pools["free"])
    order = [EARLIER, "as written"]
    out = {}
    for cell, (cfg, pool) in cells.items():
        rng = np.random.default_rng(3)
        batches = [gather(pool, torch.as_tensor(rng.permutation(cs.POOL)[:cs.BATCH],
                                                device="cuda")) for _ in range(calls)]
        res = {name: {"ms": [], "converged": []} for name in order}
        for turn in range(TURNS):
            for name in (order if turn % 2 == 0 else order[::-1]):
                with kernel_library(libs[name]):
                    for batch in batches:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        sol = solve_batch(cfg, batch)
                        torch.cuda.synchronize()
                        res[name]["ms"].append((time.perf_counter() - t0) * 1e3)
                        res[name]["converged"].append(
                            float(sol.diagnostics.converged.float().mean()))
        for name in order:
            r = res[name]
            print(f"split {cell:>20} {name:>42}: p50 {float(np.percentile(r['ms'], 50)):.3f} ms "
                  f"(calls {min(r['ms']):.3f}-{max(r['ms']):.3f}), converged "
                  f"{statistics.mean(r['converged']):.5f}", flush=True)
        out[cell] = res
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("riccati_design_sweep: CUDA is not available")

    import chip_smoke as cs
    from kissmpc_tpu_torch.ops import riccati
    from kissmpc_tpu_torch.ops.lqr import LQRData
    from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfgs = cs.configs("split")
    pools = {"free": free_problems(cfgs["free"], cs.POOL, seed=0),
             "k8_dyn2": obstacle_problems(cfgs["k8_dyn2"], cs.POOL, seed=0, n_dynamic=2)}
    cfg = cfgs["k8_dyn2"]
    reg = cfg.solver.reg
    data = cs.lqr_from_iterate(cfg, gather(pools["k8_dyn2"], torch.arange(cs.BATCH, device="cuda")))
    cases = [(torch.float32, B) for B in cs.RICCATI_BATCHES] + [
        (torch.float64, B) for B in cs.RICCATI_F64_BATCHES]
    inputs = {}
    for dtype, B in cases:
        inputs[(dtype, B)] = LQRData(*(x.to(dtype)[:B].contiguous() for x in data))
    texts = {EARLIER: EARLIER_SOURCE, **sources(riccati.SOURCE.read_text())}
    results = {name: {} for name in texts}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), texts)
        order = list(libs)
        fits = {}
        for name, lib in libs.items():
            with kernel_library(lib):
                for (dtype, B), sub in inputs.items():
                    key = f"{str(dtype)[6:]} B={B}"
                    try:
                        g = cs.riccati_gate(solve_lqr_cuda(sub, reg), sub, reg)
                    except ValueError as e:  # its shared memory exceeds the card's
                        print(f"{key:>13} {name:>42}: does not fit: {e}", flush=True)
                        results[name][key] = {"ok": True, "fits": False}
                        continue
                    fits[(name, key)] = True
                    worst = max(g["outputs"].values(), key=lambda o: o["ratio"])
                    results[name][key] = {"ok": g["ok"], "err": g["err"],
                                          "ratio": worst["ratio"]}
        for (dtype, B), sub in inputs.items():
            key = f"{str(dtype)[6:]} B={B}"
            runs = [name for name in order if fits.get((name, key))]
            turns = {name: [] for name in runs}
            for turn in range(TURNS):
                for name in (runs if turn % 2 == 0 else runs[::-1]):
                    with kernel_library(libs[name]):
                        turns[name].append(cs.kernel_ms(lambda: solve_lqr_cuda(sub, reg),
                                                        reps=20, graph=True))
            bound_ms = cs.riccati_bound(B, dtype)[0]
            old = statistics.median(turns[EARLIER])
            for name in runs:
                r = results[name][key]
                r.update(ms=statistics.median(turns[name]), ms_range=[min(turns[name]),
                                                                       max(turns[name])],
                         bound_ms=bound_ms)
                print(f"{key:>13} {name:>42}: {r['ms']:.5f} ms (turns {min(turns[name]):.5f}-"
                      f"{max(turns[name]):.5f}), {r['ms'] / bound_ms:.2f}x the bound "
                      f"{bound_ms:.5f} ms, {old / r['ms']:.2f}x faster than the earlier kernel; "
                      f"gate {'pass' if r['ok'] else 'FAIL'} (max err {r['err']:.3e}, "
                      f"{r['ratio']:.3f} of its limit at worst)",
                      flush=True)
        for name in order:
            if not all("ms" in results[name][f"float32 B={B}"] for B in cs.RICCATI_BATCHES):
                continue
            per_call = {cell: sum(n * results[name][f"float32 B={B}"]["ms"] for n, B in launches)
                        for cell, launches in SPLIT_LAUNCHES.items()}
            results[name]["riccati_ms_per_split_call"] = per_call
            print(f"{name:>42}: Riccati device time per split call, from these kernel times: "
                  + ", ".join(f"{cell} {ms:.4f} ms" for cell, ms in per_call.items()), flush=True)
        split = split_calls(cs, libs, pools, args.calls)
    gaps = {cell: abs(statistics.mean(r["as written"]["converged"])
                      - statistics.mean(r[EARLIER]["converged"])) for cell, r in split.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "builds": results, "split": split,
                      "converged_gap": gaps}), flush=True)
    failed = [n for n, r in results.items()
              if not all(v["ok"] for k, v in r.items() if k != "riccati_ms_per_split_call")]
    if failed:
        raise SystemExit(f"riccati_design_sweep: builds fail phase 2's gate: {failed}")
    if max(gaps.values()) > 1e-3:
        raise SystemExit(f"riccati_design_sweep: converged fractions differ by more than 0.001: "
                         f"{gaps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
