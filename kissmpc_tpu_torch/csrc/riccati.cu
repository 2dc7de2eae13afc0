// Batched Riccati solve of the IPM's Newton-KKT system, for Hopper (sm_90a).
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
