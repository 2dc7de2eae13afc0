// Device helpers shared by csrc/ipm_split.cu and csrc/problem_build.cu.
//
// Both kernels must compute sin, cos, max, min and clip bit for bit alike:
// the build's completion rollout and the step kernel's rollout follow the
// same plain arithmetic, and their results meet in one solve.  Both stage
// rows in shared memory by cp.async (`stage`).  Included
// after <cuda_runtime.h> (or the g++ shim that stands in for it); every
// name lives in an anonymous namespace, one copy per source.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

// max, min and clip that propagate NaN, as torch's do (no fast math).
__device__ __forceinline__ double maxp(double a, double b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double minp(double a, double b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ double clipp(double x, double lo, double hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ bool isfin(double x) { return fabs(x) <= 1.7976931348623157e308; }

// sin and cos of x: x less k pi/2 as a double-double (r, y), pi/2 taken
// as three doubles (x - k P1 is exact by FMA, k P2 is split exactly), then
// fdlibm's kernels on [-pi/4, pi/4] with the tail y; within an ulp of the
// true values, and equal to the correctly rounded ones for all but about 1
// in 500 arguments, for |x| below ~1e15; NaN for |x| >= 5e18, inf and NaN.
// CUDA's sin and cos keep a Payne-Hanek reduction for huge arguments in a
// stack frame; this keeps none.
__device__ __forceinline__ void sincos_rd(double x, double& s, double& c) {
  if (!(fabs(x) < 5e18)) {
    s = c = x - x;  // NaN (inf - inf, or NaN itself)
    return;
  }
  const double k = rint(x * 0.63661977236758134308);
  const double a = fma(-k, 1.5707963267948966, x);  // exact
  const double bh = k * 6.123233995736766e-17;
  const double bl = fma(k, 6.123233995736766e-17, -bh);
  const double rh = a - bh, bb = rh - a;  // a - bh = rh + e, exactly
  const double e = (a - (rh - bb)) - (bh + bb);
  const double rl = fma(-k, -1.4973849048591698e-33, e - bl);
  const double r = rh + rl, y = rl - (r - rh);
  const double z = r * r, w = z * z, v = z * r;
  const double ps = 8.33333333332248946124e-03 +
                    z * (-1.98412698298579493134e-04 + z * 2.75573137070700676789e-06) +
                    z * w * (-2.50507602534068634195e-08 + z * 1.58969099521155010221e-10);
  const double sn = r - ((z * (0.5 * y - v * ps) - y) - v * -1.66666666666666324348e-01);
  const double pc = z * (4.16666666666666019037e-02 +
                         z * (-1.38888888888741095749e-03 + z * 2.48015872894767294178e-05)) +
                    w * w * (-2.75573143513906633035e-07 +
                             z * (2.08757232129817482790e-09 + z * -1.13596475577881948265e-11));
  const double hz = 0.5 * z, u = 1.0 - hz;
  const double cs = u + (((1.0 - u) - hz) + (z * pc - r * y));
  switch (static_cast<int>(static_cast<long long>(k) & 3)) {
    case 0: s = sn; c = cs; break;
    case 1: s = cs; c = -sn; break;
    case 2: s = -sn; c = -cs; break;
    default: s = -cs; c = sn; break;
  }
}

// Butterfly sum, max and min: every lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}
__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = minp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

// A typed view of an untyped row at an element offset.
template <typename D> __device__ __forceinline__ const D* at(const void* ptr, long long off) {
  return static_cast<const D*>(ptr) + off;
}
template <typename D> __device__ __forceinline__ D* put(void* ptr, long long off) {
  return static_cast<D*>(ptr) + off;
}

// One value, or 16 bytes, from global memory to dst: ASYNC by cp.async into
// shared memory (the block waits with copies_done), else a load and a
// store (a global arena).
template <bool ASYNC, typename D> __device__ __forceinline__ void copy_one(D* dst, const D* src) {
#ifdef __CUDA_ARCH__
  if (ASYNC) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "n"(sizeof(D)));
    return;
  }
#endif
  *dst = *src;
}
template <bool ASYNC, typename D> __device__ __forceinline__ void copy_vec(D* dst, const D* src) {
#ifdef __CUDA_ARCH__
  if (ASYNC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src));
    return;
  }
#endif
  memcpy(dst, src, 16);
}
__device__ __forceinline__ void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The block's threads copy n values from global memory to dst: in 16-byte
// copies where dst and src lie at the same offset from a 16-byte boundary
// (the values before the first boundary and after the last one alone),
// value by value otherwise.
template <bool ASYNC, typename D>
__device__ __forceinline__ void stage(D* dst, const D* src, long long n, int tid, int nthr) {
  constexpr int V = 16 / sizeof(D);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) ^ a) & 15) == 0;
  long long head = vec ? static_cast<long long>((16 - a % 16) % 16 / sizeof(D)) : n;
  if (head > n) head = n;
  const long long nv = (n - head) / V;
  for (long long i = tid; i < head; i += nthr) copy_one<ASYNC>(dst + i, src + i);
  for (long long i = tid; i < nv; i += nthr)
    copy_vec<ASYNC>(dst + head + i * V, src + head + i * V);
  for (long long i = head + nv * V + tid; i < n; i += nthr) copy_one<ASYNC>(dst + i, src + i);
}

}  // namespace
