// Device helpers shared by csrc/ipm_split.cu and csrc/problem_build.cu.
//
// Both kernels must compute sin, cos, max, min and clip bit for bit alike:
// the build's completion rollout and the step kernel's rollout follow the
// same plain arithmetic, and their results meet in one solve.  Included
// after <cuda_runtime.h> (or the g++ shim that stands in for it); every
// name lives in an anonymous namespace, one copy per source.

#pragma once

#include <math.h>

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

// sin and cos of x: a two-part Cody-Waite reduction by pi/2 with FMA, then
// fdlibm's kernels on [-pi/4, pi/4]; within an ulp or two of the true
// values for |x| below ~1e15, NaN for |x| >= 5e18, inf and NaN.  CUDA's
// sin and cos keep a Payne-Hanek reduction for huge arguments in a stack
// frame; this keeps none.
__device__ __forceinline__ void sincos_rd(double x, double& s, double& c) {
  if (!(fabs(x) < 5e18)) {
    s = c = x - x;  // NaN (inf - inf, or NaN itself)
    return;
  }
  const double k = rint(x * 0.63661977236758134308);
  double r = fma(-k, 1.5707963267948966, x);
  r = fma(-k, 6.123233995736766e-17, r);
  const double z = r * r;
  const double ps = z * (-1.66666666666666324348e-01 +
                         z * (8.33333333332248946124e-03 +
                              z * (-1.98412698298579493134e-04 +
                                   z * (2.75573137070700676789e-06 +
                                        z * (-2.50507602534068634195e-08 +
                                             z * 1.58969099521155010221e-10)))));
  const double sn = fma(r, ps, r);
  const double pc = z * (4.16666666666666019037e-02 +
                         z * (-1.38888888888741095749e-03 +
                              z * (2.48015872894767294178e-05 +
                                   z * (-2.75573143513906633035e-07 +
                                        z * (2.08757232129817482790e-09 +
                                             z * -1.13596475577881948265e-11)))));
  const double hz = 0.5 * z, w = 1.0 - hz;
  const double cs = w + (((1.0 - w) - hz) + z * pc);
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

}  // namespace
