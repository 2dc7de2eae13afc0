// Probe of a loop whose trip count is read from device memory, for Hopper
// (sm_90a).
//
// Replaces: scripts/probe_dynamic_trip.py::kernel, the TPU probe of the
// mechanism the fused IPM kernel (csrc/ipm_fused.cu) depends on: its
// iteration count is an int32 in device memory, so one build serves every
// refine stage and a captured launch can be replayed with a new count.
// Contract: ops/probe.py::dynamic_trip_plain, out = x + iters (adding 1.0
// once per trip).
//
// What bounds it: nothing worth measuring.  It reads and writes one
// [8, 128] f32 tile (8 KB in all) and does `iters` additions per value;
// at any trip count that fits a test it is one launch's latency.
//
// Design: one thread per value, each reads the trip count itself.  The
// TPU's SMEM scalar prefetch and (8, 128) block spec have no counterpart.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128) probe_kernel(
    const int* __restrict__ iters, const float* __restrict__ x,
    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int trips = *iters;
  float acc = x[i];
  for (int j = 0; j < trips; ++j) acc += 1.0f;
  out[i] = acc;
}

}  // namespace

extern "C" int kissmpc_probe_dynamic_trip(const void* iters, const void* x,
                                          void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(iters), static_cast<const float*>(x),
        static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
