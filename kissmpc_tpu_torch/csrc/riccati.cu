// Batched Riccati solve of the IPM's Newton-KKT system, for Hopper (sm_90a).
//
// Replaces: kissmpc_tpu/ops/pallas/riccati.py::_riccati_kernel (the TPU
// kernel behind solve_lqr_pallas).  Contract: ops/lqr.py::solve_lqr of this
// package, its plain PyTorch version.  Per scenario b, one backward Riccati
// sweep (Quu/Qux/qu hats, closed-form regularized 2x2 inverse, gains K and
// k, P' symmetrized) and one forward rollout, nx = 3 and nu = 2; float and
// double from one template.
//
// What bounds it.  Bytes: per scenario it reads 1,815 values (A N*9, B N*6,
// d N*3, d0 3, Qxx (N+1)*9, qx (N+1)*3, Quu N*4, qu N*2 at N = 50) and
// writes 653 (dx (N+1)*3, du N*2 and the [N, 8] gains K, k that the
// wrapper returns): 2,468 values, 80.9 MB in f32 at B = 8192 (24 us at
// 3.35 TB/s), 161.7 MB in f64 (48 us).  Its ~445 flops per step are 3 us
// (f32) / 5 us (f64) at the card's peak.  But at the split path's refine
// stages (B = 164-1024, most of its launches) the card is nearly empty and
// the time is one scenario's chain of N backward and N forward steps, so
// the design shortens that chain as well as streaming the bytes.
//
// Staging.  Inputs are batch-major, as the IPM builds them ([B, N, 3, 3]
// ...), so the S scenarios of a block are one contiguous span of every
// tensor, and the span of a time chunk is S contiguous segments, one per
// scenario.  Time is cut into chunks of C steps from the horizon's end; each
// (tensor, scenario) segment of a chunk is one bulk (TMA) copy into shared
// memory, issued by one thread, that completes on the chunk buffer's
// mbarrier (one arrival, lane 0's, with the warp's bytes); the ring has two
// buffers, so chunk c+1 is in flight while chunk c is swept.  A segment
// seldom starts on 16 bytes (at N = 50 the per-scenario strides of d, Qxx
// and qx are 600, 1,836 and 612 bytes), so each is copied from the 16-byte
// boundary at or below its start into a slot with 16 bytes of slack, and
// read from its offset inside the slot; only the tensor's first and last
// segments can reach past its ends, and their values there are copied one by
// one.  The forward rollout walks the chunks back in the same buffers,
// staging only A, B and d (from L2: the sweep has just read them); its first
// chunk is the sweep's last, still held.  Each step's inputs are loaded into
// registers while the step before it runs.  The copy and the barrier's init,
// arrive and wait are the functions between the "staging primitives" marks,
// which a CPU rehearsal of this source replaces
// (scripts/riccati_cpu_shim.py).
//
// Chunk length by batch: C = kChunkSmall = 32 at B <= kSmallBatch = 1024
// (every refine stage), where a block's time is its chain and fewer chunks
// mean fewer waits; C = kChunkLarge = 16 above, where smaller buffers let
// more blocks share an SM, and at any B where the ring of 32 steps does not
// fit beside the gains (f32 above N = 612, f64 above 162).
// scripts/riccati_design_sweep.py measured both (and 8) at every batch; B
// and N alone decide, no setting does.
//
// Gains stay on chip up to max_horizon.  K and k go to a [S, N, 8] region
// of shared memory from the sweep to the rollout; after the sweep the block
// writes it out once, with 16-byte stores (the block's span of the
// [B, N, 8] output is contiguous and 16-byte aligned).  dx and du are
// written as the rollout makes them, each value by one lane of its
// scenario.  Above max_horizon the launcher takes the kernel's other
// instance (template flag GLOBAL_GAINS): the sweep writes K and k straight
// to the gains output and the rollout reads them back from device memory
// (from L2, where the sweep has just written them), so shared memory holds
// only the staging ring and its barriers and no longer grows with N.
//
// Four lanes per scenario.  A step is written over the augmented 3 x 4
// system [A | d]: column c < 3 of P A, of Qux = B' P A and of
// K = -Quu^-1 Qux, and the new P's column c; column 3 is P d + p, qu_hat, k
// and the new p.  Lane r of a scenario's four takes column r; each lane
// computes B' P B and the 2 x 2 inverse itself, then the four exchange the
// Qux columns and the new columns by __shfl_sync (18 shuffles a step).
// That halves the arithmetic a lane issues per step against one thread per
// scenario.  A block is one warp: S = kScenarios = 8 scenarios.
// scripts/riccati_design_sweep.py rebuilds 1 and 2 lanes per scenario and
// 2 and 4 warps per block from edits to a copy of this source: 4 lanes and
// one warp were the fastest that fit, from B = 164 to 8192, in f32 and f64.
// Still, one lone warp's chain of ~100 steps sets the time at the refine
// stages' batches (scripts/riccati_phase_clocks.py splits a block's cycles).
//
// Shared memory per block: S * (8 N values of gains + 2 ring buffers) + 16
// bytes of barriers, a buffer holding 36 values per step for C steps plus
// 16 bytes of slack per tensor.  At N = 50: f32 12,800 bytes of gains and
// 38,656 (C = 16) or 75,520 (C = 32) of ring per block, 51,472 / 88,336 in
// all; f64 25,600 + 75,520 / 149,248, 101,136 / 174,864.  The gains grow
// with N, so the on-chip instance takes N up to the 227 KB a block may take
// on sm_90, the same at every batch since C = 16 is taken wherever 32 does
// not fit: N <= 756 in f32 and 306 in f64 (kissmpc_riccati_max_horizon).
// Above it the global-gains instance runs, with the ring alone (chunks of 32
// at B <= 1024, 16 above, as on chip): 75,536 / 38,672 bytes per block in
// f32, 149,264 / 75,536 in f64, at any N.  A launch the card refuses still
// raises (ops/riccati.py).  The shared-memory attribute is set once per
// instance and device.
//
// The TPU's artefacts are gone: no BT = 512 tile, no padding of the batch
// to a tile multiple, no VMEM specs, no scenario-major transpose.  The
// ragged last block masks its loads and stores by b < B; its idle lanes
// still take part in every barrier and shuffle.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 32;      // one warp per block
constexpr int kLanes = 4;         // lanes per scenario: lane r takes column r of [A | d]
constexpr int kScenarios = kThreads / kLanes;  // per block
constexpr int kChunkSmall = 32;   // time steps per staged chunk at B <= kSmallBatch
constexpr int kChunkLarge = 16;   // above it, and wherever kChunkSmall does not fit
constexpr int kSmallBatch = 1024;
constexpr size_t kSmemOptin = 227 * 1024;  // dynamic shared memory a block may take on sm_90
constexpr int kTensors = 7;       // staged: A, B, d, Qxx, qx, Quu, qu
constexpr unsigned kFull = 0xffffffffu;

// Values per time step of staged tensor k, and its rows per scenario.
__host__ __device__ constexpr int width_of(int k) {
  return k == 0 ? 9 : k == 1 ? 6 : k == 2 ? 3 : k == 3 ? 9 : k == 4 ? 3 : k == 5 ? 4 : 2;
}
__host__ __device__ constexpr int rows_of(int k, int N) { return (k == 3 || k == 4) ? N + 1 : N; }

// Bytes of one scenario's slot of tensor k in one ring buffer of chunks of
// C steps: the chunk's values rounded up to 16 bytes, plus 16 for a segment
// that starts inside a 16-byte unit.
template <typename T, int C>
__host__ __device__ constexpr int slot_bytes(int k) {
  return (C * width_of(k) * static_cast<int>(sizeof(T)) + 15) / 16 * 16 + 16;
}
template <typename T, int C>
__host__ __device__ constexpr int slot_offset(int k) {  // per scenario, before tensor k
  int offset = 0;
  for (int j = 0; j < k; ++j) offset += slot_bytes<T, C>(j);
  return offset;
}
template <typename T, int C>
__host__ __device__ constexpr int ring_bytes() { return slot_offset<T, C>(kTensors); }

// ``kept`` steps of gains (N on chip, 0 in the global-gains instance), two
// ring buffers, their two barriers.
template <typename T, int C>
size_t smem_bytes(int kept) {
  return static_cast<size_t>(kScenarios) *
             (static_cast<size_t>(kept) * 8 * sizeof(T) + 2 * ring_bytes<T, C>()) + 16;
}

// The longest horizon whose gains stay on chip: they fit beside the ring of
// kChunkLarge steps, at every batch (the launcher takes kChunkSmall only
// where it fits).  Above it the global-gains instance runs.
template <typename T>
int max_horizon() {
  const size_t ring = smem_bytes<T, kChunkLarge>(0);
  return ring > kSmemOptin ? 0
                           : static_cast<int>((kSmemOptin - ring) / (kScenarios * 8 * sizeof(T)));
}

// ---- staging primitives (a CPU rehearsal replaces this block) -------------
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
// ``count`` arrivals (and the bytes expected of them) complete a phase.
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One bulk (TMA) copy of ``bytes`` from global to shared memory, a multiple
// of 16 between 16-byte aligned addresses, counted on ``bar`` as it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// Arrive on the barrier, and add ``bytes`` of bulk copies to what its
// current phase waits for (copies may land before: the count goes below 0).
__device__ __forceinline__ void bar_arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Return once the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// ---- end of staging primitives ---------------------------------------------

template <typename T>
struct Inputs {
  const T* t[kTensors];  // A, B, d, Qxx, qx, Quu, qu
  const T* d0;
};

template <typename T>
__device__ __forceinline__ const T* tensor_of(const Inputs<T>& in, int k) {
  return k == 0 ? in.t[0] : k == 1 ? in.t[1] : k == 2 ? in.t[2] : k == 3 ? in.t[3]
       : k == 4 ? in.t[4] : k == 5 ? in.t[5] : in.t[6];
}

// Scenario b's values of tensor k at times [lo, hi): global addresses
// [first, last); its slot's first byte holds address ``base`` (the 16-byte
// boundary at or below ``first``); [bulk_lo, bulk_hi) is the part that one
// bulk copy takes, 16-byte aligned and inside the tensor, empty when
// bulk_hi <= bulk_lo.  Only the tensor's first and last segments can reach
// past its ends; [first, last) outside the bulk part is copied value by value.
struct Segment {
  uintptr_t first, last, base, bulk_lo, bulk_hi;
};

template <typename T>
__device__ __forceinline__ Segment segment_of(const Inputs<T>& in, int k, int b, int B, int N,
                                              int lo, int hi) {
  constexpr uintptr_t kLow = 15;
  const size_t w = static_cast<size_t>(width_of(k)), R = static_cast<size_t>(rows_of(k, N));
  const uintptr_t tb = reinterpret_cast<uintptr_t>(tensor_of(in, k));
  const uintptr_t te = tb + static_cast<size_t>(B) * R * w * sizeof(T);
  Segment g;
  g.first = tb + (static_cast<size_t>(b) * R + lo) * w * sizeof(T);
  g.last = g.first + static_cast<size_t>(hi - lo) * w * sizeof(T);
  g.base = g.first & ~kLow;
  const uintptr_t tb_up = (tb + kLow) & ~kLow, te_down = te & ~kLow;
  const uintptr_t last_up = (g.last + kLow) & ~kLow;
  g.bulk_lo = g.base > tb_up ? g.base : tb_up;
  g.bulk_hi = last_up < te_down ? last_up : te_down;
  return g;
}

// Stage times [lo, hi) of tensors 0..K-1 for the block's scenarios
// b0 .. b0+nvalid-1 into ring buffer ``ring``, completing on ``bar``: one
// bulk copy per (tensor, scenario) segment, thread i taking segments
// i, i + kThreads, ...  Lane 0 arrives once with the warp's copies' bytes,
// the barrier's one arrival of a phase.
template <typename T, int K, int C>
__device__ __forceinline__ void stage_chunk(const Inputs<T>& in, unsigned char* ring, int S,
                                            int nvalid, int B, int b0, int N, int lo, int hi,
                                            unsigned long long* bar) {
  unsigned bytes = 0;
  for (int j = threadIdx.x; j < K * nvalid; j += kThreads) {
    const int k = nvalid == kScenarios ? j / kScenarios : j / nvalid, s = j - k * nvalid;
    const Segment g = segment_of(in, k, b0 + s, B, N, lo, hi);
    unsigned char* slot = ring + static_cast<size_t>(S) * slot_offset<T, C>(k) +
                          static_cast<size_t>(s) * slot_bytes<T, C>(k);
    uintptr_t head_end = g.last, tail_start = g.last;
    if (g.bulk_hi > g.bulk_lo) {
      bulk_copy(slot + (g.bulk_lo - g.base), reinterpret_cast<const void*>(g.bulk_lo),
                static_cast<unsigned>(g.bulk_hi - g.bulk_lo), bar);
      bytes += static_cast<unsigned>(g.bulk_hi - g.bulk_lo);
      head_end = g.bulk_lo < g.last ? g.bulk_lo : g.last;
      tail_start = g.bulk_hi > g.first ? g.bulk_hi : g.first;
    }
    for (uintptr_t at = g.first; at < head_end; at += sizeof(T))
      *reinterpret_cast<T*>(slot + (at - g.base)) = *reinterpret_cast<const T*>(at);
    for (uintptr_t at = tail_start; at < g.last; at += sizeof(T))
      *reinterpret_cast<T*>(slot + (at - g.base)) = *reinterpret_cast<const T*>(at);
  }
  bytes = __reduce_add_sync(kFull, bytes);
  __syncwarp();  // the lanes' value copies before the leader's release
  if (threadIdx.x == 0) bar_arrive_expect(bar, bytes);
}

// Where scenario s's values of tensor k at time lo start in ring buffer
// ``ring`` (the segment's offset inside its 16-byte-aligned slot).
template <typename T, int C>
__device__ __forceinline__ const T* staged(const Inputs<T>& in, const unsigned char* ring, int S,
                                           int s, int b, int N, int lo, int k) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(in.t[k]) +
      (static_cast<size_t>(b) * rows_of(k, N) + lo) * width_of(k) * sizeof(T);
  return reinterpret_cast<const T*>(ring + static_cast<size_t>(S) * slot_offset<T, C>(k) +
                                    static_cast<size_t>(s) * slot_bytes<T, C>(k) + (first & 15));
}

// Value v of lane ``src`` of this lane's group of kLanes.
template <typename T>
__device__ __forceinline__ T from_lane(T v, int src) {
  return __shfl_sync(kFull, v, src, kLanes);
}

// One backward step's inputs in registers, for lane r of a scenario's
// group: all of A, B, Quu and qu; column r of [A | d] and of [Qxx | qx].
template <typename T>
struct StepIn {
  T a[9], bm[6], quu[4], qu[2], col[3], qcol[3];
};

// The staged row pointers of one chunk (time lo first).
template <typename T>
struct Rows {
  const T *a, *bm, *dv, *Qxx, *qx, *Quu, *qu;
};

template <typename T>
__device__ __forceinline__ void load_step(StepIn<T>& v, const Rows<T>& x, int k, int r) {
#pragma unroll
  for (int i = 0; i < 9; ++i) v.a[i] = x.a[k * 9 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) v.bm[i] = x.bm[k * 6 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) v.quu[i] = x.Quu[k * 4 + i];
#pragma unroll
  for (int i = 0; i < 2; ++i) v.qu[i] = x.qu[k * 2 + i];
  const T* col = r < 3 ? x.a + k * 9 + r : x.dv + k * 3;
  const T* q = r < 3 ? x.Qxx + k * 9 + r : x.qx + k * 3;
  const int cs = r < 3 ? 3 : 1;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v.col[i] = col[i * cs];
    v.qcol[i] = q[i * cs];
  }
}

// One backward step: P, p <- the step's value function; the gains K
// (row-major 2 x 3) and k go to g[0..5], g[6..7].  Lane r of the group
// computes column r of the augmented system [A | d].
// ``store`` is false only for the idle lanes of a ragged block in the
// global-gains instance, which have no row of the output to write.
template <typename T>
__device__ __forceinline__ void backward_step(T (&P)[9], T (&p)[3], const StepIn<T>& v, T* g,
                                              int r, T reg, bool store) {
  static_assert(kLanes == 4, "one lane per column of [A | d]");
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

  // Column r of P[A|d] (+ p in column 3), of B'P[A|d] (+ qu), of the gains.
  T PAc[3], Qc[2], Kc[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T s = r < 3 ? T(0) : p[i];
#pragma unroll
    for (int x = 0; x < 3; ++x) s += P[i * 3 + x] * v.col[x];
    PAc[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T s = r < 3 ? T(0) : v.qu[i];
#pragma unroll
    for (int x = 0; x < 3; ++x) s += v.bm[x * 2 + i] * PAc[x];
    Qc[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    Kc[i] = -(inv[i * 2 + 0] * Qc[0] + inv[i * 2 + 1] * Qc[1]);
    if (store) g[r < 3 ? i * 3 + r : 6 + i] = Kc[i];
  }
  // Every lane needs all of Qux = B'PA.
  T Qux[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) Qux[i][c] = from_lane(Qc[i], c);
  // Column r of [P' | p'] = [Qxx | qx] + A'P[A|d] + Qux'[K | k].
  T Pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T s1 = T(0), s2 = T(0);
#pragma unroll
    for (int x = 0; x < 3; ++x) s1 += v.a[x * 3 + i] * PAc[x];
#pragma unroll
    for (int x = 0; x < 2; ++x) s2 += Qux[x][i] * Kc[x];
    Pc[i] = v.qcol[i] + s1 + s2;
  }
  T Pn[3][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) Pn[i][c] = from_lane(Pc[i], c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[i * 3 + j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
    p[i] = Pn[i][3];
  }
}

// One forward step's inputs: the gains row, A, B and d.
template <typename T>
struct RollIn {
  T g[8], a[9], bm[6], dv[3];
};

template <typename T>
__device__ __forceinline__ void load_roll(RollIn<T>& v, const T* g, const Rows<T>& x, int k) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v.g[i] = g[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) v.a[i] = x.a[k * 9 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) v.bm[i] = x.bm[k * 6 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) v.dv[i] = x.dv[k * 3 + i];
}

template <typename T, int C, bool GLOBAL_GAINS>
__global__ void __launch_bounds__(kThreads) riccati_kernel(
    const Inputs<T> in, T* __restrict__ dx, T* __restrict__ du, T* __restrict__ gains,
    int B, int N, T reg) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = kScenarios;
  const int s = threadIdx.x / kLanes, r = threadIdx.x % kLanes;
  const int b0 = blockIdx.x * S;
  const int nvalid = B - b0 < S ? B - b0 : S;
  const bool valid = s < nvalid;
  const int b = b0 + s;
  const size_t n = static_cast<size_t>(N);
  // This scenario's gains [N, 8]: in shared memory, or its rows of the
  // output (an idle lane reads, and never writes, the block's first
  // scenario's).
  T* gs = GLOBAL_GAINS ? gains + static_cast<size_t>(valid ? b : b0) * n * 8
                       : reinterpret_cast<T*>(smem) + static_cast<size_t>(s) * n * 8;
  unsigned char* ring = GLOBAL_GAINS ? smem : smem + static_cast<size_t>(S) * n * 8 * sizeof(T);
  const size_t buffer = static_cast<size_t>(S) * ring_bytes<T, C>();
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(ring + 2 * buffer);
  const int chunks = (N + C - 1) / C;
  auto lo_of = [&](int c) { return N - (c + 1) * C > 0 ? N - (c + 1) * C : 0; };
  auto hi_of = [&](int c) { return N - c * C; };
  auto rows_at = [&](int c) {
    const unsigned char* buf = ring + (c & 1) * buffer;
    const int lo = lo_of(c);
    auto at = [&](int k) { return staged<T, C>(in, buf, S, s, b, N, lo, k); };
    return Rows<T>{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  };
  // Chunk c lives in buffer c & 1, whose barrier completes one phase per
  // staging; bit i of ``phases`` is the parity of buffer i's next phase.
  unsigned phases = 0;
  auto wait_for = [&](int c) {
    const int i = c & 1;
    bar_wait(&bars[i], (phases >> i) & 1u);
    phases ^= 1u << i;
  };
  if (threadIdx.x == 0) {
    bar_init(&bars[0], 1);
    bar_init(&bars[1], 1);
  }
  __syncthreads();

  // ---- backward sweep over chunks 0, 1, ... (times from the end) ---------
  T P[9], p[3];
  const size_t term = static_cast<size_t>(b) * (n + 1) + n;
#pragma unroll
  for (int i = 0; i < 9; ++i) P[i] = valid ? in.t[3][term * 9 + i] : T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = valid ? in.t[4][term * 3 + i] : T(0);
  stage_chunk<T, kTensors, C>(in, ring, S, nvalid, B, b0, N, lo_of(0), hi_of(0), &bars[0]);
  if (chunks > 1)
    stage_chunk<T, kTensors, C>(in, ring + buffer, S, nvalid, B, b0, N, lo_of(1), hi_of(1),
                                &bars[1]);

  for (int c = 0; c < chunks; ++c) {
    wait_for(c);
    const int lo = lo_of(c), hi = hi_of(c);
    const Rows<T> x = rows_at(c);
    // Step t's inputs are loaded while step t+1 is swept.
    StepIn<T> cur;
    load_step(cur, x, hi - 1 - lo, r);
    for (int t = hi - 1; t >= lo; --t) {
      StepIn<T> next;
      load_step(next, x, (t > lo ? t - 1 : t) - lo, r);
      backward_step(P, p, cur, gs + static_cast<size_t>(t) * 8, r, reg, !GLOBAL_GAINS || valid);
      cur = next;
    }
    __syncthreads();  // the buffer is read; the copies of chunk c + 2 may land in it
    if (c + 2 < chunks)
      stage_chunk<T, kTensors, C>(in, ring + (c & 1) * buffer, S, nvalid, B, b0, N, lo_of(c + 2),
                               hi_of(c + 2), &bars[c & 1]);
  }

  // ---- the gains out, once, 16 bytes at a time (on chip only; the sweep's
  // last __syncthreads made the global instance's writes visible) ---------
  if constexpr (!GLOBAL_GAINS) {
    struct alignas(16) Unit { unsigned int v[4]; };
    const size_t units = static_cast<size_t>(nvalid) * n * 8 * sizeof(T) / 16;
    const Unit* from = reinterpret_cast<const Unit*>(smem);
    Unit* to = reinterpret_cast<Unit*>(gains + static_cast<size_t>(b0) * n * 8);
    for (size_t i = threadIdx.x; i < units; i += kThreads) to[i] = from[i];
  }

  // ---- forward rollout over chunks chunks-1, ..., 0 (A, B, d only) --------
  // Chunk chunks-1 is the sweep's last, still in its buffer.
  if (chunks > 1)
    stage_chunk<T, 3, C>(in, ring + ((chunks - 2) & 1) * buffer, S, nvalid, B, b0, N,
                      lo_of(chunks - 2), hi_of(chunks - 2), &bars[(chunks - 2) & 1]);
  T xs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) xs[i] = valid ? in.d0[static_cast<size_t>(b) * 3 + i] : T(0);
  T* dx_b = dx + static_cast<size_t>(b) * (n + 1) * 3;
  T* du_b = du + static_cast<size_t>(b) * n * 2;
  if (valid) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i == r) dx_b[i] = xs[i];
  }
  for (int c = chunks - 1; c >= 0; --c) {
    if (c < chunks - 1) wait_for(c);
    const int lo = lo_of(c), hi = hi_of(c);
    const Rows<T> x = rows_at(c);
    RollIn<T> cur;
    load_roll(cur, gs + static_cast<size_t>(lo) * 8, x, 0);
    for (int t = lo; t < hi; ++t) {
      const int tn = t + 1 < hi ? t + 1 : t;
      RollIn<T> next;
      load_roll(next, gs + static_cast<size_t>(tn) * 8, x, tn - lo);
      T u[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        T acc = cur.g[6 + i];
#pragma unroll
        for (int j = 0; j < 3; ++j) acc += cur.g[i * 3 + j] * xs[j];
        u[i] = acc;
      }
      T xn[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        T s1 = T(0), s2 = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) s1 += cur.a[i * 3 + j] * xs[j];
#pragma unroll
        for (int j = 0; j < 2; ++j) s2 += cur.bm[i * 2 + j] * u[j];
        xn[i] = s1 + s2 + cur.dv[i];
      }
      // du[t] and dx[t+1]: value r by lane r, value 4 by lane 0 too.
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int v = r + kLanes * m;
        const T out = v == 0 ? u[0] : v == 1 ? u[1] : v == 2 ? xn[0] : v == 3 ? xn[1] : xn[2];
        T* at = v < 2 ? du_b + static_cast<size_t>(t) * 2 + v
                      : dx_b + static_cast<size_t>(t + 1) * 3 + (v - 2);
        if (valid && v < 5) *at = out;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) xs[i] = xn[i];
      cur = next;
    }
    __syncthreads();  // the buffer is read; the copies of chunk c - 2 may land in it
    if (c >= 2)
      stage_chunk<T, 3, C>(in, ring + (c & 1) * buffer, S, nvalid, B, b0, N, lo_of(c - 2),
                        hi_of(c - 2), &bars[c & 1]);
  }
}

template <typename T>
using KernelFn = void (*)(const Inputs<T>, T*, T*, T*, int, int, T);

// The chunk length of a batch of B with ``kept`` steps of gains in shared
// memory: kChunkSmall at B <= kSmallBatch where its ring fits beside them,
// kChunkLarge else.
template <typename T>
int chunk_for(int B, int kept) {
  return B <= kSmallBatch && smem_bytes<T, kChunkSmall>(kept) <= kSmemOptin ? kChunkSmall
                                                                             : kChunkLarge;
}

template <typename T>
size_t smem_for(int B, int kept) {
  return chunk_for<T>(B, kept) == kChunkSmall ? smem_bytes<T, kChunkSmall>(kept)
                                              : smem_bytes<T, kChunkLarge>(kept);
}

// Let instance (C, G) take a block's whole dynamic shared memory (above
// 48 KB it must be allowed before its first launch), once per device: the
// attribute is per device, and setting it on every launch would cost the
// host a call.
template <typename T, int C, bool G>
cudaError_t allow_shared_memory() {
  constexpr int kDevices = 64;
  static std::atomic<bool> allowed[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device < kDevices && allowed[device].load(std::memory_order_relaxed))
    return cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(riccati_kernel<T, C, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemOptin));
  if (err == cudaSuccess && device < kDevices)
    allowed[device].store(true, std::memory_order_relaxed);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller reports it
  return err;
}

template <typename T, bool G>
cudaError_t pick(int B, int kept, KernelFn<T>* kernel) {
  if (chunk_for<T>(B, kept) == kChunkSmall) {
    *kernel = riccati_kernel<T, kChunkSmall, G>;
    return allow_shared_memory<T, kChunkSmall, G>();
  }
  *kernel = riccati_kernel<T, kChunkLarge, G>;
  return allow_shared_memory<T, kChunkLarge, G>();
}

// The instantiation a batch of B at horizon N takes and its dynamic shared
// memory: the gains on chip up to max_horizon, in the output above it.
template <typename T>
cudaError_t prepare(int B, int N, KernelFn<T>* kernel, size_t* bytes) {
  const bool on_chip = N <= max_horizon<T>();
  const int kept = on_chip ? N : 0;
  *bytes = smem_for<T>(B, kept);
  return on_chip ? pick<T, false>(B, kept, kernel) : pick<T, true>(B, kept, kernel);
}

template <typename T>
int launch(const void* A, const void* Bm, const void* d, const void* d0,
           const void* Qxx, const void* qx, const void* Quu, const void* qu,
           void* dx, void* du, void* gains, int B, int N, double reg,
           void* stream) {
  if (B > 0) {
    KernelFn<T> kernel;
    size_t bytes;
    const cudaError_t err = prepare<T>(B, N, &kernel, &bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    Inputs<T> in;
    const void* ts[kTensors] = {A, Bm, d, Qxx, qx, Quu, qu};
    for (int k = 0; k < kTensors; ++k) in.t[k] = static_cast<const T*>(ts[k]);
    in.d0 = static_cast<const T*>(d0);
    const int blocks = (B + kScenarios - 1) / kScenarios;
    kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<T*>(dx), static_cast<T*>(du), static_cast<T*>(gains), B, N,
        static_cast<T>(reg));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int B, int N, int* out) {
  KernelFn<T> kernel;
  size_t bytes;
  cudaError_t err = prepare<T>(B, N, &kernel, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kLanes;
  out[1] = kScenarios;
  out[2] = static_cast<int>(bytes);
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
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

// Dynamic shared memory per block of the on-chip instance (the gains of all
// N steps in shared memory) for B scenarios with horizon N and values of
// ``elem_bytes`` (4 or 8); above kissmpc_riccati_max_horizon it exceeds
// what a block may take, and the launcher takes the global-gains instance
// (kissmpc_riccati_occupancy reports what a launch takes).  Host arithmetic
// only: no CUDA call.
extern "C" long long kissmpc_riccati_smem_bytes(int B, int N, int elem_bytes) {
  return static_cast<long long>(elem_bytes == 8 ? smem_for<double>(B, N)
                                                : smem_for<float>(B, N));
}

// The longest horizon whose gains stay in shared memory, at every batch, in
// values of ``elem_bytes``; the kernel takes any N.  Host arithmetic only:
// no CUDA call.
extern "C" int kissmpc_riccati_max_horizon(int elem_bytes) {
  return elem_bytes == 8 ? max_horizon<double>() : max_horizon<float>();
}

// The launch shape of a solve of B scenarios with horizon N: out = {lanes
// per scenario, scenarios per block, dynamic shared bytes per block,
// resident blocks per SM, registers per thread, local (spill) bytes per
// thread}.  Returns a cudaError_t.
extern "C" int kissmpc_riccati_occupancy(int B, int N, int elem_bytes, int* out) {
  return elem_bytes == 8 ? occupancy<double>(B, N, out) : occupancy<float>(B, N, out);
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
