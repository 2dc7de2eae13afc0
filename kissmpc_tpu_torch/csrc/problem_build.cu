// The problem build for Hopper (sm_90a): one launch from an obstacle set,
// the start, the goal and the warm start to a batch of Problems.
//
// Replaces: no TPU kernel.  The reference builds its Problems under jax.jit
// (kissmpc_tpu/solver/problem.py:278, `problem_with_obstacles`, inside the
// node's jitted tick kissmpc_tpu/io/model.py:97, the fleet tick and the
// pool builder kissmpc_tpu/scenarios.py:182), where XLA fuses the sensor
// top-K, the track prediction, the rows of `default_problem`, the three
// passes of `repair_warm_start`, the "moved" test and the `lax.scan` of
// `complete_warm_start` (:273) into a handful of kernels.  This kernel is
// the port's counterpart of that fusion.  Contract: the plain version
// kissmpc_tpu_torch/ops/problem_build.py::build_plain, which it follows
// step by step.
//
// build_kernel: one warp per scenario, up to kBuildWarps scenarios per
// block; each warp's rows live in its own part of the block's dynamic
// shared memory (a global scratch where one scenario's rows pass the
// card's 227 KB: the GLOBAL instance, long horizons).
//  (0) The rows that do not depend on the obstacles: the start, the goal,
//      the control and state bounds and the inflation (the launch's
//      numbers), each rounded to the data type as the plain version's
//      fills round them.
//  (1) The sensor's top K: each lane computes one obstacle's key (its
//      surface distance) into shared memory, then ranks it among all
//      K_all, the order of `lax.top_k` (ties to the lower slot, inactive
//      and non-finite distances last); the obstacle of rank r < K fills
//      slot r: its radius, its mask (active and within the sensor
//      radius).
//  (2) The tracks: a track that does not turn keeps one heading, whose
//      cosine and sine are computed once; for the turning ones the lanes
//      take (slot, stage) and fill a table of each step's cosine and sine,
//      kTrackChunk stages at a time.  One lane per (slot, coordinate) sums
//      the steps in stage order, as `predict_tracks`' cumulative sum does
//      (the sequential order is kept: a scan would round otherwise).
//  (3) The warm start: the caller's (any batch stride, staged by cp.async
//      from the start of the kernel on), or the start tiled.
//  (4) The repair's passes, lanes over stages, each pass reading the
//      previous one's path: two rows of shared memory take turns.  An
//      obstacle surely out of reach needs no square root, a state that no
//      obstacle pushes stays as it is, and a pass that moved no state ends
//      the passes (the next ones would compute the same path).
//  (5) How far the repair moved the path (or, without repair, the deepest
//      intrusion), a butterfly max; where it exceeds the threshold, (6) the
//      completion rollout over the repaired path, stage by stage: every
//      lane carries the same state; lane k takes obstacle k's speed cap and,
//      ahead of the choice, the heading error it would steer to if k
//      blocked; a butterfly (cap, slot) minimum over the lanes that hold an
//      obstacle picks the blocking one (ties to the lower slot, as
//      torch.argmin), and the state's next value takes the blocked or the
//      free heading error, both already computed.
//  (7) The Problem's rows out of shared memory: the tracks, the warm states
//      and controls, each a contiguous span, consecutive lanes storing
//      consecutive values.
//
// What bounds it: by bytes, the outputs (the tracks, K * N * 2 values per
// scenario, and the warm start); in practice the double-precision work of
// the tracks' sines and cosines and the repair's distances, and, where a
// scenario is rolled out, the rollout's chain of N dependent steps of a few
// transcendentals each (atan2, sin, cos, sqrt).  The design spends each
// transcendental once, on a lane that has work, and keeps every row the
// scenario reads again on chip.
//
// Templated on the data type D (float, double); it computes in double and
// rounds what it stores, the rollout's state each step, the rows it reads
// back (tracks, the repaired path) as the plain version holds them.  sin
// and cos are the split kernels' own (`sincos_rd`, csrc/device_math.cuh), atan2
// is CUDA's double atan2.  Compiled without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

// Mirror of `_Params` in ops/problem_build.py (ints first, then doubles).
struct BuildParams {
  int B, N, K, K_all, repair, complete, passes;
  double dt, pred_dt, sensor_radius, threshold, margin;
  double cl[2], cu[2], xl[3], xu[3], infl;  // the bounds and the inflation
};

// The inputs: the start, the goal, the warm start (null: the start tiled;
// null controls: zeros), the obstacle set's leaves (ObstacleSet field
// order).
struct BuildIn {
  const void *x0, *goal, *warm_x, *warm_u;
  const void *pos, *rad, *orient, *lin, *ang, *act;
};

// Batch strides (elements) of the inputs that take one; 0 shares a row.
struct BuildStrides {
  long long x0, goal, warm_x, warm_u, pos, rad, orient, lin, ang, act;
};

// The Problem's leaves, in its field order.
struct BuildOut {
  void *x0, *goal, *cl, *cu, *xl, *xu, *centers, *radii, *mask, *infl, *warm_x, *warm_u;
};

namespace {

constexpr int kBuildWarps = 4;            // scenarios per block at most
constexpr long long kSmemOptin = 232448;  // sm_90's opt-in shared memory per block
constexpr int kSlotValues = 13;           // a slot's values in shared memory
constexpr int kTrackChunk = 16;           // stages of the turning tracks' table at a time
constexpr int kObsValues = 8;             // an obstacle's values in shared memory
// A square distance surely past (need)^2 when above need * need * kFar:
// the rounding of need * need and of this product is far below 2^-50.
constexpr double kFar = 1.0 + 0x1p-50;

__device__ __forceinline__ double inf() { return static_cast<double>(INFINITY); }

// The angle x wrapped to (-pi, pi] as atan2(sin x, cos x).
__device__ __forceinline__ double wrap(double x) {
  double s, c;
  sincos_rd(x, s, c);
  return atan2(s, c);
}

// A launch's number rounded to D, as the plain version's fill rounds it.
template <typename D> __device__ __forceinline__ double rounded(double number) {
  return static_cast<D>(number);
}

// a + b and a * b of values of D, rounded to D and never contracted into
// an FMA: D's own arithmetic (the double operation of two floats rounds
// to the float operation's result).
template <typename D> __device__ __forceinline__ double add_d(double a, double b) {
  return static_cast<D>(__dadd_rn(a, b));
}
template <typename D> __device__ __forceinline__ double mul_d(double a, double b) {
  return static_cast<D>(__dmul_rn(a, b));
}

// An obstacle's sensor key for the point (px, py), from its position,
// radius and activity (values of D): its surface distance in D's
// arithmetic as obstacles.py::distance_to_point computes it on the CPU
// (the norm's squares summed in D, no FMA), +inf where it is inactive or
// the distance is not finite.  The ranking's ties are the plain version's:
// the sampled scenarios push circles to one clearance from the start, so
// exact ties are common.
template <typename D>
__device__ __forceinline__ double sensor_key(double x, double y, double rad, double act,
                                             double px, double py) {
  const double dx = add_d<D>(x, -px), dy = add_d<D>(y, -py);
  const double nrm = static_cast<D>(sqrt(add_d<D>(mul_d<D>(dx, dx), mul_d<D>(dy, dy))));
  const double key = add_d<D>(nrm, -rad);
  return act > 0.5 && isfin(key) ? key : inf();
}

// A warp's lanes store n values of src at dst: 16 bytes a lane where both
// start on 16 bytes, else value by value.
template <typename D>
__device__ __forceinline__ void store_span(D* dst, const D* src, int n, int lane) {
  constexpr int V = 16 / sizeof(D);
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int nv = vec ? n / V : 0;
  for (int i = lane; i < nv; i += kLanes)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = nv * V + lane; i < n; i += kLanes) dst[i] = src[i];
}

// One scenario's rows in shared memory (or its global scratch), in bytes
// from its base; every row starts on 16 bytes.
struct Layout {
  long long obs, sel, slot, trig, path_b, tracks, path, path0, ctrl, bytes;
};
__host__ __device__ inline long long align16(long long n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline Layout build_layout(int N, int K, int K_all, int elem) {
  Layout L;
  long long off = 0;
  L.obs = off;  // per obstacle: kObsValues (double)
  off += align16(8LL * kObsValues * K_all);
  L.sel = off;  // K obstacle indices, then the turning slots and their count (int)
  off += align16(4LL * (K + 1));
  L.slot = off;  // per slot: kSlotValues (double)
  off += align16(8LL * kSlotValues * K);
  L.trig = off;  // per (turning slot, stage of a chunk): the heading's cos, sin (double);
  L.path_b = off;  // then the repair's second path row (D), in the same bytes
  const long long trig = 16LL * K * kTrackChunk;
  const long long path_b = static_cast<long long>(elem) * 3 * (N + 1);
  off += align16(trig > path_b ? trig : path_b);
  L.tracks = off;  // [K, N, 2] (D)
  off += align16(static_cast<long long>(elem) * 2 * K * N);
  L.path = off;  // the warm states [N+1, 3] (D)
  off += align16(static_cast<long long>(elem) * 3 * (N + 1));
  L.path0 = off;  // the warm states as given, for the moved test (D)
  off += align16(static_cast<long long>(elem) * 3 * (N + 1));
  L.ctrl = off;  // the warm controls [N, 2] (D)
  off += align16(static_cast<long long>(elem) * 2 * N);
  L.bytes = off;
  return L;
}

template <typename D, bool GLOBAL>
__global__ void __launch_bounds__(kBuildWarps * kLanes, 5)
build_kernel(const BuildParams p, const BuildIn in, const BuildStrides st, const BuildOut out,
             unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / kLanes) + warp;
  if (b >= p.B) return;  // the whole warp: nothing below waits on it
  // Phase clocks start here.
  const int N = p.N, K = p.K, K_all = p.K_all, T1 = N + 1;
  const double dt = p.dt;
  const Layout L = build_layout(N, K, K_all, sizeof(D));
  unsigned char* const base = GLOBAL ? scratch + b * L.bytes : smem + warp * L.bytes;
  double* const obs = reinterpret_cast<double*>(base + L.obs);
  int* const sel = reinterpret_cast<int*>(base + L.sel);
  double* const slot = reinterpret_cast<double*>(base + L.slot);
  double* const trig = reinterpret_cast<double*>(base + L.trig);
  D* const path_b = reinterpret_cast<D*>(base + L.path_b);
  D* const C = reinterpret_cast<D*>(base + L.tracks);
  D* const W = reinterpret_cast<D*>(base + L.path);
  D* const W0 = reinterpret_cast<D*>(base + L.path0);
  D* const WU = reinterpret_cast<D*>(base + L.ctrl);
  // An obstacle's values: position, radius, heading, speed, turn rate,
  // activity (as given), and its sensor key.
  double* const o_x = obs;
  double* const o_y = obs + K_all;
  double* const o_rad = obs + 2 * K_all;
  double* const o_th = obs + 3 * K_all;
  double* const o_lin = obs + 4 * K_all;
  double* const o_ang = obs + 5 * K_all;
  double* const o_act = obs + 6 * K_all;
  double* const keys = obs + 7 * K_all;
  // A slot's values: position, heading, turn and reach per prediction
  // step, radius, mask, the rollout's radius for its speed cap (inflated;
  // -inf where masked), the track's heading: its cosine and sine where it
  // does not turn, else its row in the table of cosines and sines, and the
  // track's running sum of steps in x and y.
  double* const s_x = slot;
  double* const s_y = slot + K;
  double* const s_th = slot + 2 * K;
  double* const s_turn = slot + 3 * K;
  double* const s_reach = slot + 4 * K;
  double* const s_rad = slot + 5 * K;
  double* const s_mask = slot + 6 * K;
  double* const s_cap_r = slot + 7 * K;
  double* const s_cos = slot + 8 * K;
  double* const s_sin = slot + 9 * K;
  double* const s_row = slot + 10 * K;
  double* const s_sum = slot + 11 * K;  // 2 K: the tracks' running sums
  int* const turning = sel;  // after the ranking: the turning slots, then their count
  const D* x0 = at<D>(in.x0, b * st.x0);
  const double px0 = x0[0], py0 = x0[1];
  // The warm start's rows start on their way to shared memory (cp.async;
  // plain copies where the rows are global), awaited before (3).
  const D* wx = in.warm_x != nullptr ? at<D>(in.warm_x, b * st.warm_x) : nullptr;
  if (wx != nullptr) stage<!GLOBAL>(W, wx, T1 * 3, lane, kLanes);
  if (in.warm_u != nullptr) stage<!GLOBAL>(WU, at<D>(in.warm_u, b * st.warm_u), N * 2, lane, kLanes);

  // (0) The rows that do not depend on the obstacles.
  if (lane < 3) {
    put<D>(out.x0, b * 3)[lane] = x0[lane];
    put<D>(out.goal, b * 3)[lane] = *at<D>(in.goal, b * st.goal + lane);
    put<D>(out.xl, b * 3)[lane] = p.xl[lane];
    put<D>(out.xu, b * 3)[lane] = p.xu[lane];
  } else if (lane < 5) {
    const int j = lane - 3;
    put<D>(out.cl, b * 2)[j] = p.cl[j];
    put<D>(out.cu, b * 2)[j] = p.cu[j];
  }
  const double infl = rounded<D>(p.infl);
  if (lane == 5) *put<D>(out.infl, b) = infl;
  // Phase clocks: rows.

  // (1) The sensor's top K: one key per obstacle (its values gathered on
  // the way), then each obstacle's rank among them.
  for (int j = lane; j < K_all; j += kLanes) {
    const D* pos = at<D>(in.pos, b * st.pos + 2LL * j);
    const double x = pos[0], y = pos[1], rad = *at<D>(in.rad, b * st.rad + j);
    const double act = *at<D>(in.act, b * st.act + j);
    keys[j] = sensor_key<D>(x, y, rad, act, px0, py0);
    o_x[j] = x;
    o_y[j] = y;
    o_rad[j] = rad;
    o_th[j] = *at<D>(in.orient, b * st.orient + j);
    o_lin[j] = *at<D>(in.lin, b * st.lin + j);
    o_ang[j] = *at<D>(in.ang, b * st.ang + j);
    o_act[j] = act;
  }
  __syncwarp();
  for (int j = lane; j < K_all; j += kLanes) {
    const double key = keys[j];
    int rank = 0;
    for (int i = 0; i < K_all; ++i) {
      const double other = keys[i];
      rank += other < key || (other == key && i < j) ? 1 : 0;
    }
    if (rank < K) sel[rank] = j;
  }
  __syncwarp();
  const double radius_d = static_cast<double>(static_cast<D>(p.sensor_radius));
  for (int r = lane; r < K; r += kLanes) {
    const int j = sel[r];
    const double rad = o_rad[j];
    const double mask = o_act[j] * (keys[j] <= radius_d ? 1.0 : 0.0);
    *put<D>(out.radii, b * K + r) = rad;
    *put<D>(out.mask, b * K + r) = mask;
    s_x[r] = o_x[j];
    s_y[r] = o_y[j];
    s_th[r] = o_th[j];
    s_turn[r] = static_cast<D>(o_ang[j] * p.pred_dt);
    s_reach[r] = static_cast<D>(o_lin[j] * p.pred_dt);
    s_rad[r] = rad;
    s_mask[r] = mask;
    s_cap_r[r] = mask > 0.5 ? rad + infl : -inf();
    // A track that does not turn keeps heading + 0 * t = heading + 0 at
    // every stage: one cosine and sine serve them all.
    const double turn = s_turn[r], heading = s_th[r] + turn * 0;
    if (turn == 0.0 && isfin(heading)) sincos_rd(heading, s_sin[r], s_cos[r]);
  }
  __syncwarp();
  if (lane == 0) {  // the turning slots, in slot order
    int n = 0;
    for (int r = 0; r < K; ++r) {
      const bool turns = !(s_turn[r] == 0.0 && isfin(s_th[r] + s_turn[r] * 0));
      s_row[r] = turns ? n : -1;
      if (turns) turning[n++] = r;
    }
    turning[K] = n;
  }
  __syncwarp();
  // Phase clocks: ranking.

  // (2) The constant-velocity tracks (obstacles.py::predict_tracks): column
  // t is the position after t steps, the prefix sum of the steps.  The
  // turning slots' headings' cosines and sines, lanes over (slot, stage) ...
  // The table holds kTrackChunk stages at a time; each (slot, coordinate)
  // carries its sum from chunk to chunk in shared memory.
  const int n_turning = turning[K];
  const int chunk = n_turning > 0 ? kTrackChunk : N;
  for (int t0 = 0; t0 < N; t0 += chunk) {
    const int n_t = min(chunk, N - t0);
    for (int q = lane; q < n_turning * n_t; q += kLanes) {
      const int r = turning[q / n_t], t = t0 + q % n_t;
      double sn, cs;
      sincos_rd(s_th[r] + s_turn[r] * t, sn, cs);
      trig[2 * q] = cs;
      trig[2 * q + 1] = sn;
    }
    __syncwarp();
    // ... then one lane per (slot, coordinate) sums the steps in order.
    for (int q = lane; q < 2 * K; q += kLanes) {
      const int r = q / 2, c = q % 2;
      const double origin = c == 0 ? s_x[r] : s_y[r], reach = s_reach[r];
      const int row = static_cast<int>(s_row[r]);
      D* track = C + 2LL * r * N + c;
      double sum = t0 == 0 ? 0.0 : s_sum[q];
      if (row < 0) {
        const double step_c = c == 0 ? s_cos[r] : s_sin[r];
        for (int t = t0; t < t0 + n_t; ++t) {
          track[2 * t] = origin + sum;
          sum += reach * step_c;
        }
      } else {
        const double* tr = trig + 2LL * row * n_t + c;
        for (int t = t0; t < t0 + n_t; ++t) {
          track[2 * t] = origin + sum;
          sum += reach * tr[2 * (t - t0)];
        }
      }
      s_sum[q] = sum;
    }
    __syncwarp();  // the table is free for the next chunk
  }
  // Phase clocks: tracks.

  // (3) The warm start: the caller's rows (staged above), or the start
  // tiled and zero controls; W0 keeps the rows as given.
  copies_done();
  __syncwarp();  // every lane's copies are in
  for (int i = lane; i < T1 * 3; i += kLanes) W0[i] = wx != nullptr ? W[i] : x0[i % 3];
  if (wx == nullptr)
    for (int i = lane; i < T1 * 3; i += kLanes) W[i] = x0[i % 3];
  if (in.warm_u == nullptr)
    for (int i = lane; i < N * 2; i += kLanes) WU[i] = static_cast<D>(0.0);
  __syncwarp();  // the tracks and the warm path are in
  // Phase clocks: warm start.

  if (K > 0 && (p.repair || p.complete)) {
    // (4) The repair (solver/problem.py::repair_warm_start): each pass
    // moves every state 1..N out of the deepest intrusion, laterally to the
    // path's tangent (radially where it has none), from the previous pass's
    // path; the last pass's path ends in W.
    if (p.repair) {
      D* src = W;
      D* dst = path_b;
      if (p.passes % 2 == 1) {  // an odd number of passes starts from a copy
        for (int i = lane; i < T1 * 3; i += kLanes) path_b[i] = W[i];
        __syncwarp();
        src = path_b;
        dst = W;
      }
      for (int pass = 0; pass < p.passes; ++pass) {
        if (lane == 0) {
          dst[0] = src[0];
          dst[1] = src[1];
          dst[2] = src[2];
        }
        bool pushed = false;  // a state of this lane's moved
        for (int t = 1 + lane; t <= N; t += kLanes) {
          const double px = src[t * 3], py = src[t * 3 + 1];
          // dist < 0: not computed (the obstacle is off, or surely out of
          // reach, so its push is 0 without the square root).
          double push_b = 0.0, dx_b = 0.0, dy_b = 0.0, dist_b = -1.0, need_b = 0.0;
          for (int k = 0; k < K; ++k) {
            const D* c = C + (static_cast<long long>(k) * N + t - 1) * 2;
            const double dx = px - c[0], dy = py - c[1];
            const double d2 = dx * dx + dy * dy;
            const double need = s_rad[k] + infl + p.margin;
            double push = 0.0, dist = -1.0;
            if (s_mask[k] > 0.5 && !(need >= 0.0 && d2 > need * need * kFar)) {
              dist = sqrt(d2);
              push = maxp(need - dist, 0.0);
            }
            if (k == 0 || push > push_b) {  // the first largest push, as torch.argmax
              push_b = push;
              dx_b = dx;
              dy_b = dy;
              dist_b = dist;
              need_b = need;
            }
          }
          const double ax = src[(t - 1) * 3], ay = src[(t - 1) * 3 + 1];
          const double bx = t == N ? px : src[(t + 1) * 3];
          const double by = t == N ? py : src[(t + 1) * 3 + 1];
          if (!(push_b > 0.0) && isfin(ax + ay + bx + by + dx_b + dy_b)) {
            // No push: the state stays (the plain version adds a finite
            // direction times 0).
            dst[t * 3] = px;
            dst[t * 3 + 1] = py;
            dst[t * 3 + 2] = src[t * 3 + 2];
            continue;
          }
          pushed = true;
          if (dist_b < 0.0) dist_b = sqrt(dx_b * dx_b + dy_b * dy_b);
          dist_b = maxp(dist_b, 1e-9);
          const bool radial_ok = dist_b > 1e-6;
          const double nx = radial_ok ? dx_b / dist_b : 1.0, ny = radial_ok ? dy_b / dist_b : 0.0;
          const double tx = bx - ax, ty = by - ay;
          const double tn = sqrt(tx * tx + ty * ty);
          const bool have_t = tn > 1e-9;
          const double th_x = tx / maxp(tn, 1e-9), th_y = ty / maxp(tn, 1e-9);
          double lx = -th_y, ly = th_x;
          const double a_signed = dx_b * lx + dy_b * ly;
          if (a_signed < 0.0) {
            lx = -lx;
            ly = -ly;
          }
          const double a = fabs(a_signed);
          const double d_lat =
              -a + sqrt(maxp(a * a + need_b * need_b - dist_b * dist_b, 0.0));
          double mag = have_t ? d_lat : push_b;
          if (!(push_b > 0.0)) mag = 0.0;
          dst[t * 3] = px + (have_t ? lx : nx) * mag;
          dst[t * 3 + 1] = py + (have_t ? ly : ny) * mag;
          dst[t * 3 + 2] = src[t * 3 + 2];
        }
        __syncwarp();  // the pass is in
        D* const next = src;
        src = dst;
        dst = next;
        // A pass that moved no state leaves the path as it was: the passes
        // after it would too.
        if (warp_max(pushed ? 1.0 : 0.0) == 0.0) break;
      }
      if (src != W) {  // the last pass's path (in src) ends in W
        for (int i = lane; i < T1 * 3; i += kLanes) W[i] = src[i];
        __syncwarp();
      }
    }
    // Phase clocks: repair.

    // (5) How far the repair moved the warm start, or without the repair
    // its deepest intrusion into an active obstacle.
    double moved = -inf();
    if (p.complete) {
      bool first = true;
      if (p.repair) {
        for (int i = lane; i < T1 * 3; i += kLanes) {
          const double d = fabs(static_cast<double>(W[i]) - static_cast<double>(W0[i]));
          moved = first ? d : maxp(moved, d);
          first = false;
        }
      } else {
        for (int i = lane; i < N * K; i += kLanes) {
          const int t = i / K + 1, k = i % K;
          const D* c = C + (static_cast<long long>(k) * N + t - 1) * 2;
          const double dx = static_cast<double>(W[t * 3]) - c[0];
          const double dy = static_cast<double>(W[t * 3 + 1]) - c[1];
          const double intrusion = (s_rad[k] + infl) - sqrt(dx * dx + dy * dy);
          const double d = s_mask[k] > 0.5 ? intrusion : 0.0;
          moved = first ? d : maxp(moved, d);
          first = false;
        }
      }
      moved = warp_max(first ? -inf() : moved);
    }
    // Phase clocks: moved.

    if (p.complete && moved > p.threshold) {
      // (6) The completion rollout (solver/problem.py::complete_warm_start):
      // the real dynamics under a collision-gated tracking controller, from
      // the start, over the repaired path, in place.  The butterfly spans
      // the lanes 0..span - 1 that hold an obstacle.
      const double v_lb = maxp(rounded<D>(p.cl[0]), 0.0), w_lb = rounded<D>(p.cl[1]);
      const double v_ub = rounded<D>(p.cu[0]), w_ub = rounded<D>(p.cu[1]);
      int span = 1;
      while (span < K && span < kLanes) span <<= 1;
      double x = px0, y = py0, th = x0[2];
      if (lane < 3) W[lane] = x0[lane];
      for (int t = 0; t < N; ++t) {
        const double tqx = static_cast<double>(W[(t + 1) * 3]) - x;
        const double tqy = static_cast<double>(W[(t + 1) * 3 + 1]) - y;
        const double dist_q = sqrt(tqx * tqx + tqy * tqy + 1e-18);
        const double phi = dist_q > 1e-6 ? atan2(tqy, tqx) : th;
        const double e_free = wrap(phi - th);
        double se, ce;
        sincos_rd(e_free, se, ce);
        const double v_des = clipp(dist_q / dt * maxp(ce, 0.0), v_lb, v_ub);
        double sth, cth;
        sincos_rd(th, sth, cth);
        // Obstacle `lane`'s speed cap (the largest v whose step stays
        // out), and the heading error toward its tangent should it block.
        double cap = inf(), e_blk = 0.0;
        int k_blk = K;
        for (int k = lane; k < K; k += kLanes) {  // one pass: K <= 32 lanes
          const D* c = C + (static_cast<long long>(k) * N + t) * 2;
          const double rx = x - c[0], ry = y - c[1];
          const double R = s_cap_r[k];
          const double qa = dt * dt;
          const double qb = 2.0 * dt * (rx * cth + ry * sth);
          const double qc = (rx * rx + ry * ry) - R * R;
          const double disc = qb * qb - 4.0 * qa * qc;
          const double sq = sqrt(maxp(disc, 0.0));
          const double v1 = (-qb - sq) / (2.0 * qa), v2 = (-qb + sq) / (2.0 * qa);
          double ck = disc > 0.0 && v2 > 0.0 ? maxp(v1, 0.0) : inf();
          if (qc < 0.0) ck = qb > 0.0 ? inf() : 0.0;
          if (!isfin(R)) ck = inf();
          if (k_blk == K || ck < cap) {
            const double bn = sqrt(rx * rx + ry * ry + 1e-18);
            double gx = -ry / bn, gy = rx / bn;
            const double score = (gx * tqx + gy * tqy) + 1e-6 * (gx * -tqy + gy * tqx);
            if (score < 0.0) {
              gx = -gx;
              gy = -gy;
            }
            cap = ck;
            k_blk = k;
            e_blk = wrap(atan2(gy, gx) - th);
          }
        }
        for (int o = span / 2; o > 0; o >>= 1) {  // (cap, slot) minimum, ties to the lower slot
          const double oc = __shfl_xor_sync(kFull, cap, o);
          const int ok = __shfl_xor_sync(kFull, k_blk, o);
          const double oe = __shfl_xor_sync(kFull, e_blk, o);
          if (oc < cap || (oc == cap && ok < k_blk)) {
            cap = oc;
            k_blk = ok;
            e_blk = oe;
          }
        }
        cap = __shfl_sync(kFull, cap, 0);
        e_blk = __shfl_sync(kFull, e_blk, 0);
        const double om = clipp((cap < v_des ? e_blk : e_free) / dt, w_lb, w_ub);
        const double v = maxp(clipp(minp(v_des, cap), v_lb, minp(v_ub, cap)), 0.0);
        // The next state, rounded as the plain rollout holds it.
        x = static_cast<D>(x + v * cth * dt);
        y = static_cast<D>(y + v * sth * dt);
        th = static_cast<D>(th + om * dt);
        __syncwarp();  // every lane has read the path's row t + 1
        if (lane == 0) {
          WU[t * 2] = v;
          WU[t * 2 + 1] = om;
          W[(t + 1) * 3] = x;
          W[(t + 1) * 3 + 1] = y;
          W[(t + 1) * 3 + 2] = th;
        }
      }
    }
    // Phase clocks: rollout.
  }
  __syncwarp();  // every row is in

  // (7) The Problem's rows out, consecutive lanes on consecutive values.
  store_span(put<D>(out.centers, b * K * N * 2), C, K * N * 2, lane);
  store_span(put<D>(out.warm_x, b * T1 * 3), W, T1 * 3, lane);
  store_span(put<D>(out.warm_u, b * N * 2), WU, N * 2, lane);
  // Phase clocks: store.
  // Phase clocks end here.
}

// The launch's scenarios per block and shared bytes per block (0 with the
// global scratch), and whether the rows take the global scratch.
struct Launch {
  int warps;
  long long smem;
  bool global;
  long long scratch;  // bytes of global scratch the launch needs
};
inline Launch build_launch(const BuildParams& p, int elem) {
  const long long bytes = build_layout(p.N, p.K, p.K_all, elem).bytes;
  Launch l{kBuildWarps, 0, false, 0};
  while (l.warps > 1 && l.warps * bytes > kSmemOptin) l.warps /= 2;
  if (bytes > kSmemOptin) {
    l.global = true;
    l.scratch = bytes * p.B;
  } else {
    l.smem = l.warps * bytes;
  }
  return l;
}

template <typename T, bool GLOBAL>
cudaError_t launch_build(const BuildParams& p, const BuildIn& in, const BuildStrides& st,
                         const BuildOut& out, const Launch& l, void* scratch,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(build_kernel<T, GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  const int blocks = (p.B + l.warps - 1) / l.warps;
  build_kernel<T, GLOBAL><<<blocks, l.warps * kLanes, l.smem, stream>>>(
      p, in, st, out, static_cast<unsigned char*>(scratch));
  return cudaGetLastError();
}

template <typename T>
int build(const BuildParams* params, const BuildIn* in, const BuildStrides* st,
          const BuildOut* out, void* scratch, void* stream) {
  const BuildParams p = *params;
  if (p.B <= 0) return 0;
  const Launch l = build_launch(p, sizeof(T));
  if (l.global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = l.global ? launch_build<T, true>(p, *in, *st, *out, l, scratch, s)
                                   : launch_build<T, false>(p, *in, *st, *out, l, scratch, s);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller reports it
  return static_cast<int>(err);
}

}  // namespace

// Launchers: each returns the launch's cudaError_t (0 on success).  The
// scratch holds kissmpc_build_scratch_bytes bytes where one scenario's
// rows do not fit in the card's shared memory, else may be null.
extern "C" int kissmpc_build_f32(const BuildParams* p, const BuildIn* in, const BuildStrides* st,
                                 const BuildOut* out, void* scratch, void* stream) {
  return build<float>(p, in, st, out, scratch, stream);
}

extern "C" int kissmpc_build_f64(const BuildParams* p, const BuildIn* in, const BuildStrides* st,
                                 const BuildOut* out, void* scratch, void* stream) {
  return build<double>(p, in, st, out, scratch, stream);
}

// Bytes of global scratch a launch of ``p`` in elements of ``elem_bytes``
// needs: 0 where a scenario's rows fit in shared memory.  Host only.
extern "C" long long kissmpc_build_scratch_bytes(const BuildParams* p, int elem_bytes) {
  return build_launch(*p, elem_bytes).scratch;
}

// The launch's shape on the current card: scenarios per block, dynamic
// shared bytes per block, whether the rows are global, resident blocks per
// SM, registers and local (stack and spill) bytes per thread, into out[6].
extern "C" int kissmpc_build_occupancy(const BuildParams* params, int elem_bytes, int* out) {
  const BuildParams p = *params;
  const Launch l = build_launch(p, elem_bytes);
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err;
  if (elem_bytes == 4) {
    void (*fn)(BuildParams, BuildIn, BuildStrides, BuildOut, unsigned char*) =
        l.global ? build_kernel<float, true> : build_kernel<float, false>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, l.warps * kLanes, l.smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  } else {
    void (*fn)(BuildParams, BuildIn, BuildStrides, BuildOut, unsigned char*) =
        l.global ? build_kernel<double, true> : build_kernel<double, false>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, l.warps * kLanes, l.smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  out[0] = l.warps;
  out[1] = static_cast<int>(l.smem);
  out[2] = l.global ? 1 : 0;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
