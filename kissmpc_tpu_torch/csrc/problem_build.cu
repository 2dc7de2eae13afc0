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
// build_kernel: one warp per scenario, kBuildWarps scenarios per block.
//  (0) The rows that do not depend on the obstacles: the start, the goal,
//      the control and state bounds and the inflation (the launch's
//      numbers), each rounded to the data type as the plain version's
//      fills round them.
//  (1) The sensor's top K: lane j ranks obstacle j by (distance, slot)
//      among all K_all, the order of `lax.top_k` (ties to the lower slot,
//      inactive and non-finite distances last); the obstacle of rank r < K
//      fills slot r: its radius, its mask (active and within the sensor
//      radius) and its constant-velocity track over the N stages.
//  (2) The warm start: the caller's (any batch stride), or the start tiled.
//  (3) The repair's passes, lanes over stages, each pass reading the
//      previous one's path: the warm path in the output and a global
//      scratch row take turns.
//  (4) How far the repair moved the path (or, without repair, the deepest
//      intrusion), a butterfly max; where it exceeds the threshold, (5) the
//      completion rollout in place over the repaired path, stage by stage:
//      every lane carries the same state, lanes take the obstacles for the
//      speed caps, and a butterfly (cap, slot) minimum picks the blocking
//      one (ties to the lower slot, as torch.argmin).
//
// What bounds it: by bytes, the outputs (the tracks, K * N * 2 values per
// scenario, and the warm start); in practice the rollout's chain of N
// dependent steps of a few transcendentals each (atan2, sin, cos, sqrt), on
// one warp per scenario.  A simple kernel first: the ranking recomputes
// every distance (K_all^2 per scenario), and a lane writes a track alone.
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

constexpr int kBuildWarps = 4;  // scenarios per block

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

// Obstacle j's sensor key for the point (px, py): its surface distance in
// D's arithmetic as obstacles.py::distance_to_point computes it on the
// CPU (the norm's squares summed in D, no FMA), +inf where it is inactive
// or the distance is not finite.  The ranking's ties are the plain
// version's: the sampled scenarios push circles to one clearance from
// the start, so exact ties are common.
template <typename D>
__device__ __forceinline__ double sensor_key(const BuildIn& in, const BuildStrides& st, int b,
                                             int j, double px, double py) {
  const D* pos = at<D>(in.pos, b * st.pos + 2LL * j);
  const double dx = add_d<D>(pos[0], -px), dy = add_d<D>(pos[1], -py);
  const double nrm = static_cast<D>(sqrt(add_d<D>(mul_d<D>(dx, dx), mul_d<D>(dy, dy))));
  const double key = add_d<D>(nrm, -static_cast<double>(*at<D>(in.rad, b * st.rad + j)));
  const bool on = static_cast<double>(*at<D>(in.act, b * st.act + j)) > 0.5;
  return on && isfin(key) ? key : inf();
}

template <typename D>
__global__ void __launch_bounds__(kBuildWarps * kLanes)
build_kernel(const BuildParams p, const BuildIn in, const BuildStrides st, const BuildOut out,
             D* __restrict__ scratch) {
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kBuildWarps + threadIdx.x / kLanes;
  if (b >= p.B) return;  // the whole warp: nothing below waits on it
  const int N = p.N, K = p.K, T1 = N + 1;
  const double dt = p.dt;
  const D* x0 = at<D>(in.x0, b * st.x0);
  const double px0 = x0[0], py0 = x0[1];

  // (0) The rows that do not depend on the obstacles.
  if (lane < 3) {
    put<D>(out.x0, b * 3LL)[lane] = x0[lane];
    put<D>(out.goal, b * 3LL)[lane] = *at<D>(in.goal, b * st.goal + lane);
    put<D>(out.xl, b * 3LL)[lane] = p.xl[lane];
    put<D>(out.xu, b * 3LL)[lane] = p.xu[lane];
  } else if (lane < 5) {
    const int j = lane - 3;
    put<D>(out.cl, b * 2LL)[j] = p.cl[j];
    put<D>(out.cu, b * 2LL)[j] = p.cu[j];
  }
  const double infl = rounded<D>(p.infl);
  if (lane == 5) *put<D>(out.infl, b) = infl;

  // (1) The sensor's top K and their tracks.
  for (int j = lane; j < p.K_all; j += kLanes) {
    const double key = sensor_key<D>(in, st, b, j, px0, py0);
    int rank = 0;
    for (int i = 0; i < p.K_all; ++i) {
      const double other = i == j ? key : sensor_key<D>(in, st, b, i, px0, py0);
      rank += other < key || (other == key && i < j) ? 1 : 0;
    }
    if (rank >= K) continue;
    const long long slot = static_cast<long long>(b) * K + rank;
    const double act = *at<D>(in.act, b * st.act + j);
    *put<D>(out.radii, slot) = *at<D>(in.rad, b * st.rad + j);
    *put<D>(out.mask, slot) = act * (key <= static_cast<double>(static_cast<D>(p.sensor_radius))
                                         ? 1.0 : 0.0);
    // Constant-velocity track (obstacles.py::predict_tracks): column t is
    // the position after t steps, the prefix sum of the steps.
    const D* pos = at<D>(in.pos, b * st.pos + 2LL * j);
    const double orient = *at<D>(in.orient, b * st.orient + j);
    const double turn = static_cast<D>(static_cast<double>(*at<D>(in.ang, b * st.ang + j)) *
                                       p.pred_dt);
    const double reach = static_cast<D>(static_cast<double>(*at<D>(in.lin, b * st.lin + j)) *
                                        p.pred_dt);
    D* track = put<D>(out.centers, slot * N * 2);
    double sx = 0.0, sy = 0.0;
    for (int t = 0; t < N; ++t) {
      track[2 * t] = static_cast<double>(pos[0]) + sx;
      track[2 * t + 1] = static_cast<double>(pos[1]) + sy;
      double sn, cs;
      sincos_rd(orient + turn * t, sn, cs);
      sx += reach * cs;
      sy += reach * sn;
    }
  }

  // (2) The warm start.
  D* W = put<D>(out.warm_x, static_cast<long long>(b) * T1 * 3);
  D* WU = put<D>(out.warm_u, static_cast<long long>(b) * N * 2);
  const D* wx = in.warm_x != nullptr ? at<D>(in.warm_x, b * st.warm_x) : nullptr;
  for (int i = lane; i < T1 * 3; i += kLanes) W[i] = wx != nullptr ? wx[i] : x0[i % 3];
  for (int i = lane; i < N * 2; i += kLanes)
    WU[i] = in.warm_u != nullptr ? *at<D>(in.warm_u, b * st.warm_u + i) : static_cast<D>(0.0);
  if (K == 0 || !(p.repair || p.complete)) return;
  __syncwarp();  // the tracks, masks and warm path are in

  const D* C = at<D>(out.centers, static_cast<long long>(b) * K * N * 2);
  const D* R = at<D>(out.radii, static_cast<long long>(b) * K);
  const D* M = at<D>(out.mask, static_cast<long long>(b) * K);

  // (3) The repair (solver/problem.py::repair_warm_start): each pass moves
  // every state 1..N out of the deepest intrusion, laterally to the path's
  // tangent (radially where it has none), from the previous pass's path.
  if (p.repair) {
    D* S = scratch + static_cast<long long>(b) * T1 * 3;
    for (int pass = 0; pass < p.passes; ++pass) {
      const D* src = pass % 2 == 0 ? W : S;
      D* dst = pass % 2 == 0 ? S : W;
      if (lane == 0) {
        dst[0] = src[0];
        dst[1] = src[1];
      }
      for (int t = 1 + lane; t <= N; t += kLanes) {
        const double px = src[t * 3], py = src[t * 3 + 1];
        double push_b = 0.0, dx_b = 0.0, dy_b = 0.0, dist_b = 0.0, need_b = 0.0;
        for (int k = 0; k < K; ++k) {
          const D* c = C + (static_cast<long long>(k) * N + t - 1) * 2;
          const double dx = px - c[0], dy = py - c[1];
          const double dist = sqrt(dx * dx + dy * dy);
          const double need = static_cast<double>(R[k]) + infl + p.margin;
          const double push = static_cast<double>(M[k]) > 0.5 ? maxp(need - dist, 0.0) : 0.0;
          if (k == 0 || push > push_b) {  // the first largest push, as torch.argmax
            push_b = push;
            dx_b = dx;
            dy_b = dy;
            dist_b = dist;
            need_b = need;
          }
        }
        dist_b = maxp(dist_b, 1e-9);
        const bool radial_ok = dist_b > 1e-6;
        const double nx = radial_ok ? dx_b / dist_b : 1.0, ny = radial_ok ? dy_b / dist_b : 0.0;
        const double ax = t == 1 ? src[0] : src[(t - 1) * 3];
        const double ay = t == 1 ? src[1] : src[(t - 1) * 3 + 1];
        const double bx = t == N ? px : src[(t + 1) * 3];
        const double by = t == N ? py : src[(t + 1) * 3 + 1];
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
      }
      __syncwarp();  // the pass is in
    }
    if (p.passes % 2 == 1) {  // the last pass wrote the scratch row
      for (int t = 1 + lane; t <= N; t += kLanes) {
        W[t * 3] = S[t * 3];
        W[t * 3 + 1] = S[t * 3 + 1];
      }
      __syncwarp();
    }
  }
  if (!p.complete) return;

  // (4) How far the repair moved the warm start, or without the repair its
  // deepest intrusion into an active obstacle.
  double moved = 0.0;
  bool first = true;
  if (p.repair) {
    for (int i = lane; i < T1 * 3; i += kLanes) {
      const double w0 = wx != nullptr ? static_cast<double>(wx[i]) : x0[i % 3];
      const double d = fabs(static_cast<double>(W[i]) - w0);
      moved = first ? d : maxp(moved, d);
      first = false;
    }
  } else {
    for (int i = lane; i < N * K; i += kLanes) {
      const int t = i / K + 1, k = i % K;
      const D* c = C + (static_cast<long long>(k) * N + t - 1) * 2;
      const double dx = static_cast<double>(W[t * 3]) - c[0];
      const double dy = static_cast<double>(W[t * 3 + 1]) - c[1];
      const double intrusion = (static_cast<double>(R[k]) + infl) - sqrt(dx * dx + dy * dy);
      const double d = static_cast<double>(M[k]) > 0.5 ? intrusion : 0.0;
      moved = first ? d : maxp(moved, d);
      first = false;
    }
  }
  moved = warp_max(first ? -inf() : moved);
  if (!(moved > p.threshold)) return;

  // (5) The completion rollout (solver/problem.py::complete_warm_start):
  // the real dynamics under a collision-gated tracking controller, from the
  // start, over the repaired path, in place.
  const double v_lb = maxp(rounded<D>(p.cl[0]), 0.0), w_lb = rounded<D>(p.cl[1]);
  const double v_ub = rounded<D>(p.cu[0]), w_ub = rounded<D>(p.cu[1]);
  double x = px0, y = py0, th = x0[2];
  if (lane < 3) W[lane] = x0[lane];
  for (int t = 0; t < N; ++t) {
    const double tqx = static_cast<double>(W[(t + 1) * 3]) - x;
    const double tqy = static_cast<double>(W[(t + 1) * 3 + 1]) - y;
    const double dist_q = sqrt(tqx * tqx + tqy * tqy + 1e-18);
    const double phi = dist_q > 1e-6 ? atan2(tqy, tqx) : th;
    double se, ce;
    sincos_rd(wrap(phi - th), se, ce);
    const double v_des = clipp(dist_q / dt * maxp(ce, 0.0), v_lb, v_ub);
    double sth, cth;
    sincos_rd(th, sth, cth);
    // The speed cap of each obstacle: the largest v whose step stays out.
    double cap_min = inf();
    int k_blk = K;
    for (int k = lane; k < K; k += kLanes) {
      const D* c = C + (static_cast<long long>(k) * N + t) * 2;
      const double rx = x - c[0], ry = y - c[1];
      const double Rk = static_cast<double>(M[k]) > 0.5 ? static_cast<double>(R[k]) + infl : -inf();
      const double qa = dt * dt;
      const double qb = 2.0 * dt * (rx * cth + ry * sth);
      const double qc = (rx * rx + ry * ry) - Rk * Rk;
      const double disc = qb * qb - 4.0 * qa * qc;
      const double sq = sqrt(maxp(disc, 0.0));
      const double v1 = (-qb - sq) / (2.0 * qa), v2 = (-qb + sq) / (2.0 * qa);
      double cap = disc > 0.0 && v2 > 0.0 ? maxp(v1, 0.0) : inf();
      if (qc < 0.0) cap = qb > 0.0 ? inf() : 0.0;
      if (!isfin(Rk)) cap = inf();
      if (k_blk == K || cap < cap_min) {
        cap_min = cap;
        k_blk = k;
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {  // (cap, slot) minimum, ties to the lower slot
      const double oc = __shfl_xor_sync(kFull, cap_min, o);
      const int ok = __shfl_xor_sync(kFull, k_blk, o);
      if (oc < cap_min || (oc == cap_min && ok < k_blk)) {
        cap_min = oc;
        k_blk = ok;
      }
    }
    const D* cb = C + (static_cast<long long>(k_blk) * N + t) * 2;
    const double bx = x - cb[0], by = y - cb[1];
    const double bn = sqrt(bx * bx + by * by + 1e-18);
    double gx = -by / bn, gy = bx / bn;
    const double score = (gx * tqx + gy * tqy) + 1e-6 * (gx * -tqy + gy * tqx);
    if (score < 0.0) {
      gx = -gx;
      gy = -gy;
    }
    const double phi_eff = cap_min < v_des ? atan2(gy, gx) : phi;
    const double om = clipp(wrap(phi_eff - th) / dt, w_lb, w_ub);
    const double v = maxp(clipp(minp(v_des, cap_min), v_lb, minp(v_ub, cap_min)), 0.0);
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

template <typename T>
int build(const BuildParams* params, const BuildIn* in, const BuildStrides* st,
          const BuildOut* out, void* scratch, void* stream) {
  const BuildParams p = *params;
  if (p.B <= 0) return 0;
  if (p.repair && p.K > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.B + kBuildWarps - 1) / kBuildWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  build_kernel<T><<<blocks, kBuildWarps * kLanes, 0, s>>>(p, *in, *st, *out,
                                                           static_cast<T*>(scratch));
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Launchers: each returns the launch's cudaError_t (0 on success).  The
// scratch holds [B, N+1, 3] values of the data type where the repair runs
// (K > 0), else may be null.
extern "C" int kissmpc_build_f32(const BuildParams* p, const BuildIn* in, const BuildStrides* st,
                                 const BuildOut* out, void* scratch, void* stream) {
  return build<float>(p, in, st, out, scratch, stream);
}

extern "C" int kissmpc_build_f64(const BuildParams* p, const BuildIn* in, const BuildStrides* st,
                                 const BuildOut* out, void* scratch, void* stream) {
  return build<double>(p, in, st, out, scratch, stream);
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
