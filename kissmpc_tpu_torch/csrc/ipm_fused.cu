// The whole fixed-iteration primal-dual IPM of the unicycle MPC, one launch
// per batched solve, for Hopper (sm_90a).
//
// Replaces: kissmpc_tpu/ops/pallas/ipm_fused.py::ipm_fused_kernel, the TPU
// kernel behind the "fused" solve backend.  Contract: ops/ipm_fused.py's
// plain version (`_plain`), which this kernel follows step by step.  Per
// scenario: slack/dual init from the warm start; per iteration the adaptive
// mu, cost derivatives and condensation of every inequality family, the
// unicycle linearisation, the specialised Riccati sweep (diag + one (x, y)
// off-diagonal stage Hessian, symmetric P) and rollout, slack/dual steps
// with fraction to the boundary, the l1 penalty rho, the merit line search
// with the finite-merit fallback, the updates with the dual clamp, and the
// reg and adaptive-sigma schedules; last, the exact KKT diagnostics through
// an adjoint sweep.
//
// Elastic obstacles (template switch ELASTIC, instantiated twice and picked
// by the launcher, so the hard path is compiled without the branch): each
// obstacle constraint is c + e - s = 0, e >= 0, with the penalty rho_e * e.
// e starts at max(s - c, mu / rho_e), the condensation takes the eliminated
// stiffness sig_eff = (1/sig_s + 1/sig_e)^-1 with sig_e = mu / e^2, the
// eliminated step (ds, de, dnu) is computed once per iteration, e joins the
// fraction to the boundary, and the merit gains log e, rho_e * e and
// |c + e - s|.
//
// What bounds it: operations.  Its device-memory input and output is about
// 2 KB per scenario (27 problem rows, the warm start, the tracks, the
// solution and 6 diagnostics), while each iteration does tens of thousands
// of operations per scenario: the condensation, two sweeps, and one merit
// pass per line-search candidate, each with its sin, cos, sqrt and log.
//
// Design.  A scenario's work is shared by W warps, its width: 1 at large
// batches, kWide = 4 where one warp per scenario would leave most of the
// card's warp slots empty, as at the refine stages.  The launcher picks W
// from the batch, the problem's shape and the card alone (prepare): the
// wide W needs its one-scenario block to fit the card's opt-in shared
// memory and the card's resident blocks of it
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count) to
// hold the whole batch at once.  W is a template parameter beside
// ELASTIC; a solve stage is one launch at either width.
//
// At W = 1 a block holds kWarps scenarios, one warp each (fewer only at
// long horizons, see below).  At W > 1 a block is one scenario.  The
// scenario's whole iterate lives in dynamic shared memory for the whole
// solve (the TPU kernel kept it in VMEM): problem rows and tracks
// (non-affine tracks too), the trajectory, slacks and duals of every
// family, elastic e, the Newton direction, and one region that holds the
// per-time stage rows and the gains during the sweeps (the TPU kernel's
// stage_ref), the obstacle step from the fraction to the boundary to the
// update, and the Lagrangian gradient rows of the diagnostics.  A wide
// block adds a scratch: the slots through which warp 0 hands its sums to
// the other warps, and one region for, in turn, the condensation's
// obstacle terms and a merit pass's factors.  Device memory is read once,
// at the start, and written once, at the end; the layout is sized at run
// time from (N, K, elastic, affine tracks), ~11 KB per scenario free,
// ~15 KB with K = 8 at N = 50 (~20 KB with the wide scratch).  At W = 1
// the launcher takes kWarps scenarios per block where they fit in the
// card's opt-in shared memory per block (227 KB on sm_90), else 2, else 1
// (warps_for); the kernel reads its count from blockDim.  At one warp the
// longest horizon is N = 1036 at K = 0, and at K = 8 805 (affine tracks)
// or 659, 725 or 604 with elastic obstacles (kissmpc_ipm_fused_max_horizon);
// the wrapper refuses a longer one before any work.  Inputs and outputs
// are scenario-major ([B, rows]): a scenario's threads read and write its
// contiguous rows.  The stage rows and the stored step each beat their
// alternative on the card (condensing inside the sweep on lane 0;
// recomputing the step where it is read): see scripts/fused_design_sweep.py
// and its readings in PERF.md.
//
// Within an iteration the scenario's W x 32 threads share the work: the
// condensation computes every time step's stage rows in parallel (thread
// t, its sum over the obstacles in order k); the backward Riccati sweep
// and the forward rollout run on thread 0 from those rows while the others
// wait at the barrier (__syncwarp at W = 1, __syncthreads at W > 1); the
// fraction to the boundary, each line-search candidate, the updates and
// the diagnostics run strided over the elements; the diagnostics' adjoint
// sweep runs on thread 0.  Sums keep the one-warp order at every width, so
// a wide instance returns the same bits as W = 1: lane l of warp 0 adds
// elements l, l + 32, l + 64, ... in turn, then a butterfly of shuffles.
// At W > 1 the costly terms are computed strided into the scratch first
// (the condensation's obstacle terms, every (t, k) by one thread; a merit
// pass's logs, defects and obstacle consistencies), and the sums then add
// them in that order; the sums whose terms are a product or two of rows in
// shared memory (the mean complementarity, the diagnostics) run on warp 0
// alone.  Passes with no sum (the init, the fraction to the boundary, the
// updates) take the box elements (t, f) by one flat index at W > 1.  Max
// and min take any order (NaN-propagating).  Every scalar that steers
// control flow (mu, rho, alpha, found, keep, reg, sigma) is computed on
// every thread from the same reduced values, so no thread diverges around
// a shuffle or a barrier.  At W = 1 a warp past the batch leaves at once
// and nothing syncs the block; at W > 1 the grid is the batch.
//
// The iteration count is read from device memory (`iters`), and the
// per-scenario centering sigma is an input row, so one build serves every
// refine stage.  Compiled without fast math: the safety logic needs IEEE
// sqrtf, logf, sinf, cosf and division (the non-finite merit guard, the
// freeze of a scenario whose deepest trial was non-finite,
// sqrt(d^2 + 1e-16), log(max(s, 1e-30)), the fraction-to-boundary
// denominator min(dv, -1e-30)).  Max, min and clip propagate NaN, as jnp's
// and torch's do, in the shuffle trees too.
//
// TPU artefacts left behind: sublane packing and its tiling copies, the
// Mosaic scatter-add workaround, the VMEM placement shim, the 128-lane tile
// and the batch padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <tuple>

// Mirror of ops/ipm_fused.py::_Params: 4-byte fields only.  Outside the
// anonymous namespace: the exported launcher takes it.
struct FusedParams {
  int B, N, K, ls_iters;
  int exclude_terminal, reverse_squared, curvature, affine, adaptive_sigma;
  int elastic;
  float dt, tau, reg, mu_init, mu_floor, mu_sigma_max, ls_backtrack;
  float alpha_min_factor, merit_penalty, kkt_tol, comp_tol;
  float w0, w1, w2, w_neg, w_pos, w_ang, rho_e;
};

// ptxas for sm_90a: W = 1 115 registers in both branches and
// sincosf's 32-byte stack frame for huge angles; W = 4 128 registers, no
// stack; no instance spills.

namespace {

// Scenarios (warps) per block at W = 1, chosen against 1, 2 and 8 by
// scripts/fused_design_sweep.py (tied with 1 and 2 at N = 50, 8 slower);
// the most a block takes: the launcher halves it where a block does not
// fit.
constexpr int kWarps = 4;
// The wide instance's W (warps per scenario).
constexpr int kWide = 4;
// Dynamic shared memory a block may take on sm_90
// (cudaDevAttrMaxSharedMemoryPerBlockOptin there), for the host-only
// queries; a launch reads the card's own.
constexpr size_t kSmemOptin = 227 * 1024;
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScalRows = 27;
constexpr float kFloor = 1e-10f;     // slack floor in sigma = nu / s
constexpr float kSigmaMax = 1e12f;   // sigma safeguard
constexpr float kKappa = 1e10f;      // dual clamp around mu / s
constexpr float kEps = 1.1920929e-07f;
// The wide instances' slots: warp 0's sums of the mean complementarity
// (4), lam_max (1), a merit pass's sums (4), then each warp's minima and
// maximum of the fraction to the boundary (3 a warp) and maxima of the
// diagnostics (3 a warp).
constexpr int kSlotRed = 0, kSlotLam = 4, kSlotMerit = 5, kSlotStep = 9;
constexpr int kSlotDiag = kSlotStep + 3 * kWide, kSlots = kSlotDiag + 3 * kWide;

// Float offsets of one scenario's shared-memory rows.
struct Layout {
  int scal, obi, tx, ty;          // problem rows, obstacle info, tracks
  int x, y, th, v, w;             // trajectory (the warm start's order)
  int sc, nuc, sx, nux;           // box slacks / duals: vl, vu, wl, wu; xl0..2, xu0..2
  int sob, nuob, eob;             // obstacle slacks, duals, elastic e (k-major)
  int dx, du;                     // Newton direction
  int kk, st;                     // shared region: gains (8N), then stage rows
  int total;                      // one scenario's floats at W = 1
  // W > 1 only, after the iterate: the slots, then one region that holds in
  // turn the condensation's obstacle terms and a merit pass's factors
  // (defects' residuals, box logs, obstacle logs of s and e, and obstacle
  // consistencies).
  int slot, cn, me, mlb, ml1, ml2, mc;
  int wide;                       // one scenario's floats at W > 1
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout layout(int N, int K, bool elastic, bool affine) {
  const int T1 = N + 1, KN = K * N;
  const int track = K == 0 ? 0 : (affine ? 2 * K : KN);
  Layout L;
  L.scal = 0;
  L.obi = L.scal + kScalRows;
  L.tx = L.obi + (K > 0 ? 2 * K + 1 : 0);
  L.ty = L.tx + track;
  L.x = L.ty + track;
  L.y = L.x + T1;
  L.th = L.y + T1;
  L.v = L.th + T1;
  L.w = L.v + N;
  L.sc = L.w + N;
  L.nuc = L.sc + 4 * N;
  L.sx = L.nuc + 4 * N;
  L.nux = L.sx + 6 * T1;
  L.sob = L.nux + 6 * T1;
  L.nuob = L.sob + KN;
  L.eob = L.nuob + KN;
  L.dx = L.eob + (elastic ? KN : 0);
  L.du = L.dx + 3 * T1;
  L.kk = L.du + 2 * N;
  L.st = L.kk + 8 * N;
  // The shared region holds, in turn: gains and stage rows (dyn 7N, ctrl
  // 4N, state 7(N+1)) from the condensation to the rollout; the obstacle
  // step (ds, and de, dnu when elastic) from the fraction to the boundary
  // to the update; the diagnostics' gradient and linearisation rows.
  const int sweep = 8 * N + 11 * N + 7 * T1;
  const int step = (elastic ? 3 : 1) * KN;
  const int diag = 3 * T1 + 6 * N;
  L.total = L.kk + imax(sweep, imax(step, diag));
  L.slot = L.total;
  L.cn = L.slot + kSlots;
  L.me = L.cn;
  L.mlb = L.me + T1;
  L.ml1 = L.mlb + 10 * T1;
  L.ml2 = L.ml1 + KN;
  L.mc = L.ml2 + (elastic ? KN : 0);
  L.wide = L.cn + imax(6 * KN, L.mc + KN - L.me);
  return L;
}

__host__ __device__ inline size_t smem_bytes(int N, int K, bool elastic, bool affine,
                                             int warps) {
  return static_cast<size_t>(layout(N, K, elastic, affine).total) * sizeof(float) * warps;
}

// Dynamic shared memory of a block at W > 1 (one scenario, any width).
__host__ __device__ inline size_t wide_bytes(int N, int K, bool elastic, bool affine) {
  return static_cast<size_t>(layout(N, K, elastic, affine).wide) * sizeof(float);
}

// Warps per block at W = 1 for a block of at most ``optin`` bytes: kWarps,
// or the largest of kWarps / 2, ..., 1 that fits; 0 where not even one does.
inline int warps_for(int N, int K, bool elastic, bool affine, size_t optin) {
  for (int w = kWarps; w >= 1; w /= 2)
    if (smem_bytes(N, K, elastic, affine, w) <= optin) return w;
  return 0;
}

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}

// Butterfly sum: every lane ends with the same bits (each step adds the
// same two operands, and addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
// NaN-propagating max and min over the warp, lane 0's result to every lane.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = minp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

struct Geo {  // obstacle constraint value and unit normal at a point
  float c, nx, ny;
};

struct Dyn {  // unicycle linearisation and defect of step t
  float a02, a12, b00, b10, d0, d1, d2;
};

struct Merit {  // merit components at a trial point
  float obj, eq, log, cons;
};

struct ElCoef {  // condensed quantities of an elastic constraint c + e - s = 0
  float T, r_e, r_c, sig_s, sig_e, sig_eff;
};

struct ObStep {  // an obstacle element's Newton step (de: elastic only)
  float ds, de, dnu;
};

struct StateQ {  // condensed stage of state t: Hessian diag, (x, y), gradient
  float Q[3], Qxy, q[3];
};

struct CtrlQ {  // condensed stage of control t
  float Qv, Qw, qv, qw;
};

struct Red {  // complementarity sum, mask count, largest dual, box consistency
  float tot, cnt, nu_max, cons_box;
};

struct ObCond {  // an obstacle element's terms in its stage: normal, gradient, Hessian
  float nx, ny, gc, h00, h01, h11;
};

struct ObMerit {  // an obstacle element's merit factors: logs of s and e, e, consistency
  float log_s, log_e, te, cons;
};

template <bool ELASTIC, int WIDTH>
__global__ void __launch_bounds__((WIDTH > 1 ? WIDTH : kWarps) * kLanes) ipm_fused_kernel(
    const int* __restrict__ iters_in, const float* __restrict__ scal_in,
    const float* __restrict__ warm_in, const float* __restrict__ tx_in,
    const float* __restrict__ ty_in, const float* __restrict__ obinfo_in,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ th_out, float* __restrict__ v_out,
    float* __restrict__ w_out, float* __restrict__ diag_out, const FusedParams p) {
  extern __shared__ float smem[];
  constexpr bool kWide = WIDTH > 1;
  constexpr int NT = WIDTH * kLanes;  // threads per scenario
  const int lane = static_cast<int>(threadIdx.x) % kLanes;
  const int warp = static_cast<int>(threadIdx.x) / kLanes;
  // The scenario's thread: its lane at W = 1, its place in the block at W > 1.
  const int tid = kWide ? static_cast<int>(threadIdx.x) : lane;
  const int warps = static_cast<int>(blockDim.x) / kLanes;
  const int b = static_cast<int>(blockIdx.x) * (kWide ? 1 : warps) + (kWide ? 0 : warp);
  if (b >= p.B) return;  // W = 1: the whole warp leaves; nothing below syncs the block
  const int N = p.N, K = p.K, T1 = N + 1, KN = K * N;
  const bool affine = p.affine != 0;
  const float dt = p.dt;
  const Layout L = layout(N, K, ELASTIC, affine);
  float* const sm = smem + (kWide ? 0 : static_cast<size_t>(warp) * L.total);
  float* const SCAL = sm + L.scal;
  float* const OBI = sm + L.obi;
  float* const TX = sm + L.tx;
  float* const TY = sm + L.ty;
  float* const X = sm + L.x;
  float* const Y = sm + L.y;
  float* const TH = sm + L.th;
  float* const V = sm + L.v;
  float* const W = sm + L.w;
  float* const SC = sm + L.sc;
  float* const NUC = sm + L.nuc;
  float* const SX = sm + L.sx;
  float* const NUX = sm + L.nux;
  float* const SOB = sm + L.sob;
  float* const NUOB = sm + L.nuob;
  float* const EOB = sm + L.eob;
  float* const DX = sm + L.dx;
  float* const DU = sm + L.du;
  float* const KK = sm + L.kk;   // gains K00..K12, k0, k1 (8 rows of N)
  float* const ST = sm + L.st;   // stage rows
  float* const STEP = sm + L.kk; // obstacle step rows ds, de, dnu (K N each)
  float* const GR = sm + L.kk;   // diagnostics rows
  float* const SL = sm + L.slot; // W > 1: slots
  float* const CN = sm + L.cn;   // W > 1: the condensation's obstacle terms
  float* const ME = sm + L.me;   // W > 1: a merit pass's factors
  float* const MLB = sm + L.mlb;
  float* const ML1 = sm + L.ml1;
  float* const ML2 = sm + L.ml2;
  float* const MC = sm + L.mc;
  // The barrier between phases: the scenario's warp, or its block.
  auto sync = [] {
    if constexpr (kWide) __syncthreads(); else __syncwarp();
  };

  // --- inputs: each read once --------------------------------------------
  {
    const int n_track = K == 0 ? 0 : (affine ? 2 * K : KN);
    const int n_obi = K > 0 ? 2 * K + 1 : 0;
    const int n_warm = 3 * T1 + 2 * N;
    const size_t bb = static_cast<size_t>(b);
    for (int i = tid; i < kScalRows; i += NT) SCAL[i] = scal_in[bb * kScalRows + i];
    for (int i = tid; i < n_obi; i += NT) OBI[i] = obinfo_in[bb * n_obi + i];
    for (int i = tid; i < n_track; i += NT) {
      TX[i] = tx_in[bb * n_track + i];
      TY[i] = ty_in[bb * n_track + i];
    }
    // x, y, th, v, w lie in the warm start's order.
    for (int i = tid; i < n_warm; i += NT) X[i] = warm_in[bb * n_warm + i];
    for (int i = tid; i < 3 * T1 + 2 * N; i += NT) DX[i] = 0.f;  // DX, DU
    for (int i = tid; i < (ELASTIC ? 3 : 1) * KN; i += NT) STEP[i] = 0.f;
  }
  sync();

  // --- problem rows ----------------------------------------------------
  const float x0 = SCAL[0], y0 = SCAL[1], th0 = SCAL[2];
  const float gx = SCAL[3], gy = SCAL[4], gth = SCAL[5];
  const float sig_row = SCAL[26];
  const float infl = K > 0 ? OBI[2 * K] : 0.f;
  const float w0 = p.w0, w1 = p.w1, w2 = p.w2;
  const float goal[3] = {gx, gy, gth}, wgoal[3] = {w0, w1, w2};

  auto gm = [&](int t) {  // goal-cost weight of state t
    return (t >= 1 && (!p.exclude_terminal || t <= N - 1)) ? 1.f : 0.f;
  };
  // Obstacle k at column tt (state tt + 1), seen from the point (px, py).
  auto geo = [&](int k, int tt, float px, float py) {
    float cx, cy;
    if (affine) {
      cx = TX[k] + static_cast<float>(tt) * TX[K + k];
      cy = TY[k] + static_cast<float>(tt) * TY[K + k];
    } else {
      cx = TX[k * N + tt];
      cy = TY[k * N + tt];
    }
    const float dxk = px - cx, dyk = py - cy;
    const float dist = sqrtf(dxk * dxk + dyk * dyk + 1e-16f);
    const float ds_safe = maxp(dist, 1e-2f);
    return Geo{dist - (OBI[k] + infl), dxk / ds_safe, dyk / ds_safe};
  };
  auto dyn = [&](int t) {
    float st, ct;
    sincosf(TH[t], &st, &ct);
    const float v = V[t];
    return Dyn{-v * st * dt, v * ct * dt, ct * dt, st * dt,
               X[t] + v * ct * dt - X[t + 1], Y[t] + v * st * dt - Y[t + 1],
               TH[t] + W[t] * dt - TH[t + 1]};
  };
  // Box element (t, f) at the current iterate: fn(c, s, nu, mask, J dz,
  // slot) with s and nu writable and slot = f (N + 1) + t, the element's
  // place in a wide merit pass's factors.  Family f = 0..3 is vl, vu, wl,
  // wu of control t; f = 4..9 is xl0..2, xu0..2 of state t.  A box mask is
  // 0 or 1 (the bound's finiteness).
  auto box_at = [&](int t, int f, auto&& fn) {
    const bool ctrl = f < 4;
    const int i = ctrl ? f >> 1 : (f - 4) % 3;       // component
    const bool upper = ctrl ? (f & 1) != 0 : f >= 7;
    const float z = ctrl ? V[i * N + t] : X[i * T1 + t];
    const float dz = ctrl ? DU[i * N + t] : DX[i * T1 + t];
    const float bound = ctrl ? SCAL[6 + f] : SCAL[(upper ? 17 : 14) + i];
    const float m = ctrl ? SCAL[10 + f] : SCAL[(upper ? 23 : 20) + i];
    float* const sp = ctrl ? SC + f * N + t : SX + (f - 4) * T1 + t;
    float* const np = ctrl ? NUC + f * N + t : NUX + (f - 4) * T1 + t;
    fn(upper ? bound - z : z - bound, *sp, *np, m, upper ? -dz : dz, f * T1 + t);
  };
  // Every box element, for t = first, first + stride, ...: the order of a
  // warp's sums.  One call site, so the kernel carries one copy of fn per
  // visit; the wide instances' warp 0 unrolls the families.
  auto visit_box = [&](int first, int stride, auto&& fn) {
    for (int t = first; t < T1; t += stride) {
      if constexpr (kWide) {
        if (t < N) {
#pragma unroll
          for (int f = 0; f < 4; ++f) box_at(t, f, fn);
        }
#pragma unroll
        for (int f = 4; f < 10; ++f) box_at(t, f, fn);
      } else {
#pragma unroll 1
        for (int f = t < N ? 0 : 4; f < 10; ++f) box_at(t, f, fn);
      }
    }
  };
  // Every box element once, in no set order: the scenario's threads take
  // the elements (t, f) by one flat index at W > 1, and the stages t at
  // W = 1.
  auto box_pass = [&](auto&& fn) {
    if constexpr (kWide) {
      for (int e = tid; e < 10 * N + 6; e += NT) {
        const int t = e < 10 * N ? e / 10 : N;
        box_at(t, e < 10 * N ? e - 10 * t : e - 10 * N + 4, fn);
      }
    } else {
      visit_box(lane, kLanes, fn);
    }
  };
  auto sigma = [&](float nu, float s, float m) {
    return clipp(m * nu / maxp(s, kFloor), 0.f, kSigmaMax);
  };
  auto ftb = [&](float v, float dv) {
    return dv < 0.f ? -p.tau * v / minp(dv, -1e-30f) : 1.f;
  };
  // Elastic condensation of c + e - s = 0 at barrier mu (f32 floors).
  auto el_coef = [&](float c, float s, float nu, float e, float m, float mu) {
    const float s_safe = maxp(s, kFloor), e_safe = maxp(e, kFloor);
    const float sig_s = sigma(nu, s, m);
    const float sig_e = clipp(mu / (e_safe * e_safe), 0.f, kSigmaMax);
    return ElCoef{mu / s_safe - nu, p.rho_e - mu / e_safe - nu, c + e - s, sig_s, sig_e,
                  m * sig_s * sig_e / maxp(sig_s + sig_e, kFloor)};
  };
  // Obstacle element r = k N + tt (state tt + 1): its Newton step at the
  // current iterate, from its geometry and J dz.
  auto ob_step = [&](int r, float mu) {
    const int k = r / N, tt = r - k * N;
    const float m = OBI[K + k], s = SOB[r], nu = NUOB[r];
    const Geo g = geo(k, tt, X[tt + 1], Y[tt + 1]);
    const float jdz = g.nx * DX[tt + 1] + g.ny * DX[T1 + tt + 1];
    if constexpr (ELASTIC) {
      const ElCoef q = el_coef(g.c, s, nu, EOB[r], m, mu);
      const float beta = q.sig_e / maxp(q.sig_s + q.sig_e, kFloor);
      const float ds = m * beta * (jdz + q.r_c + (q.T - q.r_e) / q.sig_e);
      return ObStep{ds, m * (q.T - q.r_e - q.sig_s * ds) / q.sig_e, m * (q.T - q.sig_s * ds)};
    } else {
      const float ds = m * (jdz + g.c - s);
      return ObStep{ds, 0.f, m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds)};
    }
  };
  // The step as the line search and the update read it, stored by the
  // fraction to the boundary (the hard branch keeps only ds: its dnu is
  // cheap).  The same bits as ob_step.
  auto ob_step_now = [&](int r, float mu) {
    if constexpr (ELASTIC) return ObStep{STEP[r], STEP[KN + r], STEP[2 * KN + r]};
    const float m = OBI[K + r / N], s = SOB[r], nu = NUOB[r], ds = STEP[r];
    return ObStep{ds, 0.f, m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds)};
  };

  // Merit components at z + a dz, with the slack steps of the current
  // iterate: objective, equality residuals (defects and initial-state pin),
  // the log barrier of every family and the obstacle consistency.  The box
  // families' consistency is affine along the step, (1 - a) * consist0,
  // and is added by the caller.  ``mu`` enters only the hard step's dnu,
  // which the merit does not read.  The costly factors, by element: state
  // t's equality residual, a box element's log, and an obstacle element's
  // logs of s and e, its e and its consistency.
  auto eq_term = [&](int t, float a) {
    const float xs = X[t] + a * DX[t], ys = Y[t] + a * DX[T1 + t];
    const float ths = TH[t] + a * DX[2 * T1 + t];
    if (t == 0) return fabsf(x0 - xs) + fabsf(y0 - ys) + fabsf(th0 - ths);
    const float xp = X[t - 1] + a * DX[t - 1], yp = Y[t - 1] + a * DX[T1 + t - 1];
    const float thp = TH[t - 1] + a * DX[2 * T1 + t - 1];
    const float vp = V[t - 1] + a * DU[t - 1], wp = W[t - 1] + a * DU[N + t - 1];
    float st, ct;
    sincosf(thp, &st, &ct);
    return fabsf(xp + vp * ct * dt - xs) + fabsf(yp + vp * st * dt - ys) +
           fabsf(thp + wp * dt - ths);
  };
  auto box_log = [&](float c, float s, float m, float jdz, float a) {
    return logf(maxp(s + a * (m * (jdz + c - s)), 1e-30f));
  };
  auto ob_te = [&](int r, float a, float mu) {  // elastic e along the step
    return EOB[r] + a * ob_step_now(r, mu).de;
  };
  auto ob_merit = [&](int r, float a, float mu) {
    const int k = r / N, tt = r - k * N;
    const ObStep st = ob_step_now(r, mu);
    const float xs = X[tt + 1] + a * DX[tt + 1], ys = Y[tt + 1] + a * DX[T1 + tt + 1];
    const float ts = SOB[r] + a * st.ds;
    ObMerit o{logf(maxp(ts, 1e-30f)), 0.f, 0.f, 0.f};
    if constexpr (ELASTIC) {
      o.te = ob_te(r, a, mu);
      o.log_e = logf(maxp(o.te, 1e-30f));
      o.cons = fabsf(geo(k, tt, xs, ys).c + o.te - ts);
    } else {
      o.cons = fabsf(geo(k, tt, xs, ys).c - ts);
    }
    return o;
  };
  auto merit_pass = [&](float a, float mu) {
    if constexpr (kWide) {  // every thread: its elements' factors
      for (int t = tid; t < T1; t += NT) ME[t] = eq_term(t, a);
      box_pass([&](float c, float& s, float&, float m, float jdz, int slot) {
        MLB[slot] = m * box_log(c, s, m, jdz, a);  // exact: m is 0 or 1
      });
      for (int r = tid; r < KN; r += NT) {
        const ObMerit o = ob_merit(r, a, mu);
        ML1[r] = o.log_s;
        if constexpr (ELASTIC) ML2[r] = o.log_e;
        MC[r] = o.cons;
      }
      __syncthreads();
    }
    // The sums, on the scenario's warp (warp 0 at W > 1), in its order.
    float obj = 0.f, eq = 0.f, lg = 0.f, cons = 0.f;
    if (!kWide || warp == 0) {
      for (int t = lane; t < T1; t += kLanes) {
        const float comp[3] = {X[t], Y[t], TH[t]};
        const float dz[3] = {DX[t], DX[T1 + t], DX[2 * T1 + t]};
        const float xs = comp[0] + a * dz[0], ys = comp[1] + a * dz[1];
        const float ths = comp[2] + a * dz[2];
        const float ex = xs - gx, ey = ys - gy, eth = ths - gth;
        obj += gm(t) * (w0 * ex * ex + w1 * ey * ey + w2 * eth * eth);
        eq += kWide ? ME[t] : eq_term(t, a);
        if (t < N) {
          const float vs = V[t] + a * DU[t], ws = W[t] + a * DU[N + t];
          const float neg = minp(vs, 0.f), pos = maxp(vs, 0.f);
          obj += p.w_neg * (p.reverse_squared ? neg * neg : neg);
          obj += p.w_pos * (pos * pos);
          obj += p.w_ang * (ws * ws);
        }
      }
      if constexpr (kWide) {  // the stored m log, so lg + m log keeps its bits
        for (int t = lane; t < T1; t += kLanes) {
          if (t < N) {
#pragma unroll
            for (int f = 0; f < 4; ++f) lg += MLB[f * T1 + t];
          }
#pragma unroll
          for (int f = 4; f < 10; ++f) lg += MLB[f * T1 + t];
        }
      } else {
        visit_box(lane, kLanes, [&](float c, float& s, float&, float m, float jdz, int) {
          lg += m * box_log(c, s, m, jdz, a);
        });
      }
      for (int r = lane; r < KN; r += kLanes) {
        const float om = OBI[K + r / N];
        ObMerit o;
        if constexpr (kWide) {
          o = ObMerit{ML1[r], 0.f, 0.f, MC[r]};
          if constexpr (ELASTIC) {
            o.log_e = ML2[r];
            o.te = ob_te(r, a, mu);
          }
        } else {
          o = ob_merit(r, a, mu);
        }
        lg += om * o.log_s;
        if constexpr (ELASTIC) {
          lg += om * o.log_e;
          obj += p.rho_e * (om * o.te);
        }
        cons += om * o.cons;
      }
      obj = warp_sum(obj);
      eq = warp_sum(eq);
      lg = warp_sum(lg);
      cons = warp_sum(cons);
    }
    if constexpr (kWide) {  // warp 0's sums to every thread
      if (tid == 0) {
        SL[kSlotMerit] = obj;
        SL[kSlotMerit + 1] = eq;
        SL[kSlotMerit + 2] = lg;
        SL[kSlotMerit + 3] = cons;
      }
      __syncthreads();
      return Merit{SL[kSlotMerit], SL[kSlotMerit + 1], SL[kSlotMerit + 2], SL[kSlotMerit + 3]};
    } else {
      return Merit{obj, eq, lg, cons};
    }
  };

  // Complementarity sum, mask count, largest dual and box consistency at
  // the current iterate: a product or two of rows per element, on the
  // scenario's warp (warp 0 at W > 1).
  auto reduce = [&]() {
    float tot = 0.f, cnt = 0.f, nu_max = 0.f, cons = 0.f;
    if (!kWide || warp == 0) {
      visit_box(lane, kLanes, [&](float c, float& s, float& nu, float m, float, int) {
        tot += m * s * nu;
        cnt += m;
        nu_max = maxp(nu_max, m * nu);
        cons += m * fabsf(c - s);
      });
      for (int r = lane; r < KN; r += kLanes) {
        const float m = OBI[K + r / N], s = SOB[r], nu = NUOB[r];
        tot += m * s * nu;
        cnt += m;
        nu_max = maxp(nu_max, m * nu);
      }
      tot = warp_sum(tot);
      cnt = warp_sum(cnt);
      nu_max = warp_max(nu_max);
      cons = warp_sum(cons);
    }
    if constexpr (kWide) {
      if (tid == 0) {
        SL[kSlotRed] = tot;
        SL[kSlotRed + 1] = cnt;
        SL[kSlotRed + 2] = nu_max;
        SL[kSlotRed + 3] = cons;
      }
      __syncthreads();
      return Red{SL[kSlotRed], SL[kSlotRed + 1], SL[kSlotRed + 2], SL[kSlotRed + 3]};
    } else {
      return Red{tot, cnt, nu_max, cons};
    }
  };

  // --- init from the warm start ------------------------------------------
  box_pass([&](float c, float& s, float& nu, float m, float, int) {
    if (m > 0.f) {
      s = maxp(c, 1e-2f);
      nu = p.mu_init / s;
    } else {
      s = 1.f;
      nu = 0.f;
    }
  });
  for (int r = tid; r < KN; r += NT) {
    const int k = r / N, tt = r - k * N;
    const float m = OBI[K + k];
    const float c = geo(k, tt, X[tt + 1], Y[tt + 1]).c;
    const float s = m > 0.f ? maxp(c, 1e-2f) : 1.f;
    SOB[r] = s;
    NUOB[r] = m > 0.f ? p.mu_init / s : 0.f;
    // Central-ish elastic init: e solves c + e = s where violated, else
    // sits at mu / rho_e.
    if (ELASTIC) EOB[r] = m > 0.f ? maxp(s - c, p.mu_init / p.rho_e) : 1.f;
  }
  sync();
  // Merit components of the current iterate, carried across iterations
  // (the accepted candidate's become the next iteration's).
  float m_obj, m_log, m_eqc;
  {
    const Red r0 = reduce();
    const Merit m0 = merit_pass(0.f, p.mu_init);  // the direction is zero here
    m_obj = m0.obj;
    m_log = m0.log;
    m_eqc = m0.eq + (r0.cons_box + m0.cons);
  }

  // Obstacle k's terms in the condensed stage of state tt + 1 at the point
  // (px, py): its unit normal, gradient coefficient and Hessian block
  // (Gauss-Newton and damped curvature).
  auto ob_cond = [&](int k, int tt, float px, float py, float mu) {
    const int r = k * N + tt;
    const float om = OBI[K + k];
    const Geo G = geo(k, tt, px, py);
    const float s = SOB[r], nu = NUOB[r];
    float sg, gc;
    if constexpr (ELASTIC) {
      const ElCoef q = el_coef(G.c, s, nu, EOB[r], om, mu);
      sg = q.sig_eff;
      gc = om * (nu - sg * q.r_c + sg * (q.T / maxp(q.sig_s, kFloor) + q.r_e / q.sig_e));
    } else {
      sg = sigma(nu, s, om);
      gc = om * (mu / maxp(s, kFloor) - sg * (G.c - s));
    }
    float h00 = sg * G.nx * G.nx, h01 = sg * G.nx * G.ny, h11 = sg * G.ny * G.ny;
    if (p.curvature) {
      const float dsafe = maxp(G.c + (OBI[k] + infl), 1e-2f);
      const float wc = maxp(-om * nu / dsafe, -0.9f * sg);
      h00 = h00 + wc * (1.f - G.nx * G.nx);
      h01 = h01 - wc * G.nx * G.ny;
      h11 = h11 + wc * (1.f - G.ny * G.ny);
    }
    return ObCond{G.nx, G.ny, gc, h00, h01, h11};
  };
  // At W > 1 the condensation's obstacle terms are computed beforehand,
  // every element by one thread, into the scratch (6 rows of K N).
  auto ob_cond_at = [&](int r) {
    return ObCond{CN[r], CN[KN + r], CN[2 * KN + r], CN[3 * KN + r], CN[4 * KN + r],
                  CN[5 * KN + r]};
  };
  auto state_stage = [&](int t, float mu, float reg) {
    const float comp[3] = {X[t], Y[t], TH[t]};
    const float g = gm(t);
    StateQ S;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S.q[i] = 2.f * g * wgoal[i] * (comp[i] - goal[i]);
      S.Q[i] = 2.f * g * wgoal[i];
      const int rl = i * T1 + t, ru = (3 + i) * T1 + t;
      const float sl = SX[rl], nul = NUX[rl], su = SX[ru], nuu = NUX[ru];
      // The state bounds and their masks, read where used (as registers
      // held across the iteration they made the kernel spill).
      const float m_xl = SCAL[20 + i], m_xu = SCAL[23 + i];
      const float sgl = sigma(nul, sl, m_xl), sgu = sigma(nuu, su, m_xu);
      const float gl = m_xl * (mu / maxp(sl, kFloor) - sgl * ((comp[i] - SCAL[14 + i]) - sl));
      const float gu = m_xu * (mu / maxp(su, kFloor) - sgu * ((SCAL[17 + i] - comp[i]) - su));
      S.q[i] = S.q[i] - gl + gu;
      S.Q[i] = S.Q[i] + sgl + sgu;
    }
    S.Qxy = 0.f;
    if (t >= 1 && K > 0) {
      float addx = 0.f, addy = 0.f, a00 = 0.f, a01 = 0.f, a11 = 0.f;
      for (int k = 0; k < K; ++k) {
        const ObCond q =
            kWide ? ob_cond_at(k * N + t - 1) : ob_cond(k, t - 1, comp[0], comp[1], mu);
        addx += -q.nx * q.gc;
        addy += -q.ny * q.gc;
        a00 += q.h00;
        a01 += q.h01;
        a11 += q.h11;
      }
      S.q[0] = S.q[0] + addx;
      S.q[1] = S.q[1] + addy;
      S.Q[0] = S.Q[0] + a00;
      S.Q[1] = S.Q[1] + a11;
      S.Qxy = a01;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) S.Q[i] = S.Q[i] + reg;
    return S;
  };
  // Cost gradient of v (the reverse penalty and the positive-speed term).
  auto grad_v = [&](float v) {
    const float gv = p.reverse_squared ? 2.f * p.w_neg * minp(v, 0.f)
                                       : p.w_neg * (v < 0.f ? 1.f : 0.f);
    return gv + 2.f * p.w_pos * maxp(v, 0.f);
  };
  auto ctrl_stage = [&](int t, float mu, float reg) {
    const float v = V[t], w = W[t];
    float Hv = p.reverse_squared ? 2.f * p.w_neg * (v < 0.f ? 1.f : 0.f) : 0.f;
    Hv = Hv + 2.f * p.w_pos * (v > 0.f ? 1.f : 0.f);
    // The control bounds and masks, read where used (as the state's).
    const float cc[4] = {v - SCAL[6], SCAL[7] - v, w - SCAL[8], SCAL[9] - w};
    const float mm[4] = {SCAL[10], SCAL[11], SCAL[12], SCAL[13]};
    float g[4], sg[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float s = SC[f * N + t], nu = NUC[f * N + t];
      sg[f] = sigma(nu, s, mm[f]);
      g[f] = mm[f] * (mu / maxp(s, kFloor) - sg[f] * (cc[f] - s));
    }
    return CtrlQ{Hv + sg[0] + sg[1] + reg, 2.f * p.w_ang + sg[2] + sg[3] + reg,
                 grad_v(v) - g[0] + g[1], 2.f * p.w_ang * w - g[2] + g[3]};
  };
  // Stage rows: dyn a02, a12, b00, b10, d0, d1, d2 (N each), ctrl Qv, Qw,
  // qv, qw (N each), state Q0, Q1, Q2, Qxy, q0, q1, q2 (N + 1 each).
  float* const SD = ST;
  float* const SCQ = ST + 7 * N;
  float* const SSQ = ST + 11 * N;
  auto dyn_at = [&](int t) {
    return Dyn{SD[t], SD[N + t], SD[2 * N + t], SD[3 * N + t], SD[4 * N + t],
               SD[5 * N + t], SD[6 * N + t]};
  };
  auto ctrl_at = [&](int t) {
    return CtrlQ{SCQ[t], SCQ[N + t], SCQ[2 * N + t], SCQ[3 * N + t]};
  };
  auto state_at = [&](int t) {
    StateQ S;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S.Q[i] = SSQ[i * T1 + t];
      S.q[i] = SSQ[(4 + i) * T1 + t];
    }
    S.Qxy = SSQ[3 * T1 + t];
    return S;
  };

  float reg = p.reg, sig_c = sig_row;
  const int iters = *iters_in;
  for (int it = 0; it < iters; ++it) {
    // --- (a) reduce: the adaptive barrier ---------------------------------
    const Red r = reduce();
    const float mu = clipp(sig_c * r.tot / maxp(r.cnt, 1.f), p.mu_floor, p.mu_init);

    // --- (b) condensation: every stage row in parallel ----------------------
    // The dynamics and control rows of stage t < N.
    auto dyn_ctrl_rows = [&](int t) {
      const Dyn D = dyn(t);
      SD[t] = D.a02;
      SD[N + t] = D.a12;
      SD[2 * N + t] = D.b00;
      SD[3 * N + t] = D.b10;
      SD[4 * N + t] = D.d0;
      SD[5 * N + t] = D.d1;
      SD[6 * N + t] = D.d2;
      const CtrlQ C = ctrl_stage(t, mu, reg);
      SCQ[t] = C.Qv;
      SCQ[N + t] = C.Qw;
      SCQ[2 * N + t] = C.qv;
      SCQ[3 * N + t] = C.qw;
    };
    if constexpr (kWide) {  // first the obstacle terms and those rows, in parallel
      for (int e = tid; e < KN + N; e += NT) {
        if (e < N) {
          dyn_ctrl_rows(e);
          continue;
        }
        const int r = e - N, k = r / N, tt = r - k * N;
        const ObCond q = ob_cond(k, tt, X[tt + 1], Y[tt + 1], mu);
        CN[r] = q.nx;
        CN[KN + r] = q.ny;
        CN[2 * KN + r] = q.gc;
        CN[3 * KN + r] = q.h00;
        CN[4 * KN + r] = q.h01;
        CN[5 * KN + r] = q.h11;
      }
      __syncthreads();
    }
    for (int t = tid; t < T1; t += NT) {
      if (!kWide && t < N) dyn_ctrl_rows(t);
      const StateQ S = state_stage(t, mu, reg);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        SSQ[i * T1 + t] = S.Q[i];
        SSQ[(4 + i) * T1 + t] = S.q[i];
      }
      SSQ[3 * T1 + t] = S.Qxy;
    }
    sync();

    // --- (c) backward Riccati sweep on thread 0 -----------------------------
    float lam_max = 0.f;
    if (tid == 0) {
      StateQ S = state_at(N);
      float P00 = S.Q[0], P01 = S.Qxy, P02 = 0.f, P11 = S.Q[1], P12 = 0.f, P22 = S.Q[2];
      float p0 = S.q[0], p1 = S.q[1], p2 = S.q[2];
      float l0 = p0, l1 = p1, l2 = p2;  // adjoint estimate of the dynamics duals
      lam_max = maxp(fabsf(p0), maxp(fabsf(p1), fabsf(p2)));
      for (int t = N - 1; t >= 0; --t) {
        const Dyn D = dyn_at(t);
        const CtrlQ C = ctrl_at(t);
        S = state_at(t);
        const float Pa0 = P00 * D.a02 + P01 * D.a12 + P02;
        const float Pa1 = P01 * D.a02 + P11 * D.a12 + P12;
        const float Pa2 = P02 * D.a02 + P12 * D.a12 + P22;
        const float Pd0 = P00 * D.d0 + P01 * D.d1 + P02 * D.d2 + p0;
        const float Pd1 = P01 * D.d0 + P11 * D.d1 + P12 * D.d2 + p1;
        const float Pd2 = P02 * D.d0 + P12 * D.d1 + P22 * D.d2 + p2;
        const float PB00 = D.b00 * P00 + D.b10 * P01;
        const float PB01 = D.b00 * P01 + D.b10 * P11;
        const float PB02 = D.b00 * P02 + D.b10 * P12;
        const float Quu00 = C.Qv + (D.b00 * PB00 + D.b10 * PB01);
        const float Quu01 = dt * PB02;
        const float Quu11 = C.Qw + dt * dt * P22;
        const float Qux00 = PB00, Qux01 = PB01, Qux02 = D.b00 * Pa0 + D.b10 * Pa1;
        const float Qux10 = dt * P02, Qux11 = dt * P12, Qux12 = dt * Pa2;
        const float qu0 = C.qv + D.b00 * Pd0 + D.b10 * Pd1;
        const float qu1 = C.qw + dt * Pd2;
        const float inv = 1.f / (Quu00 * Quu11 - Quu01 * Quu01);
        const float i00 = Quu11 * inv, i01 = -Quu01 * inv, i11 = Quu00 * inv;
        const float K00 = -(i00 * Qux00 + i01 * Qux10);
        const float K01 = -(i00 * Qux01 + i01 * Qux11);
        const float K02 = -(i00 * Qux02 + i01 * Qux12);
        const float K10 = -(i01 * Qux00 + i11 * Qux10);
        const float K11 = -(i01 * Qux01 + i11 * Qux11);
        const float K12 = -(i01 * Qux02 + i11 * Qux12);
        const float k0 = -(i00 * qu0 + i01 * qu1);
        const float k1 = -(i01 * qu0 + i11 * qu1);
        KK[t] = K00;
        KK[N + t] = K01;
        KK[2 * N + t] = K02;
        KK[3 * N + t] = K10;
        KK[4 * N + t] = K11;
        KK[5 * N + t] = K12;
        KK[6 * N + t] = k0;
        KK[7 * N + t] = k1;
        const float aPa = D.a02 * Pa0 + D.a12 * Pa1 + Pa2;
        const float S00 = Qux00 * K00 + Qux10 * K10, S01 = Qux00 * K01 + Qux10 * K11;
        const float S02 = Qux00 * K02 + Qux10 * K12, S10 = Qux01 * K00 + Qux11 * K10;
        const float S11 = Qux01 * K01 + Qux11 * K11, S12 = Qux01 * K02 + Qux11 * K12;
        const float S20 = Qux02 * K00 + Qux12 * K10, S21 = Qux02 * K01 + Qux12 * K11;
        const float S22 = Qux02 * K02 + Qux12 * K12;
        P00 = S.Q[0] + P00 + S00;
        P01 = S.Qxy + P01 + 0.5f * (S01 + S10);
        P02 = Pa0 + 0.5f * (S02 + S20);
        P11 = S.Q[1] + P11 + S11;
        P12 = Pa1 + 0.5f * (S12 + S21);
        P22 = S.Q[2] + aPa + S22;
        p0 = S.q[0] + Pd0 + Qux00 * k0 + Qux10 * k1;
        p1 = S.q[1] + Pd1 + Qux01 * k0 + Qux11 * k1;
        p2 = S.q[2] + D.a02 * Pd0 + D.a12 * Pd1 + Pd2 + Qux02 * k0 + Qux12 * k1;
        const float nl2 = S.q[2] + D.a02 * l0 + D.a12 * l1 + l2;
        l0 = S.q[0] + l0;
        l1 = S.q[1] + l1;
        l2 = nl2;
        lam_max = maxp(lam_max, maxp(fabsf(l0), maxp(fabsf(l1), fabsf(l2))));
      }

      // --- (d) forward rollout on thread 0 ----------------------------------
      float dx0 = x0 - X[0], dx1 = y0 - Y[0], dx2 = th0 - TH[0];
      DX[0] = dx0;
      DX[T1] = dx1;
      DX[2 * T1] = dx2;
      for (int t = 0; t < N; ++t) {
        const float du0 = KK[t] * dx0 + KK[N + t] * dx1 + KK[2 * N + t] * dx2 + KK[6 * N + t];
        const float du1 =
            KK[3 * N + t] * dx0 + KK[4 * N + t] * dx1 + KK[5 * N + t] * dx2 + KK[7 * N + t];
        DU[t] = du0;
        DU[N + t] = du1;
        const Dyn D = dyn_at(t);
        dx0 = dx0 + D.a02 * dx2 + D.b00 * du0 + D.d0;
        dx1 = dx1 + D.a12 * dx2 + D.b10 * du0 + D.d1;
        dx2 = dx2 + dt * du1 + D.d2;
        DX[t + 1] = dx0;
        DX[T1 + t + 1] = dx1;
        DX[2 * T1 + t + 1] = dx2;
      }
    }
    if constexpr (kWide) {
      if (tid == 0) SL[kSlotLam] = lam_max;
      __syncthreads();
      lam_max = SL[kSlotLam];
    } else {
      __syncwarp();
      lam_max = __shfl_sync(kFull, lam_max, 0);
    }

    // --- (e) slack / dual steps: fraction to the boundary --------------------
    float as = 1.f, an = 1.f, sinf_l = 0.f;
    for (int t = tid; t < T1; t += NT) {
      sinf_l = maxp(sinf_l, maxp(fabsf(DX[t]), maxp(fabsf(DX[T1 + t]), fabsf(DX[2 * T1 + t]))));
      if (t < N) sinf_l = maxp(sinf_l, maxp(fabsf(DU[t]), fabsf(DU[N + t])));
    }
    box_pass([&](float c, float& s, float& nu, float m, float jdz, int) {
      const float ds = m * (jdz + c - s);
      const float dnu = m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds);
      as = minp(as, ftb(s, ds));
      an = minp(an, ftb(nu, dnu));
    });
    for (int r = tid; r < KN; r += NT) {
      const ObStep st = ob_step(r, mu);
      as = minp(as, ftb(SOB[r], st.ds));
      if constexpr (ELASTIC) {
        as = minp(as, ftb(EOB[r], st.de));
      }
      an = minp(an, ftb(NUOB[r], st.dnu));
      STEP[r] = st.ds;
      if constexpr (ELASTIC) {
        STEP[KN + r] = st.de;
        STEP[2 * KN + r] = st.dnu;
      }
    }
    float alpha_s = warp_min(as);
    float alpha_nu = warp_min(an);
    float step_inf = warp_max(sinf_l);
    if constexpr (kWide) {  // the warps' results, in warp order
      float* const part = SL + kSlotStep;
      if (lane == 0) {
        part[3 * warp] = alpha_s;
        part[3 * warp + 1] = alpha_nu;
        part[3 * warp + 2] = step_inf;
      }
      __syncthreads();
      alpha_s = part[0];
      alpha_nu = part[1];
      step_inf = part[2];
      for (int w = 1; w < WIDTH; ++w) {
        alpha_s = minp(alpha_s, part[3 * w]);
        alpha_nu = minp(alpha_nu, part[3 * w + 1]);
        step_inf = maxp(step_inf, part[3 * w + 2]);
      }
    } else {
      __syncwarp();
    }
    // l1 penalty: dominate the inequality duals and the dynamics adjoints.
    const float rho = maxp(p.merit_penalty, 2.f * maxp(r.nu_max, lam_max));

    // --- (f) merit line search ----------------------------------------------
    const float merit0 = m_obj - mu * m_log + rho * m_eqc;
    const bool newton = step_inf < 1e-2f;
    const float tol = 16.f * kEps * (1.f + fabsf(merit0)) +
                      (newton ? 10.f * rho * step_inf * step_inf : 0.f);
    float alpha_best = alpha_s * p.alpha_min_factor, aj = alpha_s;
    float s_obj = 0.f, s_log = 0.f, s_eqc = 0.f;
    bool found = false, fin_last = false;
    int n_rej = 0;
    for (int j = 0; j < p.ls_iters; ++j) {
      const Merit M = merit_pass(aj, mu);
      const float eqc = M.eq + ((1.f - aj) * r.cons_box + M.cons);
      const float m = M.obj - mu * M.log + rho * eqc;
      const bool fin = isfinite(m);
      const bool ok = fin && m <= merit0 + tol;
      const bool take = ok && !found;
      const bool last = j == p.ls_iters - 1;
      found = found || ok;
      // Stash the components of the candidate that will be executed: the
      // first accepted one, else the deepest.
      if (take || (last && !found)) {
        s_obj = M.obj;
        s_log = M.log;
        s_eqc = eqc;
      }
      if (take) alpha_best = aj;
      if (last) fin_last = fin;
      if (!found) ++n_rej;
      aj *= p.ls_backtrack;
    }
    // All rejected: execute the deepest candidate only if its merit was
    // finite; a frozen scenario keeps its merit components.
    const bool keep = found || fin_last;
    const float alpha = keep ? alpha_best : 0.f;
    if (keep) {
      m_obj = s_obj;
      m_log = s_log;
      m_eqc = s_eqc;
    }
    alpha_nu = minp(alpha_nu, alpha);

    // --- (g) updates with the dual clamp --------------------------------------
    auto update = [&](float& s, float& nu, float m, float ds, float dnu) {
      const float s_new = s + alpha * ds;
      const float center = mu / maxp(s_new, kFloor);
      nu = m * clipp(nu + alpha_nu * dnu, center / kKappa, center * kKappa);
      s = s_new;
    };
    box_pass([&](float c, float& s, float& nu, float m, float jdz, int) {
      const float ds = m * (jdz + c - s);
      update(s, nu, m, ds, m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds));
    });
    for (int r = tid; r < KN; r += NT) {
      const ObStep st = ob_step_now(r, mu);
      if constexpr (ELASTIC) {
        EOB[r] = EOB[r] + alpha * st.de;
      }
      update(SOB[r], NUOB[r], OBI[K + r / N], st.ds, st.dnu);
    }
    sync();  // every family read the trajectory before it moves
    for (int t = tid; t < T1; t += NT) {
      X[t] = X[t] + alpha * DX[t];
      Y[t] = Y[t] + alpha * DX[T1 + t];
      TH[t] = TH[t] + alpha * DX[2 * T1 + t];
      if (t < N) {
        V[t] = V[t] + alpha * DU[t];
        W[t] = W[t] + alpha * DU[N + t];
      }
    }
    sync();
    // Grow reg on genuine large-step rejections, decay it otherwise; slow
    // the barrier schedule on throttled steps outside the Newton regime.
    const bool grow = !found || (n_rej >= 4 && !newton);
    reg = grow ? minp(maxp(reg, p.reg) * 8.f, 1e8f) : maxp(reg / 3.f, p.reg);
    if (p.adaptive_sigma) {
      sig_c = (alpha < 0.25f && !newton)
                  ? minp(sig_c * 1.5f, maxp(p.mu_sigma_max, sig_row))
                  : maxp(sig_c * 0.9f, sig_row);
    }
  }

  // --- exact KKT diagnostics at the final iterate ---------------------------
  // Sums on the scenario's warp (warp 0 at W > 1) in its order: a product
  // or two of rows per element; maxima over every thread's elements.
  float nu_sum = 0.f, nu_cnt = 0.f, viol = 0.f, comp = 0.f, tot = 0.f;
  auto kkt_sums = [&](float s, float nu, float m) {
    nu_sum += m * fabsf(nu);
    nu_cnt += m;
    tot += m * s * nu;
  };
  auto kkt_max = [&](float c, float s, float nu, float m) {
    viol = maxp(viol, m * maxp(-c, 0.f));
    comp = maxp(comp, m * fabsf(s * nu));
  };
  box_pass([&](float c, float& s, float& nu, float m, float, int) {
    if constexpr (!kWide) kkt_sums(s, nu, m);
    kkt_max(c, s, nu, m);
  });
  for (int r = tid; r < KN; r += NT) {
    const int k = r / N, tt = r - k * N;
    if constexpr (!kWide) kkt_sums(SOB[r], NUOB[r], OBI[K + k]);
    kkt_max(geo(k, tt, X[tt + 1], Y[tt + 1]).c, SOB[r], NUOB[r], OBI[K + k]);
  }
  // Objective, defects and pins; the Lagrangian gradient of every state
  // with the final duals (stored masked), the control gradients and the
  // linearisation, as rows for the adjoint sweep.
  float* const G0 = GR;
  float* const GU = GR + 3 * T1;
  float* const LIN = GU + 2 * N;
  float obj = 0.f, feas = 0.f;
  auto kkt_obj = [&](int t) {
    const float ex = X[t] - gx, ey = Y[t] - gy, eth = TH[t] - gth;
    obj += gm(t) * (w0 * ex * ex + w1 * ey * ey + w2 * eth * eth);
    if (t < N) {
      const float v = V[t], neg = minp(v, 0.f), pos = maxp(v, 0.f);
      obj += p.w_neg * (p.reverse_squared ? neg * neg : neg);
      obj += p.w_pos * (pos * pos);
      obj += p.w_ang * (W[t] * W[t]);
    }
  };
  if constexpr (kWide) {
    if (warp == 0) {
      visit_box(lane, kLanes, [&](float, float& s, float& nu, float m, float, int) {
        kkt_sums(s, nu, m);
      });
      for (int r = lane; r < KN; r += kLanes) kkt_sums(SOB[r], NUOB[r], OBI[K + r / N]);
      for (int t = lane; t < T1; t += kLanes) kkt_obj(t);
    }
  }
  for (int t = tid; t < T1; t += NT) {
    const float comp_t[3] = {X[t], Y[t], TH[t]};
    const float g = gm(t);
    if constexpr (!kWide) kkt_obj(t);
    float G[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      G[i] = 2.f * g * wgoal[i] * (comp_t[i] - goal[i]) - NUX[i * T1 + t] +
             NUX[(3 + i) * T1 + t];
    if (t >= 1 && K > 0) {
      float addx = 0.f, addy = 0.f;
      for (int k = 0; k < K; ++k) {
        const Geo Gk = geo(k, t - 1, comp_t[0], comp_t[1]);
        const float nu = NUOB[k * N + t - 1];
        addx += -Gk.nx * nu;
        addy += -Gk.ny * nu;
      }
      G[0] = G[0] + addx;
      G[1] = G[1] + addy;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) G0[i * T1 + t] = G[i];
    if (t == 0) {
      feas = maxp(feas, fabsf(x0 - X[0]));
      feas = maxp(feas, fabsf(y0 - Y[0]));
      feas = maxp(feas, fabsf(th0 - TH[0]));
    }
    if (t < N) {
      const float v = V[t];
      const Dyn D = dyn(t);
      feas = maxp(feas, maxp(fabsf(D.d0), maxp(fabsf(D.d1), fabsf(D.d2))));
      GU[t] = grad_v(v) - NUC[t] + NUC[N + t];
      GU[N + t] = 2.f * p.w_ang * W[t] - NUC[2 * N + t] + NUC[3 * N + t];
      LIN[t] = D.a02;
      LIN[N + t] = D.a12;
      LIN[2 * N + t] = D.b00;
      LIN[3 * N + t] = D.b10;
    }
  }
  nu_sum = warp_sum(nu_sum);
  nu_cnt = warp_sum(nu_cnt);
  tot = warp_sum(tot);
  obj = warp_sum(obj);
  viol = warp_max(viol);
  comp = warp_max(comp);
  feas = warp_max(feas);
  if constexpr (kWide) {  // the warps' maxima, in warp order
    float* const part = SL + kSlotDiag;
    if (lane == 0) {
      part[3 * warp] = viol;
      part[3 * warp + 1] = comp;
      part[3 * warp + 2] = feas;
    }
    __syncthreads();
    viol = part[0];
    comp = part[1];
    feas = part[2];
    for (int w = 1; w < WIDTH; ++w) {
      viol = maxp(viol, part[3 * w]);
      comp = maxp(comp, part[3 * w + 1]);
      feas = maxp(feas, part[3 * w + 2]);
    }
  } else {
    __syncwarp();
  }
  feas = maxp(feas, viol);

  // Adjoint sweep for the control stationarity, on thread 0.
  if (tid == 0) {
    float l0 = G0[N], l1 = G0[T1 + N], l2 = G0[2 * T1 + N], ru_max = 0.f;
    for (int t = N - 1; t >= 0; --t) {
      const float ru0 = GU[t] + LIN[2 * N + t] * l0 + LIN[3 * N + t] * l1;
      const float ru1 = GU[N + t] + dt * l2;
      ru_max = maxp(ru_max, maxp(fabsf(ru0), fabsf(ru1)));
      const float nl2 = G0[2 * T1 + t] + LIN[t] * l0 + LIN[N + t] * l1 + l2;
      l0 = G0[t] + l0;
      l1 = G0[T1 + t] + l1;
      l2 = nl2;
    }
    // IPOPT's s_d scaling of the dual residual (s_max = 100).
    const float s_d = maxp(100.f, nu_sum / maxp(nu_cnt, 1.f)) / 100.f;
    const float stationarity = ru_max / s_d;
    const float mu_fin = clipp(sig_c * tot / maxp(nu_cnt, 1.f), p.mu_floor, p.mu_init);
    const bool converged =
        stationarity < p.kkt_tol && feas < p.kkt_tol && comp / s_d < p.comp_tol;
    float* const dg = diag_out + static_cast<size_t>(b) * 6;
    dg[0] = converged ? 1.f : 0.f;
    dg[1] = stationarity;
    dg[2] = feas;
    dg[3] = comp;
    dg[4] = obj;
    dg[5] = mu_fin;
  }

  // --- outputs: each written once --------------------------------------------
  const size_t bs = static_cast<size_t>(b) * T1, bc = static_cast<size_t>(b) * N;
  for (int t = tid; t < T1; t += NT) {
    x_out[bs + t] = X[t];
    y_out[bs + t] = Y[t];
    th_out[bs + t] = TH[t];
    if (t < N) {
      v_out[bc + t] = V[t];
      w_out[bc + t] = W[t];
    }
  }
}

using KernelFn = void (*)(const int*, const float*, const float*, const float*, const float*,
                          const float*, float*, float*, float*, float*, float*, float*,
                          const FusedParams);

template <bool EL>
KernelFn instance(int width) {
  return width == kWide ? ipm_fused_kernel<EL, kWide> : ipm_fused_kernel<EL, 1>;
}

struct Launch {  // the instance, its width, warps per block, dynamic shared bytes per block
  KernelFn kernel;
  int width, warps;
  size_t bytes;
  int resident;  // the instance's resident blocks per SM at that launch
};

// The launch of a (B, N, K, elastic, affine) solve on a card with ``sms``
// SMs and ``optin`` bytes of shared memory a block may take.  W = 1 takes
// kWarps scenarios per block where they fit, else 2, else 1 (one where not
// even one fits, so that the card refuses the launch).  The wide instance
// (kWide warps per scenario) is taken where its one-scenario block fits
// and its resident blocks on every SM hold the whole batch at once.
cudaError_t choose(int B, int N, int K, bool elastic, bool affine, int sms, int optin,
                   Launch* out) {
  const size_t wide = wide_bytes(N, K, elastic, affine);
  if (wide <= static_cast<size_t>(optin)) {
    const KernelFn kernel = elastic ? instance<true>(kWide) : instance<false>(kWide);
    int blocks = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(wide));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWide * kLanes,
                                                          wide);
    if (err != cudaSuccess) return err;
    if (blocks > 0 && B <= sms * blocks) {
      *out = Launch{kernel, kWide, kWide, wide, blocks};
      return cudaSuccess;
    }
  }
  const int w = warps_for(N, K, elastic, affine, static_cast<size_t>(optin));
  *out = Launch{elastic ? instance<true>(1) : instance<false>(1), 1, w > 0 ? w : 1, 0, 0};
  out->bytes = smem_bytes(N, K, elastic, affine, out->warps);
  cudaError_t err = cudaFuncSetAttribute(out->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(out->bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out->resident, out->kernel,
                                                        out->warps * kLanes, out->bytes);
  return err;
}

// `choose` for the current card, found once per (card, shape) and kept, so
// that a launch makes one query of the card's attributes and a lookup.  The
// chosen instance's shared-memory limit is set on every call: a launch of
// another shape may have set it lower.
cudaError_t prepare(int B, int N, int K, bool elastic, bool affine, Launch* out) {
  using Key = std::tuple<int, int, int, int, int, int, bool, bool>;
  static std::mutex lock;
  static std::map<Key, Launch> kept;
  int device = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    const Key key{device, optin, sms, B, N, K, elastic, affine};
    std::lock_guard<std::mutex> held(lock);
    const auto found = kept.find(key);
    if (found != kept.end()) {
      *out = found->second;
      err = cudaFuncSetAttribute(out->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(out->bytes));
    } else {
      err = choose(B, N, K, elastic, affine, sms, optin, out);
      if (err == cudaSuccess) kept.emplace(key, *out);
    }
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller reports it
  return err;
}

}  // namespace

// One batched solve on ``stream``; writes the launch's width (warps per
// scenario; 1 at B = 0, where nothing is launched) to ``width``.
extern "C" int kissmpc_ipm_fused_f32(
    const void* iters, const void* scal, const void* warm, const void* tx,
    const void* ty, const void* obinfo, void* x, void* y, void* th, void* v,
    void* w, void* diag, int* width, const FusedParams* params, void* stream) {
  const FusedParams p = *params;
  *width = 1;
  if (p.B > 0) {
    const bool elastic = p.elastic && p.K > 0;
    Launch s;
    const cudaError_t err = prepare(p.B, p.N, p.K, elastic, p.affine != 0, &s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const KernelFn kernel = s.kernel;
    const int per_block = s.width == 1 ? s.warps : 1;  // scenarios per block
    const int blocks = (p.B + per_block - 1) / per_block;
    kernel<<<blocks, s.warps * kLanes, s.bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(iters), static_cast<const float*>(scal),
        static_cast<const float*>(warm), static_cast<const float*>(tx),
        static_cast<const float*>(ty), static_cast<const float*>(obinfo),
        static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(th),
        static_cast<float*>(v), static_cast<float*>(w), static_cast<float*>(diag), p);
    *width = s.width;
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch a (B, N, K, elastic, affine) solve takes on the current card:
// out = {width (warps per scenario), warps per block, scenarios per block,
// dynamic shared bytes per block, resident blocks per SM, registers per
// thread, local (spill) bytes per thread}.  Returns a cudaError_t.
extern "C" int kissmpc_ipm_fused_occupancy(int B, int N, int K, int elastic, int affine,
                                           int* out) {
  const bool el = elastic && K > 0;
  Launch s;
  cudaError_t err = prepare(B, N, K, el, affine != 0, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, s.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = s.width;
  out[1] = s.warps;
  out[2] = s.width == 1 ? s.warps : 1;
  out[3] = static_cast<int>(s.bytes);
  out[4] = s.resident;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// The longest horizon whose iterate fits in a block of one warp on sm_90,
// for K obstacles, the elastic branch and affine tracks (the last two 0 or
// 1).  Host arithmetic only: no CUDA call.
extern "C" int kissmpc_ipm_fused_max_horizon(int K, int elastic, int affine) {
  const bool el = elastic && K > 0;
  int N = 0;
  while (smem_bytes(N + 1, K, el, affine != 0, 1) <= kSmemOptin) ++N;
  return N;
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
