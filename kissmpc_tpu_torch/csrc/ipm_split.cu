// The split IPM solve around the Riccati kernel, for Hopper (sm_90a): the
// init kernel, per iteration the condensation kernel before the Newton-KKT
// solve and the step kernel after it, and the diagnostics kernel.
//
// Replaces: no TPU kernel.  The reference compiles its split IPM under
// jax.jit, and XLA fuses the loop body of kissmpc_tpu/solver/ipm.py:407
// (`_iteration`: `_build_lqr` at :328, the Riccati solve, the steps, the
// fraction to the boundary, the penalty weight's adjoint sweep, the merit
// line search and the update) into a few kernels per iteration, and the
// init (`_init_state` at :180 and the first mu) and the diagnostics
// (`_adaptive_mu` at :817, `_diagnostics` at :715 with its adjoint scan)
// into a few more per solve.  These four kernels are the port's
// counterpart of that fusion: a solve is the init kernel, per iteration
// the condensation kernel, csrc/riccati.cu and the step kernel, then the
// diagnostics kernel.  Contract: `init_plain`, the plain halves
// `condense_plain` and `step_plain`, and `diagnostics_plain` of
// kissmpc_tpu_torch/solver/ipm.py, which each kernel follows step by step.
// They follow solver/ipm.py, not csrc/ipm_fused.cu: the merit is evaluated
// anew at alpha = 0, box consistency is evaluated along the step, and the
// floors follow the dtype (1e-10 / 1e-14; sigma at most 1e12 / 1e18; the
// Newton regime below a step of 1e-2 / 1e-4).
//
// condense_kernel: one thread per (scenario, stage t = 0..N), a block of
// 128 consecutive stages.  Stage t's state row (box families xl, xu and,
// for t >= 1, the K obstacle constraints on state t, hard or elastic, with
// the Gauss-Newton term and the damped curvature term), its control row
// (t < N: box families cl, cu, the cost's gradient and Hessian, the
// unicycle linearisation and defect) and, at t = 0, the pin residual d0.
// The block's obstacle rows (s_ob, nu_ob, e_ob: one contiguous span) are
// copied into shared memory (cp.async) while the box families are
// condensed; its output rows go out through shared memory, so each store
// instruction of a warp covers one contiguous span of the eight LQRData
// tensors, in the layout that csrc/riccati.cu reads.
//
// step_kernel: one block per scenario, of 1 to 4 warps (the launch's
// `warps`, from ops/ipm_split.py::step_warps).  (0) The scenario's rows
// (trajectory, step, slacks, duals, e, the correction rows, the centers,
// qx and A) are copied once into an arena by cp.async, 16 bytes at a time
// where source and arena share their alignment: dynamic shared memory, or
// a global scratch where the arena does not fit in the card's 227 KB (the
// GLOBAL instance, long horizons).  (1) Each thread takes elements (box
// entries of each family, then obstacle constraints) and computes each
// one's slack, dual and elastic steps once, into the arena in double, with
// the fractions to the boundary, the largest dual and the step's norm.
// (2) Thread 0 runs the penalty weight's N-step adjoint sweep of (qx, A)
// while the other threads take, candidate by candidate, (stage or element,
// candidate) and sum the objective less mu times the log barrier, and the
// l1 residuals, of the merit at alpha = 0 and at every line-search
// candidate; rho enters only where those sums are combined.  (3) The
// acceptance, then the update with the dual clamp and the new mean
// complementarity.  Passes 1 and 3 reduce by a butterfly of shuffles within
// a warp, then the warps' partials in warp order; pass 2 keeps each
// thread's sums in shared memory and adds them in thread order; so every
// thread holds the same bits.
//
// init_kernel: one block of kOnceWarps warps per scenario, so that a
// refine stage's grid covers the card; the threads take each family's
// entries by flat index, so every store of a warp covers consecutive
// values.  It reads the warm start and writes the slacks, duals and e of
// every entry: bytes-bound.
//
// diagnostics_kernel: one block of kOnceWarps warps per scenario, as the
// init.  The stages go from N down in chunks of `diag_chunk` stages, so
// that its shared memory follows the chunk and K, whatever N: the threads
// take the chunk's entries (obstacle constraints, box entries) by one flat
// index, then one thread per stage finishes its rows, and the adjoint
// sweep runs as block suffix scans over the chunk, with the carry from the
// chunk above.  It reads the iterate once and writes a few values per
// scenario: bytes-bound in principle; in practice each scenario's chain
// of loads, barriers and scans of log2 depth, over the scenarios resident
// on an SM, sets its time.
//
// What bounds them: by bytes, device memory at the batches of the
// benchmark (a few hundred bytes per element; the card's balance is ~10
// double operations per byte).  In practice the latency of one scenario's
// chain of dependent double operations, at every batch: the several warps
// per scenario shorten it, and the launch bounds keep registers low enough
// for 5 resident blocks of 4 warps per SM in the hard step instances (96
// registers) and 5 blocks of 128 threads in the condensation.
//
// Templated on the data type D (float, double) and on the elastic branch.
// Both compute in double and round what they store, with the floors of D:
// near an active constraint the condensed gradient and the dual step
// multiply a slack gap of a few ulps by sigma = nu/s (up to 1e12 in
// float32), which float arithmetic does not carry.  The float32 step
// instance evaluates in float only the merit's transcendentals of float32
// data, as step_plain does (`Trans`): the log of a trial slack and the
// trial point's obstacle distance.  sin and cos are this file's own
// (`sincos_rd`, csrc/device_math.cuh, in double for both).  K (0 included), N, ls_iters
// (1..kMaxLs), the cost modes and the curvature term are runtime
// parameters, and the Mehrotra correction rows are nullable pointers (all
// five, or none).  Compiled without fast math: max, min and clip propagate
// NaN, as torch's do (maxp, minp, clipp).  No per-family array is indexed
// at run time: the kernels keep no stack frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "device_math.cuh"

// The launchers' argument structs (outside the anonymous namespace, so the
// extern "C" launchers that take them are exported).

// Mirror of `_Params` in ops/ipm_split.py (ints first, then doubles).
struct SplitParams {
  int B, N, K, ls_iters, warps;
  int exclude_terminal, reverse_squared, curvature, elastic, adaptive_sigma, raw_mu;
  double dt, tau, ls_backtrack, merit_penalty, reg, rho_e;
  double w0, w1, w2, w_neg, w_pos, w_ang;
  double mu_init, mu_floor, mu_sigma, sigma_cap;
  double kkt_tol, comp_tol;  // the diagnostics' thresholds, the dtype's floor applied
};

// The Problem's first ten leaves, in its field order.
struct ProblemPtrs {
  const void *x0, *goal, *cl, *cu, *xl, *xu, *centers, *radii, *omask, *infl;
};

// IPMState's leaves, in its field order.
struct IteratePtrs {
  void *states, *controls, *s_cl, *s_cu, *s_xl, *s_xu, *s_ob;
  void *nu_cl, *nu_cu, *nu_xl, *nu_xu, *nu_ob, *e_ob, *reg, *sigma;
};

// LQRData's leaves, in its field order.
struct LqrPtrs {
  void *A, *B, *d, *d0, *Qxx, *qx, *Quu, *qu;
};

// The Mehrotra correction ds_aff * dnu_aff per family, or all null.
struct CorrPtrs {
  const void *cl, *cu, *xl, *xu, *ob;
};

// Diagnostics' leaves, in its field order (converged is bool, one byte).
struct DiagPtrs {
  void *converged, *stationarity, *feasibility, *complementarity, *final_cost, *final_mu;
};

// The step's outputs besides the iterate: the next mu and the step length;
// the merits at alpha = 0 and at each candidate ([B, 1 + ls_iters]) and
// rho ([B]), both null on the main path (the gates ask for them); the
// global arena (null unless the arena does not fit in shared memory).
struct StepOut {
  void *mu, *alpha, *merit, *rho, *scratch;
};

namespace {

constexpr int kMaxWarps = 4;           // warps per scenario of the step kernel at most
constexpr int kCondenseThreads = 128;  // stages per block of the condensation
constexpr int kMaxLs = 8;              // line-search candidates at most
constexpr int kMaxCand = kMaxLs + 1;   // with alpha = 0
constexpr long long kSmemOptin = 232448;  // sm_90's opt-in shared memory per block

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static constexpr double floor() { return 1e-10f; }
  __device__ static constexpr double sigma_max() { return 1e12f; }
  __device__ static constexpr double newton() { return 1e-2f; }
  __device__ static constexpr double eps() { return 1.1920928955078125e-07; }
};
template <> struct Num<double> {
  __device__ static constexpr double floor() { return 1e-14; }
  __device__ static constexpr double sigma_max() { return 1e18; }
  __device__ static constexpr double newton() { return 1e-4; }
  __device__ static constexpr double eps() { return 2.220446049250313e-16; }
  __device__ static constexpr double big() { return 1.7976931348623157e308; }
};

// The merit's transcendentals of data type D: in float for float32 data
// (as exact as step_plain's own float32 evaluation), in double for
// float64.
template <typename D> struct Trans;
template <> struct Trans<float> {
  __device__ static double log(double x) { return logf(static_cast<float>(x)); }
  __device__ static double sqrt(double x) { return sqrtf(static_cast<float>(x)); }
};
template <> struct Trans<double> {
  __device__ static double log(double x) { return ::log(x); }
  __device__ static double sqrt(double x) { return ::sqrt(x); }
};

// A bound entry: its value with +-inf read as 0, and its finiteness mask.
struct Bound {
  double val, mask;
};
__device__ __forceinline__ Bound bound(double b) {
  const bool f = isfin(b);
  return {f ? b : 0.0, f ? 1.0 : 0.0};
}
// A box constraint value; masked entries read 1.
__device__ __forceinline__ double masked(double c, double mask) { return mask > 0.0 ? c : 1.0; }

// One obstacle constraint on a point: value (1 where masked), unit normal
// by the distance floored at 1e-2, that floored distance, and the mask.
struct Ob {
  double c, nx, ny, dist, mask;
};
__device__ __forceinline__ Ob obstacle(double px, double py, double cx, double cy, double rad,
                                       double infl, double om) {
  const double dx = px - cx, dy = py - cy;
  const double dist = sqrt(dx * dx + dy * dy + 1e-16);
  const double mask = om > 0.5 ? 1.0 : 0.0;
  const double ds = maxp(dist, 1e-2);
  return {masked(dist - rad - infl, mask), dx / ds, dy / ds, ds, mask};
}

// The floors of the data's dtype (solver/ipm.py::_floor, _sigma_max).
struct Floors {
  double fl, smax;
};

__device__ __forceinline__ double sigma_of(double nu, double s, double mask, Floors f) {
  return clipp(mask * nu / maxp(s, f.fl), 0.0, f.smax);
}

// Hard slack and dual step: ds = J dz + (c - s), dnu = num/s - nu - sigma ds
// (s floored; one reciprocal of it for both quotients).
__device__ __forceinline__ void box_step(double c, double s, double nu, double mask, double jdz,
                                         double num, Floors f, double& ds, double& dnu) {
  const double r = 1.0 / maxp(s, f.fl);
  ds = mask * (jdz + c - s);
  dnu = mask * (num * r - nu - clipp(mask * nu * r, 0.0, f.smax) * ds);
}

// solver/ipm.py::elastic_coef.
struct Elastic {
  double g, Tt, r_e, r_c, sig_s, sig_e, sig_eff;
};
__device__ __forceinline__ Elastic elastic_coef(double c, double s, double nu, double e,
                                                double mask, double mu, double rho_e, Floors f) {
  const double fl = f.fl, smax = f.smax;
  const double s_safe = maxp(s, fl), e_safe = maxp(e, fl);
  Elastic el;
  el.sig_s = clipp(mask * nu / s_safe, 0.0, smax);
  el.sig_e = clipp(mu / (e_safe * e_safe), 0.0, smax);
  el.sig_eff = mask * el.sig_s * el.sig_e / maxp(el.sig_s + el.sig_e, fl);
  el.Tt = mu / s_safe - nu;
  el.r_e = rho_e - mu / e_safe - nu;
  el.r_c = c + e - s;
  el.g = mask * (nu - el.sig_eff * el.r_c +
                 el.sig_eff * (el.Tt / maxp(el.sig_s, fl) + el.r_e / el.sig_e));
  return el;
}

// solver/ipm.py::elastic_step: the eliminated (ds, de, dnu).
__device__ __forceinline__ void elastic_step(const Elastic& el, double mask, double jdz, Floors f,
                                             double& ds, double& de, double& dnu) {
  const double beta = el.sig_e / maxp(el.sig_s + el.sig_e, f.fl);
  ds = mask * beta * (jdz + el.r_c + (el.Tt - el.r_e) / el.sig_e);
  de = mask * (el.Tt - el.r_e - el.sig_s * ds) / el.sig_e;
  dnu = mask * (el.Tt - el.sig_s * ds);
}

// The goal cost's row mask: states 1..N ("full") or 1..N-1.
__device__ __forceinline__ bool goal_row(int t, int N, int exclude_terminal) {
  return t >= 1 && (!exclude_terminal || t <= N - 1);
}

// The block's threads copy n values to global memory: consecutive threads
// store consecutive values.
template <typename D>
__device__ __forceinline__ void store_rows(D* dst, const D* src, long long n, int tid, int nthr) {
  for (long long i = tid; i < n; i += nthr) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// The condensation.

// Values per stage row in the condensation's shared memory: its obstacle
// rows (s_ob, nu_ob, and e_ob when elastic or the Mehrotra correction when
// given: 2 or 3 K), then its outputs (the state row's Qxx 9 and qx 3, the
// control row's Quu 4, qu 2, A 9, B 6, d 3).
__host__ __device__ inline int condense_row_values(int K, bool third) {
  return (third ? 3 : 2) * K + 36;
}

template <typename D, bool EL>
__global__ void __launch_bounds__(kCondenseThreads, 5)
condense_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
                const D* __restrict__ mu_in, const CorrPtrs corr, const LqrPtrs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, K = p.K, T1 = N + 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long rows = static_cast<long long>(p.B) * T1;
  const long long g0 = static_cast<long long>(blockIdx.x) * nthr;
  const long long gid = g0 + tid;
  const long long glast = (g0 + nthr < rows ? g0 + nthr : rows) - 1;
  const long long nrows = glast - g0 + 1;
  const bool active = gid < rows;
  const int b = active ? static_cast<int>(gid / T1) : 0;
  const int t = active ? static_cast<int>(gid % T1) : 0;
  const bool has_corr = corr.cl != nullptr;
  const Floors f{Num<D>::floor(), Num<D>::sigma_max()};

  // The block's obstacle rows: row (b, t >= 1) is b * N + t - 1 = gid - b - 1,
  // non-decreasing in gid, so the block's rows are one span [o_lo, o_hi],
  // copied while the control row and the box families are condensed.
  const long long o_lo0 = g0 - g0 / T1 - 1;
  const long long o_lo = o_lo0 > 0 ? o_lo0 : 0;
  const long long o_hi = glast - glast / T1 - 1;
  const long long no = K > 0 && o_hi >= o_lo ? (o_hi - o_lo + 1) * K : 0;
  D* const sob = reinterpret_cast<D*>(smem);
  D* const nob = sob + static_cast<long long>(nthr) * K;
  D* const eob = nob + static_cast<long long>(nthr) * K;  // e_ob, or the correction
  stage<true>(sob, at<D>(it.s_ob, o_lo * K), no, tid, nthr);
  stage<true>(nob, at<D>(it.nu_ob, o_lo * K), no, tid, nthr);
  if (EL)
    stage<true>(eob, at<D>(it.e_ob, o_lo * K), no, tid, nthr);
  else if (has_corr)
    stage<true>(eob, at<D>(corr.ob, o_lo * K), no, tid, nthr);
  // The outputs, each written to shared memory as soon as it is known: the
  // state rows [g0, glast] (Qxx, qx), then the control rows, b * N + t =
  // gid - b for t < N, one span [c_lo, c_hi] (a block's last stage t = N
  // has none): Quu, qu, A, B, d.
  D* const qxx = sob + static_cast<long long>(nthr) * (EL || has_corr ? 3 : 2) * K;
  D* const qxv = qxx + nrows * 9;
  const long long c_lo = g0 - g0 / T1;
  const long long c_hi = glast - glast / T1 - (glast % T1 == N ? 1 : 0);
  const long long nc = c_hi >= c_lo ? c_hi - c_lo + 1 : 0;
  D* const crow = qxx + nrows * 12;

  const D* X = at<D>(it.states, static_cast<long long>(b) * T1 * 3);
  const double mu = mu_in[b];
  const double shift = p.reg + static_cast<double>(*at<D>(it.reg, b));

  // Control row t: cost, box families cl, cu, linearisation and defect.
  if (active && t < N) {
    const long long urow = (static_cast<long long>(b) * N + t) * 2;
    const long long lc = gid - b - c_lo;
    const D* U = at<D>(it.controls, urow);
    const double v = U[0], om = U[1];
    double gu0, Hu0;
    if (p.reverse_squared) {
      gu0 = 2.0 * p.w_neg * minp(v, 0.0);
      Hu0 = 2.0 * p.w_neg * (v < 0.0 ? 1.0 : 0.0);
    } else {
      gu0 = p.w_neg * (v < 0.0 ? 1.0 : 0.0);
      Hu0 = 0.0;
    }
    gu0 = gu0 + 2.0 * p.w_pos * maxp(v, 0.0);
    Hu0 = Hu0 + 2.0 * p.w_pos * (v > 0.0 ? 1.0 : 0.0);
    D* quu = crow + lc * 4;
    D* qu = crow + nc * 4 + lc * 2;
    quu[1] = 0.0;
    quu[2] = 0.0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Bound lo = bound(*at<D>(pr.cl, b * 2 + j));
      const Bound hi = bound(*at<D>(pr.cu, b * 2 + j));
      const double u = U[j];
      const double c_lo_ = masked(u - lo.val, lo.mask), c_hi_ = masked(hi.val - u, hi.mask);
      const double s_lo = *at<D>(it.s_cl, urow + j), s_hi = *at<D>(it.s_cu, urow + j);
      const double nu_lo = *at<D>(it.nu_cl, urow + j), nu_hi = *at<D>(it.nu_cu, urow + j);
      const double num_lo = has_corr ? mu - static_cast<double>(*at<D>(corr.cl, urow + j)) : mu;
      const double num_hi = has_corr ? mu - static_cast<double>(*at<D>(corr.cu, urow + j)) : mu;
      const double sig_lo = sigma_of(nu_lo, s_lo, lo.mask, f);
      const double sig_hi = sigma_of(nu_hi, s_hi, hi.mask, f);
      const double g_lo = lo.mask * (num_lo / maxp(s_lo, f.fl) - sig_lo * (c_lo_ - s_lo));
      const double g_hi = hi.mask * (num_hi / maxp(s_hi, f.fl) - sig_hi * (c_hi_ - s_hi));
      qu[j] = (j == 0 ? gu0 : 2.0 * p.w_ang * om) - g_lo + g_hi;
      quu[j * 3] = (j == 0 ? Hu0 : 2.0 * p.w_ang) + sig_lo + sig_hi + shift;
    }
    const double dt = p.dt;
    const double th = X[t * 3 + 2];
    double sth, cth;
    sincos_rd(th, sth, cth);
    D* a = crow + nc * 6 + lc * 9;
    a[0] = 1.0;
    a[1] = 0.0;
    a[2] = -v * sth * dt;
    a[3] = 0.0;
    a[4] = 1.0;
    a[5] = v * cth * dt;
    a[6] = 0.0;
    a[7] = 0.0;
    a[8] = 1.0;
    D* bm = crow + nc * 15 + lc * 6;
    bm[0] = cth * dt;
    bm[1] = 0.0;
    bm[2] = sth * dt;
    bm[3] = 0.0;
    bm[4] = 0.0;
    bm[5] = dt;
    D* d = crow + nc * 21 + lc * 3;
    const D* X1 = X + (t + 1) * 3;
    d[0] = X[t * 3] + v * cth * dt - X1[0];
    d[1] = X[t * 3 + 1] + v * sth * dt - X1[1];
    d[2] = th + om * dt - X1[2];
  }

  // State row t: cost and box families xl, xu; the obstacles on state t
  // below add to its first two entries.  Qxx is diagonal until then.
  D* const q = qxx + (gid - g0) * 9;
  D* const g = qxv + (gid - g0) * 3;
  if (active) {
    const D* goal = at<D>(pr.goal, b * 3);
    const double gm = goal_row(t, N, p.exclude_terminal) ? 1.0 : 0.0;
    const long long xrow = (static_cast<long long>(b) * T1 + t) * 3;
    const double w[3] = {p.w0, p.w1, p.w2};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double x = X[t * 3 + i];
      const Bound lo = bound(*at<D>(pr.xl, b * 3 + i));
      const Bound hi = bound(*at<D>(pr.xu, b * 3 + i));
      const double c_lo_ = masked(x - lo.val, lo.mask), c_hi_ = masked(hi.val - x, hi.mask);
      const double s_lo = *at<D>(it.s_xl, xrow + i), s_hi = *at<D>(it.s_xu, xrow + i);
      const double nu_lo = *at<D>(it.nu_xl, xrow + i), nu_hi = *at<D>(it.nu_xu, xrow + i);
      const double num_lo = has_corr ? mu - static_cast<double>(*at<D>(corr.xl, xrow + i)) : mu;
      const double num_hi = has_corr ? mu - static_cast<double>(*at<D>(corr.xu, xrow + i)) : mu;
      const double sig_lo = sigma_of(nu_lo, s_lo, lo.mask, f);
      const double sig_hi = sigma_of(nu_hi, s_hi, hi.mask, f);
      const double g_lo = lo.mask * (num_lo / maxp(s_lo, f.fl) - sig_lo * (c_lo_ - s_lo));
      const double g_hi = hi.mask * (num_hi / maxp(s_hi, f.fl) - sig_hi * (c_hi_ - s_hi));
      g[i] = 2.0 * gm * w[i] * (x - goal[i]) - g_lo + g_hi;
#pragma unroll
      for (int j = 0; j < 3; ++j) q[i * 3 + j] = i == j ? 2.0 * gm * w[i] + sig_lo + sig_hi : 0.0;
    }
    if (t == 0) {
      const D* x0 = at<D>(pr.x0, b * 3);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        put<D>(out.d0, b * 3 + i)[0] = static_cast<double>(x0[i]) - X[i];
    }
  }
  copies_done();
  __syncthreads();  // the obstacle rows are in
  if (K > 0 && t >= 1 && active) {
    const int r = t - 1;  // obstacle row r covers state r + 1
    const long long orow = (static_cast<long long>(b) * N + r - o_lo) * K;
    const double px = X[t * 3], py = X[t * 3 + 1];
    const double infl = *at<D>(pr.infl, b);
    double g0x = 0.0, g0y = 0.0, H00 = 0.0, H01 = 0.0, H11 = 0.0;
    double wsum = 0.0, C00 = 0.0, C01 = 0.0, C11 = 0.0;
    for (int k = 0; k < K; ++k) {
      const D* ctr = at<D>(pr.centers, ((static_cast<long long>(b) * K + k) * N + r) * 2);
      const Ob o = obstacle(px, py, ctr[0], ctr[1], *at<D>(pr.radii, b * K + k), infl,
                            *at<D>(pr.omask, b * K + k));
      const double s = sob[orow + k], nu = nob[orow + k];
      double gk, sig;
      if (EL) {
        const Elastic el = elastic_coef(o.c, s, nu, eob[orow + k], o.mask, mu, p.rho_e, f);
        gk = el.g;
        sig = el.sig_eff;
      } else {
        const double num = has_corr ? mu - static_cast<double>(eob[orow + k]) : mu;
        sig = sigma_of(nu, s, o.mask, f);
        gk = o.mask * (num / maxp(s, f.fl) - sig * (o.c - s));
      }
      g0x += o.nx * gk;
      g0y += o.ny * gk;
      H00 += sig * o.nx * o.nx;
      H01 += sig * o.nx * o.ny;
      H11 += sig * o.ny * o.ny;
      if (p.curvature) {
        double wk = -o.mask * nu / maxp(o.dist, 1e-6);
        wk = maxp(wk, -0.9 * sig);
        wsum += wk;
        C00 += wk * o.nx * o.nx;
        C01 += wk * o.nx * o.ny;
        C11 += wk * o.ny * o.ny;
      }
    }
    if (p.curvature) {
      H00 = H00 + (wsum - C00);
      H01 = H01 + (wsum * 0.0 - C01);
      H11 = H11 + (wsum - C11);
    }
    // qx and Qxx were stored after the box families, rounded to D where the
    // plain half rounds them; the obstacles' terms go onto those values.
    g[0] = static_cast<double>(g[0]) - g0x;
    g[1] = static_cast<double>(g[1]) - g0y;
    q[0] = static_cast<double>(q[0]) + H00;
    q[1] = static_cast<double>(q[1]) + H01;
    q[3] = static_cast<double>(q[3]) + H01;
    q[4] = static_cast<double>(q[4]) + H11;
  }
  if (active) {
    q[0] = static_cast<double>(q[0]) + shift;
    q[4] = static_cast<double>(q[4]) + shift;
    q[8] = static_cast<double>(q[8]) + shift;
  }
  __syncthreads();  // every row is in; each store below covers one span
  store_rows(put<D>(out.Qxx, g0 * 9), qxx, nrows * 9, tid, nthr);
  store_rows(put<D>(out.qx, g0 * 3), qxv, nrows * 3, tid, nthr);
  store_rows(put<D>(out.Quu, c_lo * 4), crow, nc * 4, tid, nthr);
  store_rows(put<D>(out.qu, c_lo * 2), crow + nc * 4, nc * 2, tid, nthr);
  store_rows(put<D>(out.A, c_lo * 9), crow + nc * 6, nc * 9, tid, nthr);
  store_rows(put<D>(out.B, c_lo * 6), crow + nc * 15, nc * 6, tid, nthr);
  store_rows(put<D>(out.d, c_lo * 3), crow + nc * 21, nc * 3, tid, nthr);
}

// ---------------------------------------------------------------------------
// The step.

// One scenario's arena: byte offsets of its rows.  Doubles first (the
// steps ds, dnu of every element and de of the obstacles when elastic),
// then rows of the data type: X, dX, U, dU, the slacks and duals of every
// element (families cl, cu, xl, xu, ob in that order, each as its global
// row), e (elastic), the correction rows (when given), the centers, radii,
// mask, A and qx.
struct StepLayout {
  int nel, nbox;
  long long ds, dnu, de, X, dX, U, dU, s, nu, e, k, ctr, rad, om, A, q, bytes;
};

__host__ __device__ inline StepLayout step_layout(int N, int K, bool el, bool corr, int eb) {
  StepLayout L;
  const int T1 = N + 1;
  L.nbox = 4 * N + 6 * T1;
  L.nel = L.nbox + N * K;
  long long o = 0;
  auto take = [&o](long long n, int size) {  // each row from a 16-byte boundary
    const long long at = (o + 15) / 16 * 16;
    o = at + n * size;
    return at;
  };
  L.ds = take(L.nel, 8);
  L.dnu = take(L.nel, 8);
  L.de = take(el ? N * K : 0, 8);
  L.X = take(3 * T1, eb);
  L.dX = take(3 * T1, eb);
  L.U = take(2 * N, eb);
  L.dU = take(2 * N, eb);
  L.s = take(L.nel, eb);
  L.nu = take(L.nel, eb);
  L.e = take(el ? N * K : 0, eb);
  L.k = take(corr ? L.nel : 0, eb);
  L.ctr = take(2LL * K * N, eb);
  L.rad = take(K, eb);
  L.om = take(K, eb);
  L.A = take(9 * N, eb);
  L.q = take(3 * T1, eb);
  L.bytes = (o + 15) / 16 * 16;
  return L;
}

// The block's own shared memory ahead of the arena, in doubles: the
// scenario's scalars and the merits' two sums per candidate, then per warp
// the partials of pass 1 (4) and pass 3 (2), then per thread its two sums
// of pass 2 per candidate.
enum Scalar {
  kLoX = 0, kMloX = 3, kHiX = 6, kMhiX = 9,  // state bounds: values and masks
  kLoU = 12, kMloU = 14, kHiU = 16, kMhiU = 18,  // control bounds
  kX0 = 20, kGoal = 23, kMu = 26, kInfl = 27, kLam = 28,
  kLadder = 29,  // ls_backtrack^j, j < kMaxLs
  kSums = kLadder + kMaxLs,  // the merits' sums P, R of candidate c at 2c, 2c + 1
  kScalars = kSums + 2 * kMaxCand
};
constexpr int kPartials = 4 + 2;
__host__ __device__ inline long long step_red_bytes(int warps, int ls_iters) {
  const int threads = warps * kLanes;
  return (static_cast<long long>(kScalars + warps * kPartials + 2 * (1 + ls_iters) * threads) *
              8 + 15) / 16 * 16;
}

// Box element e < nbox (families cl, cu on controls, xl, xu on states):
// whether it is a state entry, an upper bound, its index in the family's
// row and its component.
struct BoxElem {
  bool state, upper;
  int idx, comp;
};
__device__ __forceinline__ BoxElem box_elem(int e, int N, int T1) {
  BoxElem x;
  if (e < 4 * N) {
    x.state = false;
    x.upper = e >= 2 * N;
    x.idx = x.upper ? e - 2 * N : e;
    x.comp = x.idx & 1;
  } else {
    const int i = e - 4 * N;
    x.state = true;
    x.upper = i >= 3 * T1;
    x.idx = x.upper ? i - 3 * T1 : i;
    x.comp = x.idx % 3;
  }
  return x;
}

// The bound a box element reads (values and masks in the scalars).
__device__ __forceinline__ void box_bound(const double* sc, const BoxElem& x, double& val,
                                          double& mask) {
  const int i = x.comp;
  if (x.state) {
    val = x.upper ? sc[kHiX + i] : sc[kLoX + i];
    mask = x.upper ? sc[kMhiX + i] : sc[kMloX + i];
  } else {
    val = x.upper ? sc[kHiU + i] : sc[kLoU + i];
    mask = x.upper ? sc[kMhiU + i] : sc[kMloU + i];
  }
}

// Family array of a box element, in the iterate's field order.
__device__ __forceinline__ void* box_row(const IteratePtrs& v, const BoxElem& x, bool dual) {
  if (x.state) return dual ? (x.upper ? v.nu_xu : v.nu_xl) : (x.upper ? v.s_xu : v.s_xl);
  return dual ? (x.upper ? v.nu_cu : v.nu_cl) : (x.upper ? v.s_cu : v.s_cl);
}

// Fraction-to-boundary ratio of one element (1 where the step does not
// decrease it).
__device__ __forceinline__ double ftb(double v, double dv, double tau) {
  return dv < 0.0 ? -tau * v / minp(dv, -1e-30) : 1.0;
}

template <typename D, bool EL, bool GLOBAL>
__global__ void __launch_bounds__(kMaxWarps * kLanes, EL || GLOBAL ? 3 : 5)
step_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
            const D* __restrict__ mu_in, const D* __restrict__ qx, const D* __restrict__ Amat,
            const D* __restrict__ dx, const D* __restrict__ du, const CorrPtrs corr,
            const IteratePtrs out, const StepOut so) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Phase clocks start here.
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid % kLanes, warp = tid / kLanes;
  const int nwarps = nthr / kLanes;
  const int N = p.N, K = p.K, T1 = N + 1;
  const bool has_corr = corr.cl != nullptr;
  const StepLayout L = step_layout(N, K, EL, has_corr, sizeof(D));
  const int nel = L.nel, nbox = L.nbox;
  double* const sc = reinterpret_cast<double*>(smem);
  double* const part1 = sc + kScalars;
  double* const part3 = part1 + 4 * nwarps;
  double* const part2 = part3 + 2 * nwarps;  // [2 * candidates][threads]
  unsigned char* const arena =
      GLOBAL ? static_cast<unsigned char*>(so.scratch) + static_cast<long long>(b) * L.bytes
             : smem + step_red_bytes(nwarps, p.ls_iters);
  double* const DS = reinterpret_cast<double*>(arena + L.ds);
  double* const DNU = reinterpret_cast<double*>(arena + L.dnu);
  double* const DE = reinterpret_cast<double*>(arena + L.de);
  D* const X = reinterpret_cast<D*>(arena + L.X);
  D* const dX = reinterpret_cast<D*>(arena + L.dX);
  D* const U = reinterpret_cast<D*>(arena + L.U);
  D* const dU = reinterpret_cast<D*>(arena + L.dU);
  D* const S = reinterpret_cast<D*>(arena + L.s);
  D* const NU = reinterpret_cast<D*>(arena + L.nu);
  D* const E = reinterpret_cast<D*>(arena + L.e);
  D* const KC = reinterpret_cast<D*>(arena + L.k);
  D* const CTR = reinterpret_cast<D*>(arena + L.ctr);
  D* const RAD = reinterpret_cast<D*>(arena + L.rad);
  D* const OM = reinterpret_cast<D*>(arena + L.om);
  D* const AM = reinterpret_cast<D*>(arena + L.A);
  D* const Q = reinterpret_cast<D*>(arena + L.q);
  const long long xs = static_cast<long long>(b) * T1 * 3;
  const long long us = static_cast<long long>(b) * N * 2;
  const long long os = static_cast<long long>(b) * N * K;
  const Floors f{Num<D>::floor(), Num<D>::sigma_max()};

  // Pass 0: the scenario's rows into the arena, its scalars into the block.
  stage<!GLOBAL>(X, at<D>(it.states, xs), 3 * T1, tid, nthr);
  stage<!GLOBAL>(dX, dx + xs, 3 * T1, tid, nthr);
  stage<!GLOBAL>(U, at<D>(it.controls, us), 2 * N, tid, nthr);
  stage<!GLOBAL>(dU, du + us, 2 * N, tid, nthr);
  {
    const long long seg[5] = {0, 2 * N, 4 * N, 4 * N + 3 * T1, nbox};
    stage<!GLOBAL>(S + seg[0], at<D>(it.s_cl, us), 2 * N, tid, nthr);
    stage<!GLOBAL>(S + seg[1], at<D>(it.s_cu, us), 2 * N, tid, nthr);
    stage<!GLOBAL>(S + seg[2], at<D>(it.s_xl, xs), 3 * T1, tid, nthr);
    stage<!GLOBAL>(S + seg[3], at<D>(it.s_xu, xs), 3 * T1, tid, nthr);
    stage<!GLOBAL>(S + seg[4], at<D>(it.s_ob, os), N * K, tid, nthr);
    stage<!GLOBAL>(NU + seg[0], at<D>(it.nu_cl, us), 2 * N, tid, nthr);
    stage<!GLOBAL>(NU + seg[1], at<D>(it.nu_cu, us), 2 * N, tid, nthr);
    stage<!GLOBAL>(NU + seg[2], at<D>(it.nu_xl, xs), 3 * T1, tid, nthr);
    stage<!GLOBAL>(NU + seg[3], at<D>(it.nu_xu, xs), 3 * T1, tid, nthr);
    stage<!GLOBAL>(NU + seg[4], at<D>(it.nu_ob, os), N * K, tid, nthr);
    if (has_corr) {
      stage<!GLOBAL>(KC + seg[0], at<D>(corr.cl, us), 2 * N, tid, nthr);
      stage<!GLOBAL>(KC + seg[1], at<D>(corr.cu, us), 2 * N, tid, nthr);
      stage<!GLOBAL>(KC + seg[2], at<D>(corr.xl, xs), 3 * T1, tid, nthr);
      stage<!GLOBAL>(KC + seg[3], at<D>(corr.xu, xs), 3 * T1, tid, nthr);
      stage<!GLOBAL>(KC + seg[4], at<D>(corr.ob, os), N * K, tid, nthr);
    }
  }
  if (EL) stage<!GLOBAL>(E, at<D>(it.e_ob, os), N * K, tid, nthr);
  stage<!GLOBAL>(CTR, at<D>(pr.centers, os * 2), 2LL * N * K, tid, nthr);
  stage<!GLOBAL>(RAD, at<D>(pr.radii, static_cast<long long>(b) * K), K, tid, nthr);
  stage<!GLOBAL>(OM, at<D>(pr.omask, static_cast<long long>(b) * K), K, tid, nthr);
  stage<!GLOBAL>(AM, Amat + static_cast<long long>(b) * N * 9, 9 * N, tid, nthr);
  stage<!GLOBAL>(Q, qx + xs, 3 * T1, tid, nthr);
  if (tid < 3) {
    const Bound lo = bound(*at<D>(pr.xl, b * 3 + tid)), hi = bound(*at<D>(pr.xu, b * 3 + tid));
    sc[kLoX + tid] = lo.val;
    sc[kMloX + tid] = lo.mask;
    sc[kHiX + tid] = hi.val;
    sc[kMhiX + tid] = hi.mask;
    sc[kX0 + tid] = *at<D>(pr.x0, b * 3 + tid);
    sc[kGoal + tid] = *at<D>(pr.goal, b * 3 + tid);
  } else if (tid < 5) {
    const int j = tid - 3;
    const Bound lo = bound(*at<D>(pr.cl, b * 2 + j)), hi = bound(*at<D>(pr.cu, b * 2 + j));
    sc[kLoU + j] = lo.val;
    sc[kMloU + j] = lo.mask;
    sc[kHiU + j] = hi.val;
    sc[kMhiU + j] = hi.mask;
  } else if (tid == 5) {
    sc[kMu] = mu_in[b];
    sc[kInfl] = *at<D>(pr.infl, b);
  } else if (tid >= kLanes - kMaxLs) {
    const int j = tid - (kLanes - kMaxLs);
    sc[kLadder + j] = pow(p.ls_backtrack, static_cast<double>(j));
  }
  copies_done();
  __syncthreads();
  // Phase clocks: loads.

  // Pass 1: each element's steps into the arena; the fractions to the
  // boundary, the largest dual, the step's norm.
  const double mu = sc[kMu], infl = sc[kInfl], tau = p.tau, rho_e = p.rho_e;
  double a_s = 1.0, a_nu = 1.0, nu_max = 0.0, step_inf = 0.0;
  for (int i = tid; i < 3 * T1 + 2 * N; i += nthr)
    step_inf = maxp(step_inf, fabs(static_cast<double>(i < 3 * T1 ? dX[i] : dU[i - 3 * T1])));
  for (int e = tid; e < nel; e += nthr) {
    const double s = S[e], nu = NU[e];
    const double num = has_corr ? mu - static_cast<double>(KC[e]) : mu;
    double ds, dnu, mask;
    if (e < nbox) {
      const BoxElem x = box_elem(e, N, T1);
      double bval;
      box_bound(sc, x, bval, mask);
      const double z = x.state ? X[x.idx] : U[x.idx];
      const double dz = x.state ? dX[x.idx] : dU[x.idx];
      const double c = x.upper ? masked(bval - z, mask) : masked(z - bval, mask);
      box_step(c, s, nu, mask, x.upper ? -dz : dz, num, f, ds, dnu);
    } else {
      const int io = e - nbox, r = io / K, k = io - r * K;
      const int n1 = (r + 1) * 3;
      const D* ctr = CTR + (static_cast<long long>(k) * N + r) * 2;
      const Ob o = obstacle(X[n1], X[n1 + 1], ctr[0], ctr[1], RAD[k], infl, OM[k]);
      const double jdz = o.nx * dX[n1] + o.ny * dX[n1 + 1];
      mask = o.mask;
      if (EL) {
        const double ev = E[io];
        double de;
        elastic_step(elastic_coef(o.c, s, nu, ev, o.mask, mu, rho_e, f), o.mask, jdz, f, ds, de,
                     dnu);
        DE[io] = de;
        a_s = minp(a_s, ftb(ev, de, tau));
      } else {
        box_step(o.c, s, nu, o.mask, jdz, num, f, ds, dnu);
      }
    }
    DS[e] = ds;
    DNU[e] = dnu;
    a_s = minp(a_s, ftb(s, ds, tau));
    a_nu = minp(a_nu, ftb(nu, dnu, tau));
    nu_max = maxp(nu_max, mask * nu);
  }
  a_s = warp_min(a_s);
  a_nu = warp_min(a_nu);
  nu_max = warp_max(nu_max);
  step_inf = warp_max(step_inf);
  if (lane == 0) {
    part1[warp * 4 + 0] = a_s;
    part1[warp * 4 + 1] = a_nu;
    part1[warp * 4 + 2] = nu_max;
    part1[warp * 4 + 3] = step_inf;
  }
  __syncthreads();
  a_s = part1[0];
  a_nu = part1[1];
  nu_max = part1[2];
  step_inf = part1[3];
  for (int w = 1; w < nwarps; ++w) {
    a_s = minp(a_s, part1[w * 4 + 0]);
    a_nu = minp(a_nu, part1[w * 4 + 1]);
    nu_max = maxp(nu_max, part1[w * 4 + 2]);
    step_inf = maxp(step_inf, part1[w * 4 + 3]);
  }
  // Phase clocks: pass 1.

  // Pass 2: thread 0 runs the penalty weight's adjoint sweep of the
  // condensed gradients; the other threads take, candidate by candidate,
  // (stage or element, candidate) and sum the objective less mu times the
  // log barrier (P), and the l1 residuals (R: defects, pin, consistency of
  // every family).  Candidate c is alpha = 0 (c = 0) or a_s * ladder[c - 1].
  const int nc = 1 + p.ls_iters;
  const double* const ladder = sc + kLadder;
  if (tid == 0) {
    double l0 = Q[N * 3], l1 = Q[N * 3 + 1], l2 = Q[N * 3 + 2];
    double lam_max = maxp(maxp(fabs(l0), fabs(l1)), fabs(l2));
#pragma unroll 5
    for (int t = N - 1; t >= 0; --t) {
      const D* At = AM + t * 9;
      const double n0 = Q[t * 3] + (At[0] * l0 + At[3] * l1 + At[6] * l2);
      const double n1 = Q[t * 3 + 1] + (At[1] * l0 + At[4] * l1 + At[7] * l2);
      const double n2 = Q[t * 3 + 2] + (At[2] * l0 + At[5] * l1 + At[8] * l2);
      l0 = n0;
      l1 = n1;
      l2 = n2;
      lam_max = maxp(lam_max, fabs(n0));
      lam_max = maxp(lam_max, fabs(n1));
      lam_max = maxp(lam_max, fabs(n2));
    }
    sc[kLam] = lam_max;
    for (int q = 0; q < 2 * nc; ++q) part2[q * nthr] = 0.0;
    // Phase clocks: sweep.
  } else {
    const double w0 = p.w0, w1 = p.w1, w2 = p.w2, dt = p.dt;
    for (int c = 0; c < nc; ++c) {
      const double a = c == 0 ? 0.0 : a_s * ladder[c - 1];
      double Pc = 0.0, Rc = 0.0;
      for (int i = tid - 1; i < T1 + nel; i += nthr - 1) {
        if (i < T1) {
          // Stage i: the objective, the pin (i = 0) and the defect to i + 1.
          const int t = i;
          const double gm = goal_row(t, N, p.exclude_terminal) ? 1.0 : 0.0;
          const double xa0 = X[t * 3] + a * dX[t * 3];
          const double xa1 = X[t * 3 + 1] + a * dX[t * 3 + 1];
          const double xa2 = X[t * 3 + 2] + a * dX[t * 3 + 2];
          const double r0 = xa0 - sc[kGoal], r1 = xa1 - sc[kGoal + 1], r2 = xa2 - sc[kGoal + 2];
          Pc += gm * (r0 * r0) * w0;
          Pc += gm * (r1 * r1) * w1;
          Pc += gm * (r2 * r2) * w2;
          if (t == 0) {
            Rc += fabs(sc[kX0] - xa0);
            Rc += fabs(sc[kX0 + 1] - xa1);
            Rc += fabs(sc[kX0 + 2] - xa2);
          }
          if (t < N) {
            const int n1 = (t + 1) * 3;
            const double v = U[t * 2] + a * dU[t * 2], om = U[t * 2 + 1] + a * dU[t * 2 + 1];
            const double nv = minp(v, 0.0), pv = maxp(v, 0.0);
            Pc += p.reverse_squared ? p.w_neg * (nv * nv) : p.w_neg * nv;
            Pc += p.w_pos * (pv * pv) + p.w_ang * (om * om);
            double sth, cth;
            sincos_rd(xa2, sth, cth);
            Rc += fabs(xa0 + v * cth * dt - (X[n1] + a * dX[n1]));
            Rc += fabs(xa1 + v * sth * dt - (X[n1 + 1] + a * dX[n1 + 1]));
            Rc += fabs(xa2 + om * dt - (X[n1 + 2] + a * dX[n1 + 2]));
          }
        } else if (i < T1 + nbox) {
          // Box element e: its log barrier and consistency along the step.
          const int e = i - T1;
          const BoxElem x = box_elem(e, N, T1);
          double bval, mask;
          box_bound(sc, x, bval, mask);
          const double za = x.state ? X[x.idx] + a * dX[x.idx] : U[x.idx] + a * dU[x.idx];
          const double sa = S[e] + a * DS[e];
          const double ca = x.upper ? masked(bval - za, mask) : masked(za - bval, mask);
          Pc -= mu * (mask * Trans<D>::log(maxp(sa, 1e-30)));
          Rc += mask * fabs(ca - sa);
        } else {
          // Obstacle element: the same, with the distance at the trial point.
          const int e = i - T1, io = e - nbox, r = io / K, k = io - r * K;
          const int n1 = (r + 1) * 3;
          const D* ctr = CTR + (static_cast<long long>(k) * N + r) * 2;
          const double mask = OM[k] > 0.5 ? 1.0 : 0.0;
          const double qx_ = X[n1] + a * dX[n1] - ctr[0];
          const double qy = X[n1 + 1] + a * dX[n1 + 1] - ctr[1];
          const double dist = Trans<D>::sqrt(qx_ * qx_ + qy * qy + 1e-16);
          const double ca = masked(dist - RAD[k] - infl, mask);
          const double sa = S[e] + a * DS[e];
          double lg = mask * Trans<D>::log(maxp(sa, 1e-30));
          if (EL) {
            const double ea = E[io] + a * DE[io];
            lg += mask * Trans<D>::log(maxp(ea, 1e-30));
            Pc += rho_e * (mask * ea);
            Rc += mask * fabs(ca + ea - sa);
          } else {
            Rc += mask * fabs(ca - sa);
          }
          Pc -= mu * lg;
        }
      }
      part2[(2 * c) * nthr + tid] = Pc;
      part2[(2 * c + 1) * nthr + tid] = Rc;
    }
  }
  __syncthreads();
  // Each sum over the threads in thread order: warp w takes sums w,
  // w + nwarps, ...; the block reads them after a barrier.
  for (int q = warp; q < 2 * nc; q += nwarps) {
    double v = 0.0;
    for (int i = lane; i < nthr; i += kLanes) v += part2[q * nthr + i];
    v = warp_sum(v);
    if (lane == 0) sc[kSums + q] = v;
  }
  __syncthreads();
  // Phase clocks: pass 2.
  const double rho = maxp(2.0 * maxp(nu_max, sc[kLam]), p.merit_penalty);
  double merit[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c)
    merit[c] = c < nc ? sc[kSums + 2 * c] + rho * sc[kSums + 2 * c + 1] : 0.0;

  // Acceptance: the largest candidate whose merit does not rise beyond
  // rounding noise plus, in the small-step Newton regime only, the
  // curvature budget; else the deepest one if its merit is finite; else 0.
  const double m0 = merit[0];
  const bool newton = step_inf < Num<D>::newton();
  const double tol =
      16.0 * Num<D>::eps() * (1.0 + fabs(m0)) + (newton ? 10.0 * rho * step_inf * step_inf : 0.0);
  int idx = 0;
  bool any_ok = false;
  double alpha = 0.0, deepest = 0.0;
  bool deepest_finite = false;
#pragma unroll
  for (int c = 1; c < kMaxCand; ++c) {
    if (c < nc) {
      const bool ok = isfin(merit[c]) && merit[c] <= m0 + tol;
      if (ok && !any_ok) {
        any_ok = true;
        idx = c - 1;
        alpha = a_s * ladder[c - 1];
      }
      if (c == nc - 1) {
        deepest = a_s * ladder[c - 1];
        deepest_finite = isfin(merit[c]);
      }
    }
  }
  if (!any_ok) alpha = deepest_finite ? deepest : 0.0;
  a_nu = minp(a_nu, alpha);
  // Phase clocks: acceptance.

  // Pass 3: the update, the dual clamp, and the new mean complementarity.
  for (int i = tid; i < 3 * T1 + 2 * N; i += nthr) {
    if (i < 3 * T1)
      put<D>(out.states, xs)[i] = static_cast<double>(X[i]) + alpha * dX[i];
    else
      put<D>(out.controls, us)[i - 3 * T1] =
          static_cast<double>(U[i - 3 * T1]) + alpha * dU[i - 3 * T1];
  }
  double tot = 0.0, cnt = 0.0;
  for (int e = tid; e < nel; e += nthr) {
    const double s = S[e], nu = NU[e];
    const double sn = s + alpha * DS[e];
    const double center = mu / maxp(sn, f.fl);
    double mask;
    D *s_to, *nu_to;
    if (e < nbox) {
      const BoxElem x = box_elem(e, N, T1);
      double bval;
      box_bound(sc, x, bval, mask);
      const long long off = (x.state ? xs : us) + x.idx;
      s_to = put<D>(box_row(out, x, false), off);
      nu_to = put<D>(box_row(out, x, true), off);
    } else {
      const int io = e - nbox, k = io % K;
      mask = OM[k] > 0.5 ? 1.0 : 0.0;
      s_to = put<D>(out.s_ob, os + io);
      nu_to = put<D>(out.nu_ob, os + io);
      put<D>(out.e_ob, os)[io] = EL ? static_cast<double>(E[io]) + alpha * DE[io]
                                    : static_cast<double>(*at<D>(it.e_ob, os + io));
    }
    const double nn = mask * minp(maxp(nu + a_nu * DNU[e], center / 1e10), center * 1e10);
    *s_to = sn;
    *nu_to = nn;
    tot += mask * sn * nn;
    cnt += mask;
  }
  tot = warp_sum(tot);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    part3[warp * 2] = tot;
    part3[warp * 2 + 1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    tot = part3[0];
    cnt = part3[1];
    for (int w = 1; w < nwarps; ++w) {
      tot += part3[w * 2];
      cnt += part3[w * 2 + 1];
    }
    const double reg = *at<D>(it.reg, b), sigma = *at<D>(it.sigma, b);
    const bool grow = !any_ok || (idx >= 4 && !newton);
    *put<D>(out.reg, b) = grow ? minp(maxp(reg, p.reg) * 8.0, 1e8) : maxp(reg / 3.0, p.reg);
    double sig = sigma;
    if (p.adaptive_sigma)
      sig = (alpha < 0.25 && !newton) ? minp(sigma * 1.5, p.sigma_cap)
                                      : maxp(sigma * 0.9, p.mu_sigma);
    *put<D>(out.sigma, b) = sig;
    const double comp = tot / maxp(cnt, 1.0);
    *put<D>(so.mu, b) = p.raw_mu ? comp : clipp(sig * comp, p.mu_floor, p.mu_init);
    *put<D>(so.alpha, b) = alpha;
    if (so.merit != nullptr) {
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c)
        if (c < nc) put<D>(so.merit, static_cast<long long>(b) * nc)[c] = merit[c];
      *put<D>(so.rho, b) = rho;
    }
  }
  // Phase clocks: pass 3.
}

// ---------------------------------------------------------------------------
// Init and diagnostics, once per solve: one block per scenario at every
// batch.  Each thread keeps its entries' sums and extremes in registers; a
// butterfly within each warp and the warps' partials in warp order reduce
// them, in one fixed order for the block.

// The init's and the diagnostics' warps per scenario.
constexpr int kOnceWarps = 4;

// One slack and dual of the first iterate (solver/ipm.py::_init_state):
// where the constraint is on, s at its value floored at 1e-2 and nu =
// mu0 / s, else 1 and 0; both rounded to D as the iterate holds them.
// Returns s; adds mask * s * nu to ``tot``.
template <typename D>
__device__ __forceinline__ double init_pair(double c, double mask, double mu0, void* s_row,
                                            void* nu_row, long long off, double& tot) {
  const D s = static_cast<D>(mask > 0.0 ? maxp(c, 1e-2) : 1.0);
  const D nu = static_cast<D>(mask > 0.0 ? mu0 / static_cast<double>(s) : 0.0);
  *put<D>(s_row, off) = s;
  *put<D>(nu_row, off) = nu;
  tot += mask * static_cast<double>(s) * static_cast<double>(nu);
  return s;
}

// solver/ipm.py::init_plain: the first iterate's slacks, duals, e_ob, reg
// and sigma, and the first mu (adaptive, or the raw mean complementarity
// under "pc").  The trajectory is the warm start's, which `it` points at.
//
// One block of kOnceWarps warps per scenario.  The threads take the
// scenario's entries by flat index, family by family (the controls' box
// entries, [N, 2]; the states', [N+1, 3]; the obstacle constraints,
// [N, K]), so consecutive threads read and store consecutive values of
// every row.  The obstacle constraints read their centers ([K, N, 2]) in
// (stage, obstacle) order, 2 N values apart across a warp: a scenario's
// centers are a few KB that the block reads whole, so L1 serves all but
// the first read of each sector (a copy into shared memory first was
// slower, PERF.md section 6).  Each thread sums its entries' shares of
// the complementarity in registers; a butterfly within each warp and the
// warps' partials in warp order give the sum, in one fixed order for the
// block.  The count of constraints that are on follows from the bounds'
// finiteness and the mask alone.
template <typename D>
__global__ void __launch_bounds__(kOnceWarps * kLanes)
init_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
            D* __restrict__ mu_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* const part = reinterpret_cast<double*>(smem);  // [kOnceWarps]
  constexpr int nthr = kOnceWarps * kLanes;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int N = p.N, K = p.K, T1 = N + 1;
  const int n_u = 2 * N, n_x = 3 * T1;
  const double mu0 = p.mu_init;
  const D* X = at<D>(it.states, b * T1 * 3);
  const D* U = at<D>(it.controls, b * n_u);
  const double infl = *at<D>(pr.infl, b);
  double tot = 0.0;  // this thread's entries' shares
  // Init family: controls.
  for (int g = tid; g < n_u; g += nthr) {
    const Bound lo = bound(*at<D>(pr.cl, b * 2 + g % 2)), hi = bound(*at<D>(pr.cu, b * 2 + g % 2));
    const double u = U[g];
    const long long off = b * n_u + g;
    init_pair<D>(masked(u - lo.val, lo.mask), lo.mask, mu0, it.s_cl, it.nu_cl, off, tot);
    init_pair<D>(masked(hi.val - u, hi.mask), hi.mask, mu0, it.s_cu, it.nu_cu, off, tot);
  }
  // Init family: states.
  for (int e = tid; e < n_x; e += nthr) {
    const Bound lo = bound(*at<D>(pr.xl, b * 3 + e % 3)), hi = bound(*at<D>(pr.xu, b * 3 + e % 3));
    const double x = X[e];
    const long long off = b * n_x + e;
    init_pair<D>(masked(x - lo.val, lo.mask), lo.mask, mu0, it.s_xl, it.nu_xl, off, tot);
    init_pair<D>(masked(hi.val - x, hi.mask), hi.mask, mu0, it.s_xu, it.nu_xu, off, tot);
  }
  // Init family: obstacles.
  for (int e = tid; e < N * K; e += nthr) {
    const int t = e / K + 1, k = e % K;
    const D* c = at<D>(pr.centers, ((b * K + k) * N + t - 1) * 2);
    const Ob o = obstacle(X[t * 3], X[t * 3 + 1], c[0], c[1], *at<D>(pr.radii, b * K + k), infl,
                          *at<D>(pr.omask, b * K + k));
    const long long off = b * N * K + e;
    const double s = init_pair<D>(o.c, o.mask, mu0, it.s_ob, it.nu_ob, off, tot);
    // Elastic: e solves c + e = s where violated, else sits at mu0 / rho_e.
    *put<D>(it.e_ob, off) = p.elastic && o.mask > 0.0 ? maxp(s - o.c, mu0 / p.rho_e) : 1.0;
  }
  tot = warp_sum(tot);
  if (tid % kLanes == 0) part[tid / kLanes] = tot;
  __syncthreads();  // the warps' partials are in
  if (tid == 0) {
    tot = part[0];
    for (int w = 1; w < kOnceWarps; ++w) tot += part[w];
    // The constraints that are on: the finite bounds at every stage, the
    // masked obstacles at stages 1..N.
    double cnt = 0.0;
    for (int j = 0; j < 2; ++j)
      cnt += N * (bound(*at<D>(pr.cl, b * 2 + j)).mask + bound(*at<D>(pr.cu, b * 2 + j)).mask);
    for (int i = 0; i < 3; ++i)
      cnt += T1 * (bound(*at<D>(pr.xl, b * 3 + i)).mask + bound(*at<D>(pr.xu, b * 3 + i)).mask);
    for (int k = 0; k < K; ++k)
      cnt += static_cast<double>(*at<D>(pr.omask, b * K + k)) > 0.5 ? N : 0.0;
    const D sigma = static_cast<D>(p.mu_sigma);
    *put<D>(it.reg, b) = static_cast<D>(p.reg);
    *put<D>(it.sigma, b) = sigma;
    const double comp = tot / maxp(cnt, 1.0);
    mu_out[b] = p.raw_mu ? comp : clipp(static_cast<double>(sigma) * comp, p.mu_floor, p.mu_init);
  }
}

// A constraint entry's share of the diagnostics: |nu| and the mask for
// the scaling s_d (the mask also counts the mean complementarity), s nu,
// the violation (feasibility's, beside the defects and the pin) and the
// complementarity.
struct DiagSums {
  double nu_sum, tot, feas, comp;
  int cnt;
};
__device__ __forceinline__ void diag_entry(double c, double s, double nu, double mask,
                                           DiagSums& a) {
  a.nu_sum += mask * fabs(nu);
  a.cnt += mask > 0.0 ? 1 : 0;
  a.tot += mask * s * nu;
  a.feas = maxp(a.feas, mask * maxp(-c, 0.0));
  a.comp = maxp(a.comp, mask * fabs(s * nu));
}

// Obstacle constraints of a diagnostics chunk at most: the chunk's normal
// terms fill 2 x 512 doubles of shared memory.
constexpr int kDiagEntries = 512;
// What a diagnostics thread sums (|nu|, mask, s nu, cost) and maximises
// (violation, defect or pin; complementarity; |r_u|).
constexpr int kDiagSums = 7;

// Stages per chunk of the diagnostics: the largest power of two C no
// larger than the block's threads with C max(K, 1) <= kDiagEntries, and
// no larger than the horizon's N + 1 stages need.
__host__ __device__ inline int diag_chunk(int N, int K) {
  int c = kOnceWarps * kLanes;
  while (c > 1 && (c * (K > 1 ? K : 1) > kDiagEntries || c / 2 >= N + 1)) c /= 2;
  return c;
}
// A stage's row of normal terms: K values padded to an odd count, so that
// the stages' threads read their rows without bank conflicts.
__host__ __device__ inline int diag_pad(int K) { return K | 1; }
// The diagnostics' shared memory in doubles: the chunk's box rows of the
// Lagrangian's gradient (gx_L [3][C], gu_L [2][C]) and the obstacles'
// normal terms ([2][C][pad]), then the scans' warp totals (lam0 and lam1
// [2][warps], lam2 [warps]) and the block's partials ([kDiagSums][warps]).
__host__ __device__ inline long long diag_smem_values(int N, int K) {
  const long long C = diag_chunk(N, K);
  return 5 * C + 2 * C * diag_pad(K) + (3 + kDiagSums) * kOnceWarps;
}

// Prefix sums over the block's threads of NV values each, from `carry`:
// each v becomes carry plus the values of the threads before it, and each
// carry becomes carry plus every thread's value.  A scan of shuffles within
// each warp, then the warps' totals (`tot`, [NV][kOnceWarps]) in warp
// order: every launch adds in the same order.  One barrier; `tot` is read
// after it, so it must not be written again before the block's next one.
template <int NV>
__device__ __forceinline__ void block_scan(double (&v)[NV], double (&carry)[NV], double* tot,
                                           int lane, int warp) {
  double incl[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) incl[q] = v[q];
#pragma unroll
  for (int d = 1; d < kLanes; d *= 2) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const double u = __shfl_sync(kFull, incl[q], lane >= d ? lane - d : lane);
      if (lane >= d) incl[q] += u;
    }
  }
  if (lane == kLanes - 1) {
#pragma unroll
    for (int q = 0; q < NV; ++q) tot[q * kOnceWarps + warp] = incl[q];
  }
  __syncthreads();  // the warps' totals are in
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const double before = __shfl_sync(kFull, incl[q], lane > 0 ? lane - 1 : 0);
    double base = carry[q], all = carry[q];
    for (int w = 0; w < kOnceWarps; ++w) {
      if (w < warp) base += tot[q * kOnceWarps + w];
      all += tot[q * kOnceWarps + w];
    }
    v[q] = lane > 0 ? base + before : base;
    carry[q] = all;
  }
}

// solver/ipm.py::diagnostics_plain: the final mu (`_adaptive_mu`) and the
// KKT residuals with adjoint-estimated dynamics multipliers
// (`_diagnostics`), in double.
//
// One block of kOnceWarps warps per scenario.  The stages go from N down
// in chunks of C = diag_chunk(N, K).  In a chunk the threads take its
// entries by one flat index: the obstacle constraints ([N, K] rows), then
// the states' box entries ([N+1, 3]), then the controls' ([N, 2]), each
// read in place (consecutive threads, consecutive values); the order runs
// from the block's last thread, so that the first ones, which take the
// stage rows, take the fewest entries.  Each entry adds its share of the
// sums and extremes in the thread's registers, and its gradient of the
// Lagrangian (the box rows of gx_L and gu_L, the cost's gradient
// included) or its normal term n (mask nu), as (dx, dy) (mask nu / d),
// goes to shared memory.  Thread j takes stage t = top - j: before the
// barrier the linearisation (one sincos_rd), the defects and the pin,
// after it gx_L less the stage's normal terms in k order.  A_t is the
// identity but for its third column (-v sin dt, v cos dt, 1), so the
// adjoint lam_t = gx_L,t + A_t' lam_{t+1} (lam_N = gx_L,N) is three
// suffix sums: lam0 and lam1 of gx_L's first two components, lam2 of
// gx_L2,t - v sin dt lam0_{t+1} + v cos dt lam1_{t+1}.  Over the chunk
// they are prefix sums over the threads (`block_scan`), carried from the
// chunk above; r_u,t = gu_L,t + B_t' lam_{t+1} follows, and its largest
// entry.  The scans add in another order than the plain version's
// sequential sweep (in double, ~1e-16 of the multipliers).  Three barriers
// a chunk, one at the end.  The launch bounds keep 64 registers, for 8
// resident blocks per SM: the kernel's time follows the scenarios in
// flight (fewer with more registers; 1 or 2 warps per scenario are faster
// at B=8192 alone, PERF.md section 6).
template <typename D>
__global__ void __launch_bounds__(kOnceWarps * kLanes, 8)
diagnostics_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
                   const DiagPtrs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int nthr = kOnceWarps * kLanes;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const long long b = blockIdx.x;
  const int N = p.N, K = p.K, T1 = N + 1;
  const int C = diag_chunk(N, K), Kp = diag_pad(K);
  double* const gx = reinterpret_cast<double*>(smem);  // [3][C]
  double* const gu = gx + 3 * C;                         // [2][C]
  double* const nrm = gu + 2 * C;                        // [2][C][Kp]
  double* const tot01 = nrm + 2 * C * Kp;                // [2][kOnceWarps]
  double* const tot2 = tot01 + 2 * kOnceWarps;           // [kOnceWarps]
  double* const part = tot2 + kOnceWarps;                // [kDiagSums][kOnceWarps]
  const D* X = at<D>(it.states, b * T1 * 3);
  const D* U = at<D>(it.controls, b * N * 2);
  const D* goal = at<D>(pr.goal, b * 3);
  const double infl = *at<D>(pr.infl, b), dt = p.dt;
  const double sigma = tid == 0 ? static_cast<double>(*at<D>(it.sigma, b)) : 0.0;  // for the end
  DiagSums a{0.0, 0.0, 0.0, 0.0, 0};
  double cost = 0.0, r_max = 0.0;             // the objective; the largest |r_u| entry
  double c01[2] = {0.0, 0.0}, c2[1] = {0.0};  // lam at the stage above the chunk
  for (int top = N; top >= 0; top -= C) {
    const int lo = top - C + 1 > 0 ? top - C + 1 : 0;  // the chunk's stages lo..top
    const int olo = lo > 1 ? lo : 1;  // the chunk's obstacle rows, olo - 1..top - 1
    const int n_o = (top - olo + 1) * K, n_x = (top - lo + 1) * 3;
    const int n_ox = n_o + n_x, n_all = n_ox + ((top < N ? top + 1 : N) - lo) * 2;
    // The chunk's entries by one flat index f: its obstacle constraints,
    // then its states' box entries, then its controls'.  Thread tid takes
    // f = nthr - 1 - tid and every nthr-th after it, so that the first
    // threads, which take the stage rows below, take the fewest entries.
    for (int f = nthr - 1 - tid; f < n_all; f += nthr) {
      // Diagnostics family: obstacles.
      if (f < n_o) {
        // Row r = t - 1 covers state t; the normal term n (mask nu) as
        // (dx, dy) (mask nu / d), one division.
        const int r = olo - 1 + f / K, k = f % K, t = r + 1;
        const D* c = at<D>(pr.centers, ((b * K + k) * N + r) * 2);
        const double dx = X[t * 3] - static_cast<double>(c[0]);
        const double dy = X[t * 3 + 1] - static_cast<double>(c[1]);
        const double dist = sqrt(dx * dx + dy * dy + 1e-16);
        const double mask = static_cast<double>(*at<D>(pr.omask, b * K + k)) > 0.5 ? 1.0 : 0.0;
        const long long off = (b * N + r) * K + k;
        const double nu = *at<D>(it.nu_ob, off);
        diag_entry(masked(dist - *at<D>(pr.radii, b * K + k) - infl, mask), *at<D>(it.s_ob, off),
                   nu, mask, a);
        const double q = mask * nu / maxp(dist, 1e-2);
        const int slot = (top - t) * Kp + k;
        nrm[slot] = dx * q;
        nrm[C * Kp + slot] = dy * q;
      }
      // Diagnostics family: states.
      if (f >= n_o && f < n_ox) {
        const int e = lo * 3 + f - n_o, t = e / 3, i = e - t * 3;
        const Bound l = bound(*at<D>(pr.xl, b * 3 + i)), h = bound(*at<D>(pr.xu, b * 3 + i));
        const double x = X[e];
        const long long off = b * T1 * 3 + e;
        const double nu_lo = *at<D>(it.nu_xl, off), nu_hi = *at<D>(it.nu_xu, off);
        diag_entry(masked(x - l.val, l.mask), *at<D>(it.s_xl, off), nu_lo, l.mask, a);
        diag_entry(masked(h.val - x, h.mask), *at<D>(it.s_xu, off), nu_hi, h.mask, a);
        const double gm = goal_row(t, N, p.exclude_terminal) ? 1.0 : 0.0;
        const double w = i == 0 ? p.w0 : (i == 1 ? p.w1 : p.w2);
        const double err = x - goal[i];
        cost += gm * (err * err) * w;
        gx[i * C + top - t] = 2.0 * gm * w * err - l.mask * nu_lo + h.mask * nu_hi;
      }
      // Diagnostics family: controls.
      if (f >= n_ox) {
        const int g = lo * 2 + f - n_ox, t = g / 2, j = g - t * 2;
        const Bound l = bound(*at<D>(pr.cl, b * 2 + j)), h = bound(*at<D>(pr.cu, b * 2 + j));
        const double u = U[g];
        const long long off = b * N * 2 + g;
        const double nu_lo = *at<D>(it.nu_cl, off), nu_hi = *at<D>(it.nu_cu, off);
        diag_entry(masked(u - l.val, l.mask), *at<D>(it.s_cl, off), nu_lo, l.mask, a);
        diag_entry(masked(h.val - u, h.mask), *at<D>(it.s_cu, off), nu_hi, h.mask, a);
        double gc;
        if (j == 0) {  // the speed v
          const double nv = minp(u, 0.0), pv = maxp(u, 0.0);
          gc = p.reverse_squared ? 2.0 * p.w_neg * nv : p.w_neg * (u < 0.0 ? 1.0 : 0.0);
          gc = gc + 2.0 * p.w_pos * pv;
          cost += p.reverse_squared ? p.w_neg * (nv * nv) : p.w_neg * nv;
          cost += p.w_pos * (pv * pv);
        } else {  // the turn rate
          gc = 2.0 * p.w_ang * u;
          cost += p.w_ang * (u * u);
        }
        gu[j * C + top - t] = gc - l.mask * nu_lo + h.mask * nu_hi;
      }
    }
    // Thread j takes stage t = top - j.  Before the barrier, what needs no
    // shared memory: the linearisation (one sincos_rd), the defects and
    // the pin; after it, gx_L's components and gu_L.
    const int j = tid, t = top - tid;
    const bool on = j < C && t >= lo;
    double cdt = 0.0, sdt = 0.0, v = 0.0;  // cos dt, sin dt and the speed of B_t and A_t
    // Diagnostics stage rows.
    if (on && t < N) {
      const double om = U[t * 2 + 1];
      double sth, cth;
      v = U[t * 2];
      sincos_rd(X[t * 3 + 2], sth, cth);
      cdt = cth * dt;
      sdt = sth * dt;
      const D* X1 = X + (t + 1) * 3;
      a.feas = maxp(a.feas, fabs(X[t * 3] + v * cth * dt - X1[0]));
      a.feas = maxp(a.feas, fabs(X[t * 3 + 1] + v * sth * dt - X1[1]));
      a.feas = maxp(a.feas, fabs(X[t * 3 + 2] + om * dt - X1[2]));
    }
    if (on && t == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        a.feas = maxp(a.feas, fabs(static_cast<double>(*at<D>(pr.x0, b * 3 + i)) - X[i]));
    }
    __syncthreads();  // the chunk's rows are in
    double g[2] = {0.0, 0.0}, h[1] = {0.0}, gu0 = 0.0, gu1 = 0.0;
    if (on) {
      g[0] = gx[j];
      g[1] = gx[C + j];
      h[0] = gx[2 * C + j];
      if (t >= 1 && K > 0) {
        double n0 = 0.0, n1 = 0.0;
        for (int k = 0; k < K; ++k) {
          n0 += nrm[j * Kp + k];
          n1 += nrm[(C + j) * Kp + k];
        }
        g[0] -= n0;
        g[1] -= n1;
      }
      if (t < N) {
        gu0 = gu[j];
        gu1 = gu[C + j];
      }
    }
    // The scans: lam0 and lam1 at t + 1, then r_u's first entry and lam2's
    // term (A_t's third column is (-v sin dt, v cos dt, 1)), then lam2 at
    // t + 1 and r_u's second entry.
    block_scan(g, c01, tot01, lane, warp);  // Diagnostics scan.
    if (on && t < N) {
      r_max = maxp(r_max, fabs(gu0 + (cdt * g[0] + sdt * g[1])));
      h[0] = h[0] + (-v * sdt * g[0] + v * cdt * g[1]);
    }
    block_scan(h, c2, tot2, lane, warp);  // Diagnostics scan.
    if (on && t < N) r_max = maxp(r_max, fabs(gu1 + dt * h[0]));
  }
  double s[kDiagSums] = {a.nu_sum, static_cast<double>(a.cnt), a.tot, cost, a.feas, a.comp, r_max};
#pragma unroll
  for (int q = 0; q < kDiagSums; ++q) s[q] = q < 4 ? warp_sum(s[q]) : warp_max(s[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kDiagSums; ++q) part[q * kOnceWarps + warp] = s[q];
  }
  __syncthreads();  // the warps' partials are in
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < kDiagSums; ++q) {
      s[q] = part[q * kOnceWarps];
      for (int w = 1; w < kOnceWarps; ++w)
        s[q] = q < 4 ? s[q] + part[q * kOnceWarps + w] : maxp(s[q], part[q * kOnceWarps + w]);
    }
    const double nu_sum = s[0], cnt = s[1], tot = s[2], comp = s[5];
    const double mu = clipp(sigma * (tot / maxp(cnt, 1.0)), p.mu_floor, p.mu_init);
    // IPOPT-style scaling of the dual residual (its s_d, s_max = 100).
    const double s_d = maxp(nu_sum / maxp(cnt, 1.0), 100.0) / 100.0;
    const D stat = static_cast<D>(s[6] / s_d);
    const D feas = static_cast<D>(s[4]);
    const D comp_scaled = static_cast<D>(comp / s_d);
    *put<unsigned char>(out.converged, b) =
        stat < p.kkt_tol && feas < p.kkt_tol && comp_scaled < p.comp_tol ? 1 : 0;
    *put<D>(out.stationarity, b) = stat;
    *put<D>(out.feasibility, b) = feas;
    *put<D>(out.complementarity, b) = static_cast<D>(comp);
    *put<D>(out.final_cost, b) = static_cast<D>(s[3]);
    *put<D>(out.final_mu, b) = static_cast<D>(mu);
  }
}

template <typename T, bool EL>
cudaError_t launch_condense(const SplitParams& p, const ProblemPtrs& pr, const IteratePtrs& it,
                            const void* mu, const CorrPtrs& corr, const LqrPtrs& out,
                            cudaStream_t stream) {
  const long long threads = static_cast<long long>(p.B) * (p.N + 1);
  const int blocks = static_cast<int>((threads + kCondenseThreads - 1) / kCondenseThreads);
  const size_t bytes = static_cast<size_t>(kCondenseThreads) *
                       condense_row_values(p.K, EL || corr.cl != nullptr) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(condense_kernel<T, EL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  condense_kernel<T, EL><<<blocks, kCondenseThreads, bytes, stream>>>(
      p, pr, it, static_cast<const T*>(mu), corr, out);
  return cudaGetLastError();
}

template <typename T>
using StepFn = void (*)(const SplitParams, const ProblemPtrs, const IteratePtrs, const T*,
                        const T*, const T*, const T*, const T*, const CorrPtrs, const IteratePtrs,
                        const StepOut);

// The step's instance, dynamic shared bytes per block and whether its
// arena is global, for the launch's (N, K, elastic, corrections, warps);
// the bytes allowed before the launch (needed above 48 KB).
template <typename T>
cudaError_t prepare_step(const SplitParams& p, bool has_corr, StepFn<T>* fn, size_t* bytes,
                         bool* global) {
  if (p.warps < 1 || p.warps > kMaxWarps) return cudaErrorInvalidValue;
  const bool el = p.elastic && p.K > 0;
  const StepLayout L = step_layout(p.N, p.K, el, has_corr, sizeof(T));
  const long long red = step_red_bytes(p.warps, p.ls_iters);
  *global = red + L.bytes > kSmemOptin;
  *bytes = static_cast<size_t>(red + (*global ? 0 : L.bytes));
  if (el)
    *fn = *global ? step_kernel<T, true, true> : step_kernel<T, true, false>;
  else
    *fn = *global ? step_kernel<T, false, true> : step_kernel<T, false, false>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

template <typename T>
cudaError_t launch_step(const SplitParams& p, const ProblemPtrs& pr, const IteratePtrs& it,
                        const void* mu, const void* qx, const void* A, const void* dx,
                        const void* du, const CorrPtrs& corr, const IteratePtrs& out,
                        const StepOut& so, cudaStream_t stream) {
  StepFn<T> fn;
  size_t bytes;
  bool global;
  cudaError_t err = prepare_step<T>(p, corr.cl != nullptr, &fn, &bytes, &global);
  if (err != cudaSuccess) return err;
  if (global && so.scratch == nullptr) return cudaErrorInvalidValue;
  fn<<<p.B, p.warps * kLanes, bytes, stream>>>(
      p, pr, it, static_cast<const T*>(mu), static_cast<const T*>(qx), static_cast<const T*>(A),
      static_cast<const T*>(dx), static_cast<const T*>(du), corr, out, so);
  return cudaGetLastError();
}

template <typename T>
int condense(const SplitParams* params, const ProblemPtrs* pr, const IteratePtrs* it,
             const void* mu, const CorrPtrs* corr, const LqrPtrs* out, void* stream) {
  const SplitParams p = *params;
  if (p.B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = p.elastic && p.K > 0
                              ? launch_condense<T, true>(p, *pr, *it, mu, *corr, *out, s)
                              : launch_condense<T, false>(p, *pr, *it, mu, *corr, *out, s);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller reports it
  return static_cast<int>(err);
}

template <typename T>
int step(const SplitParams* params, const ProblemPtrs* pr, const IteratePtrs* it, const void* mu,
         const void* qx, const void* A, const void* dx, const void* du, const CorrPtrs* corr,
         const IteratePtrs* out, const StepOut* so, void* stream) {
  const SplitParams p = *params;
  if (p.B <= 0) return 0;
  const cudaError_t err = launch_step<T>(p, *pr, *it, mu, qx, A, dx, du, *corr, *out, *so,
                                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller reports it
  return static_cast<int>(err);
}

template <typename T>
int init(const SplitParams* params, const ProblemPtrs* pr, const IteratePtrs* it, void* mu,
         void* stream) {
  const SplitParams p = *params;
  if (p.B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_kernel<T><<<p.B, kOnceWarps * kLanes, sizeof(double) * kOnceWarps, s>>>(
      p, *pr, *it, static_cast<T*>(mu));
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int diagnostics(const SplitParams* params, const ProblemPtrs* pr, const IteratePtrs* it,
                const DiagPtrs* out, void* stream) {
  const SplitParams p = *params;
  if (p.B <= 0) return 0;
  const size_t bytes = sizeof(double) * static_cast<size_t>(diag_smem_values(p.N, p.K));
  diagnostics_kernel<T><<<p.B, kOnceWarps * kLanes, bytes, static_cast<cudaStream_t>(stream)>>>(
      p, *pr, *it, *out);
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int step_occupancy(const SplitParams* params, int corr, int* out) {
  const SplitParams p = *params;
  StepFn<T> fn;
  size_t bytes;
  bool global;
  cudaError_t err = prepare_step<T>(p, corr != 0, &fn, &bytes, &global);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, p.warps * kLanes, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  out[0] = p.warps;
  out[1] = static_cast<int>(bytes);
  out[2] = global ? 1 : 0;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T>
int diagnostics_occupancy(const SplitParams* params, int* out) {
  const SplitParams p = *params;
  const size_t bytes = sizeof(double) * static_cast<size_t>(diag_smem_values(p.N, p.K));
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, diagnostics_kernel<T>, kOnceWarps * kLanes, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, diagnostics_kernel<T>);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  out[0] = kOnceWarps;
  out[1] = diag_chunk(p.N, p.K);
  out[2] = static_cast<int>(bytes);
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

// Launchers: each returns the launch's cudaError_t (0 on success).
extern "C" int kissmpc_split_condense_f32(const SplitParams* p, const ProblemPtrs* pr,
                                          const IteratePtrs* it, const void* mu,
                                          const CorrPtrs* corr, const LqrPtrs* out, void* stream) {
  return condense<float>(p, pr, it, mu, corr, out, stream);
}

extern "C" int kissmpc_split_condense_f64(const SplitParams* p, const ProblemPtrs* pr,
                                          const IteratePtrs* it, const void* mu,
                                          const CorrPtrs* corr, const LqrPtrs* out, void* stream) {
  return condense<double>(p, pr, it, mu, corr, out, stream);
}

extern "C" int kissmpc_split_step_f32(const SplitParams* p, const ProblemPtrs* pr,
                                      const IteratePtrs* it, const void* mu, const void* qx,
                                      const void* A, const void* dx, const void* du,
                                      const CorrPtrs* corr, const IteratePtrs* out,
                                      const StepOut* so, void* stream) {
  return step<float>(p, pr, it, mu, qx, A, dx, du, corr, out, so, stream);
}

extern "C" int kissmpc_split_step_f64(const SplitParams* p, const ProblemPtrs* pr,
                                      const IteratePtrs* it, const void* mu, const void* qx,
                                      const void* A, const void* dx, const void* du,
                                      const CorrPtrs* corr, const IteratePtrs* out,
                                      const StepOut* so, void* stream) {
  return step<double>(p, pr, it, mu, qx, A, dx, du, corr, out, so, stream);
}

extern "C" int kissmpc_split_init_f32(const SplitParams* p, const ProblemPtrs* pr,
                                      const IteratePtrs* it, void* mu, void* stream) {
  return init<float>(p, pr, it, mu, stream);
}

extern "C" int kissmpc_split_init_f64(const SplitParams* p, const ProblemPtrs* pr,
                                      const IteratePtrs* it, void* mu, void* stream) {
  return init<double>(p, pr, it, mu, stream);
}

extern "C" int kissmpc_split_diagnostics_f32(const SplitParams* p, const ProblemPtrs* pr,
                                             const IteratePtrs* it, const DiagPtrs* out,
                                             void* stream) {
  return diagnostics<float>(p, pr, it, out, stream);
}

extern "C" int kissmpc_split_diagnostics_f64(const SplitParams* p, const ProblemPtrs* pr,
                                             const IteratePtrs* it, const DiagPtrs* out,
                                             void* stream) {
  return diagnostics<double>(p, pr, it, out, stream);
}

// Bytes of global scratch per scenario that a step launch of (N, K,
// elastic, corrections, element bytes, warps, ls_iters) needs: its arena where that
// does not fit in shared memory beside the block's reductions, else 0.
// Host arithmetic only: no CUDA call.
extern "C" long long kissmpc_split_step_scratch_bytes(int N, int K, int elastic, int corr,
                                                      int elem_bytes, int warps, int ls_iters) {
  const StepLayout L = step_layout(N, K, elastic && K > 0, corr != 0, elem_bytes);
  return step_red_bytes(warps, ls_iters) + L.bytes > kSmemOptin ? L.bytes : 0;
}

// The launch shape of a step of ``p`` (its N, K, elastic, warps, element
// bytes from ``elem_bytes``): out = {warps per scenario, dynamic shared
// bytes per block, 1 if the arena is global, resident blocks (scenarios)
// per SM, registers per thread, local (stack and spill) bytes per thread}.
// Returns a cudaError_t.
extern "C" int kissmpc_split_step_occupancy(const SplitParams* p, int corr, int elem_bytes,
                                            int* out) {
  return elem_bytes == 8 ? step_occupancy<double>(p, corr, out)
                         : step_occupancy<float>(p, corr, out);
}

// The launch shape of a diagnostics launch of ``p`` (its N and K, element
// bytes from ``elem_bytes``): out = {warps per scenario, stages per chunk,
// dynamic shared bytes per block, resident blocks (scenarios) per SM,
// registers per thread, local (stack and spill) bytes per thread}.
// Returns a cudaError_t.
extern "C" int kissmpc_split_diagnostics_occupancy(const SplitParams* p, int elem_bytes,
                                                   int* out) {
  return elem_bytes == 8 ? diagnostics_occupancy<double>(p, out)
                         : diagnostics_occupancy<float>(p, out);
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
