// The split IPM iteration around the Riccati kernel, for Hopper (sm_90a):
// the condensation kernel before the Newton-KKT solve and the step kernel
// after it.
//
// Replaces: no TPU kernel.  The reference compiles its split IPM under
// jax.jit, and XLA fuses the loop body of kissmpc_tpu/solver/ipm.py:407
// (`_iteration`: `_build_lqr` at :328, the Riccati solve, the steps, the
// fraction to the boundary, the penalty weight's adjoint sweep, the merit
// line search and the update) into a few kernels per iteration.  These two
// kernels are the port's counterpart of that fusion: an iteration is the
// condensation kernel, csrc/riccati.cu and the step kernel.  Contract: the
// plain halves `condense_plain` and `step_plain` of
// kissmpc_tpu_torch/solver/ipm.py, which each kernel follows step by step.
// They follow solver/ipm.py, not csrc/ipm_fused.cu: the merit is evaluated
// anew at alpha = 0, box consistency is evaluated along the step, and the
// floors follow the dtype (1e-10 / 1e-14; sigma at most 1e12 / 1e18; the
// Newton regime below a step of 1e-2 / 1e-4).
//
// condense_kernel: one thread per (scenario, stage t = 0..N).  Stage t's
// state row (box families xl, xu and, for t >= 1, the K obstacle
// constraints on state t, hard or elastic, with the Gauss-Newton term and
// the damped curvature term), its control row (t < N: box families cl, cu,
// the cost's gradient and Hessian, the unicycle linearisation and defect)
// and, at t = 0, the pin residual d0.  Every stage is independent.  It
// writes the eight LQRData tensors in the contiguous layout that
// csrc/riccati.cu reads.
//
// step_kernel: one warp per scenario, kWarps scenarios per block.  The
// lanes stride over the stages in three passes, each recomputing the
// slack, dual and (elastic) e steps of its elements from the iterate and
// the Riccati kernel's dx, du: (1) the fractions to the boundary, the
// largest dual and the step's infinity norm; (2) the l1 merit at alpha = 0
// and at every line-search candidate, all in one pass; (3) the update with
// the dual clamp, and the mean complementarity of the new iterate.  Each
// reduction is lane-strided, then a butterfly of shuffles, so every lane
// holds the same bits; lane 0 runs the penalty weight's N-step adjoint
// sweep of the condensed gradients (qx, A) and writes the scenario's
// scalars: reg, sigma, the next iteration's mu (the adaptive mu, or for
// Mehrotra "pc" the raw mean complementarity) and the accepted step length.
//
// What bounds them: device memory at the batches of the benchmark (a few
// hundred bytes and some hundred operations per element and pass; the
// card's balance is ~10 double operations per byte), and launch latency at
// the node's B=1.  A simple design that is right: no shared memory, every
// value read from device memory (L1 and L2 keep what a pass re-reads).
//
// Templated on the data type D (float, double) and on the elastic branch;
// both instances compute in double (Compute) and round what they store,
// with the floors of D.  K (0 included), N, ls_iters (1..kMaxLs), the cost
// modes and the curvature term are runtime parameters, and the Mehrotra
// correction rows are nullable pointers (all five, or none).  Compiled
// without fast math: max, min and clip propagate NaN, as torch's do (maxp,
// minp, clipp).

#include <cuda_runtime.h>
#include <math.h>

// The launchers' argument structs (outside the anonymous namespace, so the
// extern "C" launchers that take them are exported).

// Mirror of `_Params` in ops/ipm_split.py (ints first, then doubles).
struct SplitParams {
  int B, N, K, ls_iters;
  int exclude_terminal, reverse_squared, curvature, elastic, adaptive_sigma, raw_mu;
  double dt, tau, ls_backtrack, merit_penalty, reg, rho_e;
  double w0, w1, w2, w_neg, w_pos, w_ang;
  double mu_init, mu_floor, mu_sigma, sigma_cap;
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

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;              // scenarios per block of the step kernel
constexpr int kCondenseThreads = 128;  // stages per block of the condensation
constexpr int kMaxLs = 8;              // line-search candidates at most
constexpr int kMaxCand = kMaxLs + 1;   // with alpha = 0

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static constexpr float floor() { return 1e-10f; }
  __device__ static constexpr float sigma_max() { return 1e12f; }
  __device__ static constexpr float newton() { return 1e-2f; }
  __device__ static constexpr double eps() { return 1.1920928955078125e-07; }
};
template <> struct Num<double> {
  __device__ static constexpr double floor() { return 1e-14; }
  __device__ static constexpr double sigma_max() { return 1e18; }
  __device__ static constexpr double newton() { return 1e-4; }
  __device__ static constexpr double eps() { return 2.220446049250313e-16; }
  __device__ static constexpr double big() { return 1.7976931348623157e308; }
};

// The arithmetic type of data type D: both instances compute in double and
// round what they store.  Near an active constraint the condensed gradient
// and the dual step multiply a slack gap of a few ulps by sigma = nu/s (up
// to 1e12 in float32), so float32 arithmetic carries errors far above the
// data's own rounding; double keeps the float32 instance within half an ulp
// of each stored value of the float64 computation on the same inputs.
template <typename D> struct Compute {
  using type = double;
};

template <typename T> __device__ __forceinline__ T maxp(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T minp(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T clipp(T x, T lo, T hi) {
  return minp(maxp(x, lo), hi);
}
template <typename T> __device__ __forceinline__ bool isfin(T x) {
  return fabs(x) <= Num<T>::big();
}

// Butterfly sum, max and min: every lane ends with the same bits.
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}
template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = minp(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

// A bound entry: its value with +-inf read as 0, and its finiteness mask.
template <typename T> struct Bound {
  T val, mask;
};
template <typename T> __device__ __forceinline__ Bound<T> bound(T b) {
  const bool f = isfin(b);
  return {f ? b : T(0), f ? T(1) : T(0)};
}
// A box constraint value; masked entries read 1.
template <typename T> __device__ __forceinline__ T masked(T c, T mask) {
  return mask > T(0) ? c : T(1);
}

// One obstacle constraint on a point: value (1 where masked), unit normal
// by the distance floored at 1e-2, that floored distance, and the mask.
template <typename T> struct Ob {
  T c, nx, ny, dist, mask;
};
template <typename T>
__device__ __forceinline__ Ob<T> obstacle(T px, T py, T cx, T cy, T rad, T infl, T om) {
  const T dx = px - cx, dy = py - cy;
  const T dist = sqrt(dx * dx + dy * dy + T(1e-16));
  const T mask = om > T(0.5) ? T(1) : T(0);
  const T ds = maxp(dist, T(1e-2));
  return {masked(dist - rad - infl, mask), dx / ds, dy / ds, ds, mask};
}

// The floors of the data's dtype (solver/ipm.py::_floor, _sigma_max), in
// the arithmetic type.
template <typename T> struct Floors {
  T fl, smax;
};

template <typename T> __device__ __forceinline__ T sigma_of(T nu, T s, T mask, Floors<T> f) {
  return clipp(mask * nu / maxp(s, f.fl), T(0), f.smax);
}

// Hard slack and dual step: ds = J dz + (c - s), dnu = num/s - nu - sigma ds.
template <typename T>
__device__ __forceinline__ void box_step(T c, T s, T nu, T mask, T jdz, T num, Floors<T> f,
                                         T& ds, T& dnu) {
  ds = mask * (jdz + c - s);
  dnu = mask * (num / maxp(s, f.fl) - nu - sigma_of(nu, s, mask, f) * ds);
}

// solver/ipm.py::elastic_coef.
template <typename T> struct Elastic {
  T g, Tt, r_e, r_c, sig_s, sig_e, sig_eff;
};
template <typename T>
__device__ __forceinline__ Elastic<T> elastic_coef(T c, T s, T nu, T e, T mask, T mu, T rho_e,
                                                  Floors<T> f) {
  const T fl = f.fl, smax = f.smax;
  const T s_safe = maxp(s, fl), e_safe = maxp(e, fl);
  Elastic<T> el;
  el.sig_s = clipp(mask * nu / s_safe, T(0), smax);
  el.sig_e = clipp(mu / (e_safe * e_safe), T(0), smax);
  el.sig_eff = mask * el.sig_s * el.sig_e / maxp(el.sig_s + el.sig_e, fl);
  el.Tt = mu / s_safe - nu;
  el.r_e = rho_e - mu / e_safe - nu;
  el.r_c = c + e - s;
  el.g = mask * (nu - el.sig_eff * el.r_c +
                 el.sig_eff * (el.Tt / maxp(el.sig_s, fl) + el.r_e / el.sig_e));
  return el;
}

// solver/ipm.py::elastic_step: the eliminated (ds, de, dnu).
template <typename T>
__device__ __forceinline__ void elastic_step(const Elastic<T>& el, T mask, T jdz, Floors<T> f,
                                             T& ds, T& de, T& dnu) {
  const T beta = el.sig_e / maxp(el.sig_s + el.sig_e, f.fl);
  ds = mask * beta * (jdz + el.r_c + (el.Tt - el.r_e) / el.sig_e);
  de = mask * (el.Tt - el.r_e - el.sig_s * ds) / el.sig_e;
  dnu = mask * (el.Tt - el.sig_s * ds);
}

// The goal cost's row mask: states 1..N ("full") or 1..N-1.
__device__ __forceinline__ bool goal_row(int t, int N, int exclude_terminal) {
  return t >= 1 && (!exclude_terminal || t <= N - 1);
}

// ---------------------------------------------------------------------------
// The condensation.

template <typename D, bool EL>
__global__ void __launch_bounds__(kCondenseThreads)
condense_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
                const D* __restrict__ mu_in, const CorrPtrs corr, const LqrPtrs out) {
  const int N = p.N, K = p.K, T1 = N + 1;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<long long>(p.B) * T1) return;
  const int b = static_cast<int>(gid / T1), t = static_cast<int>(gid % T1);
  const bool has_corr = corr.cl != nullptr;
  using T = typename Compute<D>::type;
  const Floors<T> f{T(Num<D>::floor()), T(Num<D>::sigma_max())};

  const D* X = static_cast<const D*>(it.states) + static_cast<long long>(b) * T1 * 3;
  const D* goal = static_cast<const D*>(pr.goal) + b * 3;
  const T mu = mu_in[b];
  const T shift = T(p.reg) + static_cast<const D*>(it.reg)[b];
  const T w[3] = {T(p.w0), T(p.w1), T(p.w2)};

  // State row t: cost, box families xl, xu, obstacles on state t.
  T qx[3], Q[3][3];
  const bool grow = goal_row(t, N, p.exclude_terminal);
  const T gm = grow ? T(1) : T(0);
  const long long xrow = (static_cast<long long>(b) * T1 + t) * 3;
  for (int i = 0; i < 3; ++i) {
    const T x = X[t * 3 + i];
    const T gx = T(2) * gm * w[i] * (x - goal[i]);
    const T Hx = T(2) * gm * w[i];
    const Bound<T> lo = bound(T(static_cast<const D*>(pr.xl)[b * 3 + i]));
    const Bound<T> hi = bound(T(static_cast<const D*>(pr.xu)[b * 3 + i]));
    const T c_lo = masked(x - lo.val, lo.mask), c_hi = masked(hi.val - x, hi.mask);
    const T s_lo = static_cast<const D*>(it.s_xl)[xrow + i];
    const T s_hi = static_cast<const D*>(it.s_xu)[xrow + i];
    const T nu_lo = static_cast<const D*>(it.nu_xl)[xrow + i];
    const T nu_hi = static_cast<const D*>(it.nu_xu)[xrow + i];
    const T num_lo = has_corr ? mu - static_cast<const D*>(corr.xl)[xrow + i] : mu;
    const T num_hi = has_corr ? mu - static_cast<const D*>(corr.xu)[xrow + i] : mu;
    const T fl = f.fl;
    const T sig_lo = sigma_of(nu_lo, s_lo, lo.mask, f);
    const T sig_hi = sigma_of(nu_hi, s_hi, hi.mask, f);
    const T g_lo = lo.mask * (num_lo / maxp(s_lo, fl) - sig_lo * (c_lo - s_lo));
    const T g_hi = hi.mask * (num_hi / maxp(s_hi, fl) - sig_hi * (c_hi - s_hi));
    qx[i] = gx - g_lo + g_hi;
    for (int j = 0; j < 3; ++j) Q[i][j] = T(0);
    Q[i][i] = Hx + sig_lo + sig_hi;
  }
  if (K > 0 && t >= 1) {
    const int r = t - 1;  // obstacle row r covers state r + 1
    const long long orow = (static_cast<long long>(b) * N + r) * K;
    const T px = X[t * 3], py = X[t * 3 + 1];
    const T infl = static_cast<const D*>(pr.infl)[b];
    T gsum[2] = {T(0), T(0)}, H[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
    T wsum = T(0), C[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
    for (int k = 0; k < K; ++k) {
      const D* ctr = static_cast<const D*>(pr.centers) + ((static_cast<long long>(b) * K + k) * N + r) * 2;
      const Ob<T> o = obstacle(px, py, T(ctr[0]), T(ctr[1]),
                               T(static_cast<const D*>(pr.radii)[b * K + k]), infl,
                               T(static_cast<const D*>(pr.omask)[b * K + k]));
      const T s = static_cast<const D*>(it.s_ob)[orow + k];
      const T nu = static_cast<const D*>(it.nu_ob)[orow + k];
      T g, sig;
      if (EL) {
        const Elastic<T> el = elastic_coef(o.c, s, nu, T(static_cast<const D*>(it.e_ob)[orow + k]),
                                           o.mask, mu, T(p.rho_e), f);
        g = el.g;
        sig = el.sig_eff;
      } else {
        const T num = has_corr ? mu - static_cast<const D*>(corr.ob)[orow + k] : mu;
        sig = sigma_of(nu, s, o.mask, f);
        g = o.mask * (num / maxp(s, f.fl) - sig * (o.c - s));
      }
      const T n[2] = {o.nx, o.ny};
      for (int d = 0; d < 2; ++d) {
        gsum[d] += n[d] * g;
        for (int e = 0; e < 2; ++e) H[d][e] += sig * n[d] * n[e];
      }
      if (p.curvature) {
        T wk = -o.mask * nu / maxp(o.dist, T(1e-6));
        wk = maxp(wk, T(-0.9) * sig);
        wsum += wk;
        for (int d = 0; d < 2; ++d)
          for (int e = 0; e < 2; ++e) C[d][e] += wk * n[d] * n[e];
      }
    }
    for (int d = 0; d < 2; ++d) {
      qx[d] -= gsum[d];
      for (int e = 0; e < 2; ++e) {
        T h = H[d][e];
        if (p.curvature) h = h + (wsum * (d == e ? T(1) : T(0)) - C[d][e]);
        Q[d][e] += h;
      }
    }
  }
  D* Qxx = static_cast<D*>(out.Qxx) + xrow * 3;
  for (int i = 0; i < 3; ++i) {
    Q[i][i] += shift;
    static_cast<D*>(out.qx)[xrow + i] = qx[i];
    for (int j = 0; j < 3; ++j) Qxx[i * 3 + j] = Q[i][j];
  }
  if (t == 0) {
    const D* x0 = static_cast<const D*>(pr.x0) + b * 3;
    for (int i = 0; i < 3; ++i) static_cast<D*>(out.d0)[b * 3 + i] = x0[i] - X[i];
  }
  if (t == N) return;

  // Control row t: cost, box families cl, cu, linearisation and defect.
  const long long urow = (static_cast<long long>(b) * N + t) * 2;
  const D* U = static_cast<const D*>(it.controls) + urow;
  const T v = U[0], om = U[1];
  T gu[2], Hu[2];
  if (p.reverse_squared) {
    gu[0] = T(2.0 * p.w_neg) * minp(v, T(0));
    Hu[0] = T(2.0 * p.w_neg) * (v < T(0) ? T(1) : T(0));
  } else {
    gu[0] = T(p.w_neg) * (v < T(0) ? T(1) : T(0));
    Hu[0] = T(0);
  }
  gu[0] = gu[0] + T(2.0 * p.w_pos) * maxp(v, T(0));
  Hu[0] = Hu[0] + T(2.0 * p.w_pos) * (v > T(0) ? T(1) : T(0));
  gu[1] = T(2.0 * p.w_ang) * om;
  Hu[1] = T(2.0 * p.w_ang);
  D* qu = static_cast<D*>(out.qu) + urow;
  D* Quu = static_cast<D*>(out.Quu) + urow * 2;
  for (int j = 0; j < 2; ++j) {
    const Bound<T> lo = bound(T(static_cast<const D*>(pr.cl)[b * 2 + j]));
    const Bound<T> hi = bound(T(static_cast<const D*>(pr.cu)[b * 2 + j]));
    const T c_lo = masked(U[j] - lo.val, lo.mask), c_hi = masked(hi.val - U[j], hi.mask);
    const T s_lo = static_cast<const D*>(it.s_cl)[urow + j];
    const T s_hi = static_cast<const D*>(it.s_cu)[urow + j];
    const T nu_lo = static_cast<const D*>(it.nu_cl)[urow + j];
    const T nu_hi = static_cast<const D*>(it.nu_cu)[urow + j];
    const T num_lo = has_corr ? mu - static_cast<const D*>(corr.cl)[urow + j] : mu;
    const T num_hi = has_corr ? mu - static_cast<const D*>(corr.cu)[urow + j] : mu;
    const T fl = f.fl;
    const T sig_lo = sigma_of(nu_lo, s_lo, lo.mask, f);
    const T sig_hi = sigma_of(nu_hi, s_hi, hi.mask, f);
    const T g_lo = lo.mask * (num_lo / maxp(s_lo, fl) - sig_lo * (c_lo - s_lo));
    const T g_hi = hi.mask * (num_hi / maxp(s_hi, fl) - sig_hi * (c_hi - s_hi));
    qu[j] = gu[j] - g_lo + g_hi;
    Quu[j * 2 + j] = Hu[j] + sig_lo + sig_hi + shift;
  }
  Quu[1] = T(0);
  Quu[2] = T(0);
  const T dt = T(p.dt);
  const T th = X[t * 3 + 2], cth = cos(th), sth = sin(th);
  const long long arow = static_cast<long long>(b) * N + t;
  D* A = static_cast<D*>(out.A) + arow * 9;
  D* Bm = static_cast<D*>(out.B) + arow * 6;
  const T Av[9] = {T(1), T(0), -v * sth * dt, T(0), T(1), v * cth * dt, T(0), T(0), T(1)};
  const T Bv[6] = {cth * dt, T(0), sth * dt, T(0), T(0), dt};
  for (int i = 0; i < 9; ++i) A[i] = Av[i];
  for (int i = 0; i < 6; ++i) Bm[i] = Bv[i];
  D* d = static_cast<D*>(out.d) + arow * 3;
  const D* X1 = X + (t + 1) * 3;
  d[0] = X[t * 3] + v * cth * dt - X1[0];
  d[1] = X[t * 3 + 1] + v * sth * dt - X1[1];
  d[2] = th + om * dt - X1[2];
}

// ---------------------------------------------------------------------------
// The step.

// One scenario's view of its inputs (data type D, values of type T).
template <typename D> struct Scenario {
  using T = typename Compute<D>::type;
  const D *X, *U, *dX, *dU;
  const D *s[5], *nu[5], *k[5];  // families cl, cu, xl, xu, ob; k: corrections or null
  const D *e_ob, *x0, *goal, *centers, *radii, *omask;
  Bound<T> lo[2][3];  // [0]: controls (2 used), [1]: states
  Bound<T> hi[2][3];
  T infl;
};

// Family f's box constraint value at a point: f = 0 (cl), 1 (cu) on a
// control entry, 2 (xl), 3 (xu) on a state entry; ``sub`` its component.
template <typename D, typename T = typename Compute<D>::type>
__device__ __forceinline__ T box_value(const Scenario<D>& S, int f, int sub, T z) {
  const Bound<T>& lo = S.lo[f / 2][sub];
  const Bound<T>& hi = S.hi[f / 2][sub];
  return f % 2 == 0 ? masked(z - lo.val, lo.mask) : masked(hi.val - z, hi.mask);
}

// The obstacle constraint of flat index io = r * K + k (state r + 1) at a
// point.
template <typename D, typename T = typename Compute<D>::type>
__device__ __forceinline__ Ob<T> obstacle_at(const SplitParams& p, const Scenario<D>& S, int io,
                                             T px, T py) {
  const int r = io / p.K, k = io % p.K;
  const D* ctr = S.centers + (static_cast<long long>(k) * p.N + r) * 2;
  return obstacle(px, py, T(ctr[0]), T(ctr[1]), T(S.radii[k]), S.infl, T(S.omask[k]));
}

// Every element of stage t of a scenario (state row t with its box
// families, control row t if t < N, the obstacles on state t if t >= 1),
// with its slack and dual steps (the eliminated elastic ones for the
// obstacles in elastic mode), handed to ``fn`` one at a time:
// fn(family, index in the family's row-major array, component, c, s, nu,
// mask, ds, dnu, e, de), e and de 0 outside the elastic obstacles.
template <typename D, bool EL, typename T, typename F>
__device__ __forceinline__ void stage_steps(const SplitParams& p, const Scenario<D>& S, int t,
                                            T mu, Floors<T> f, F&& fn) {
  const bool corr = S.k[0] != nullptr;
  for (int i = 0; i < 3; ++i) {
    const int ix = t * 3 + i;
    const T dx = S.dX[ix];
    for (int fam = 2; fam < 4; ++fam) {
      const T c = box_value(S, fam, i, T(S.X[ix]));
      const T mask = fam == 2 ? S.lo[1][i].mask : S.hi[1][i].mask;
      const T s = S.s[fam][ix], nu = S.nu[fam][ix];
      T ds, dnu;
      box_step(c, s, nu, mask, fam == 2 ? dx : -dx, corr ? mu - T(S.k[fam][ix]) : mu, f, ds,
               dnu);
      fn(fam, ix, i, c, s, nu, mask, ds, dnu, T(0), T(0));
    }
  }
  if (t < p.N) {
    for (int j = 0; j < 2; ++j) {
      const int iu = t * 2 + j;
      const T du = S.dU[iu];
      for (int fam = 0; fam < 2; ++fam) {
        const T c = box_value(S, fam, j, T(S.U[iu]));
        const T mask = fam == 0 ? S.lo[0][j].mask : S.hi[0][j].mask;
        const T s = S.s[fam][iu], nu = S.nu[fam][iu];
        T ds, dnu;
        box_step(c, s, nu, mask, fam == 0 ? du : -du, corr ? mu - T(S.k[fam][iu]) : mu, f, ds,
                 dnu);
        fn(fam, iu, j, c, s, nu, mask, ds, dnu, T(0), T(0));
      }
    }
  }
  if (p.K > 0 && t >= 1) {
    const T px = S.X[t * 3], py = S.X[t * 3 + 1];
    const T dpx = S.dX[t * 3], dpy = S.dX[t * 3 + 1];
    for (int io = (t - 1) * p.K; io < t * p.K; ++io) {
      const Ob<T> o = obstacle_at(p, S, io, px, py);
      const T s = S.s[4][io], nu = S.nu[4][io];
      const T jdz = o.nx * dpx + o.ny * dpy;
      T ds, dnu, e = T(0), de = T(0);
      if (EL) {
        e = S.e_ob[io];
        elastic_step(elastic_coef(o.c, s, nu, e, o.mask, mu, T(p.rho_e), f), o.mask, jdz, f, ds,
                     de, dnu);
      } else {
        box_step(o.c, s, nu, o.mask, jdz, corr ? mu - T(S.k[4][io]) : mu, f, ds, dnu);
      }
      fn(4, io, io % p.K, o.c, s, nu, o.mask, ds, dnu, e, de);
    }
  }
}

// Fraction-to-boundary ratio of one element (1 where the step does not
// decrease it).
template <typename T> __device__ __forceinline__ T ftb(T v, T dv, T tau) {
  return dv < T(0) ? -tau * v / minp(dv, T(-1e-30)) : T(1);
}

template <typename D, bool EL>
__global__ void __launch_bounds__(kWarps * kLanes)
step_kernel(const SplitParams p, const ProblemPtrs pr, const IteratePtrs it,
            const D* __restrict__ mu_in, const D* __restrict__ qx, const D* __restrict__ Amat,
            const D* __restrict__ dx, const D* __restrict__ du, const CorrPtrs corr,
            const IteratePtrs out, D* __restrict__ mu_out, D* __restrict__ alpha_out) {
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  if (b >= p.B) return;  // the whole warp leaves together
  const int N = p.N, K = p.K;
  const long long xs = static_cast<long long>(b) * (N + 1) * 3;
  const long long us = static_cast<long long>(b) * N * 2;
  const long long os = static_cast<long long>(b) * N * K;
  const long long offs[5] = {us, us, xs, xs, os};
  auto at = [](const void* ptr, long long off) { return static_cast<const D*>(ptr) + off; };
  auto put = [](void* ptr, long long off) { return static_cast<D*>(ptr) + off; };
  using T = typename Compute<D>::type;
  const Floors<T> f{T(Num<D>::floor()), T(Num<D>::sigma_max())};

  Scenario<D> S;
  S.X = at(it.states, xs);
  S.U = at(it.controls, us);
  S.dX = dx + xs;
  S.dU = du + us;
  const void* const s_in[5] = {it.s_cl, it.s_cu, it.s_xl, it.s_xu, it.s_ob};
  const void* const nu_in[5] = {it.nu_cl, it.nu_cu, it.nu_xl, it.nu_xu, it.nu_ob};
  const void* const k_in[5] = {corr.cl, corr.cu, corr.xl, corr.xu, corr.ob};
  for (int fam = 0; fam < 5; ++fam) {
    S.s[fam] = at(s_in[fam], offs[fam]);
    S.nu[fam] = at(nu_in[fam], offs[fam]);
    S.k[fam] = k_in[fam] != nullptr ? at(k_in[fam], offs[fam]) : nullptr;
  }
  S.e_ob = at(it.e_ob, os);
  S.x0 = at(pr.x0, b * 3);
  S.goal = at(pr.goal, b * 3);
  S.centers = at(pr.centers, static_cast<long long>(b) * K * N * 2);
  S.radii = at(pr.radii, static_cast<long long>(b) * K);
  S.omask = at(pr.omask, static_cast<long long>(b) * K);
  S.infl = *at(pr.infl, b);
  for (int j = 0; j < 3; ++j) {
    S.lo[0][j] = bound(j < 2 ? T(*at(pr.cl, b * 2 + j)) : T(0));
    S.hi[0][j] = bound(j < 2 ? T(*at(pr.cu, b * 2 + j)) : T(0));
    S.lo[1][j] = bound(T(*at(pr.xl, b * 3 + j)));
    S.hi[1][j] = bound(T(*at(pr.xu, b * 3 + j)));
  }
  const T mu = mu_in[b];
  const T tau = T(p.tau);

  // Pass 1: fractions to the boundary, the largest dual, the step's norm.
  T a_s = T(1), a_nu = T(1), nu_max = T(0), step_inf = T(0);
  for (int t = lane; t <= N; t += kLanes) {
    for (int i = 0; i < 3; ++i) step_inf = maxp(step_inf, T(fabs(S.dX[t * 3 + i])));
    if (t < N)
      for (int j = 0; j < 2; ++j) step_inf = maxp(step_inf, T(fabs(S.dU[t * 2 + j])));
    stage_steps<D, EL>(p, S, t, mu, f, [&](int fam, int, int, T, T s, T nu, T mask, T ds, T dnu,
                                        T e, T de) {
      a_s = minp(a_s, ftb(s, ds, tau));
      a_nu = minp(a_nu, ftb(nu, dnu, tau));
      nu_max = maxp(nu_max, mask * nu);
      if (EL && fam == 4) a_s = minp(a_s, ftb(e, de, tau));
    });
  }
  a_s = warp_min(a_s);
  a_nu = warp_min(a_nu);
  nu_max = warp_max(nu_max);
  step_inf = warp_max(step_inf);

  // The penalty weight: dominate the duals and the dynamics adjoints (one
  // adjoint sweep of the condensed gradients), on lane 0.
  T rho = T(0);
  if (lane == 0) {
    const D* q = qx + xs;
    const D* A = Amat + static_cast<long long>(b) * N * 9;
    T lam[3] = {q[N * 3], q[N * 3 + 1], q[N * 3 + 2]};
    T lam_max = maxp(maxp(T(fabs(lam[0])), T(fabs(lam[1]))), T(fabs(lam[2])));
    for (int t = N - 1; t >= 0; --t) {
      const D* At = A + t * 9;
      T nl[3];
      for (int i = 0; i < 3; ++i)
        nl[i] = q[t * 3 + i] + (At[i] * lam[0] + At[3 + i] * lam[1] + At[6 + i] * lam[2]);
      for (int i = 0; i < 3; ++i) {
        lam[i] = nl[i];
        lam_max = maxp(lam_max, T(fabs(nl[i])));
      }
    }
    rho = maxp(T(2) * maxp(nu_max, lam_max), T(p.merit_penalty));
  }
  rho = __shfl_sync(kFull, rho, 0);

  // Pass 2: the merit at alpha = 0 and at every candidate, in one pass:
  // per candidate the objective, the log barrier and the l1 residuals
  // (defects, pin, consistency of every family).
  const int nc = 1 + p.ls_iters;
  T cand[kMaxCand], obj[kMaxCand], logs[kMaxCand], res[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c) {
    cand[c] = c == 0 ? T(0) : a_s * T(pow(T(p.ls_backtrack), T(c - 1)));
    obj[c] = logs[c] = res[c] = T(0);
  }
  const T w[3] = {T(p.w0), T(p.w1), T(p.w2)};
  const T dt = T(p.dt), rho_e = T(p.rho_e);
  for (int t = lane; t <= N; t += kLanes) {
    const T gm = goal_row(t, N, p.exclude_terminal) ? T(1) : T(0);
#pragma unroll
    for (int c = 0; c < kMaxCand; ++c) {
      if (c < nc) {
        const T a = cand[c];
        T xa[3];
        for (int i = 0; i < 3; ++i) {
          xa[i] = S.X[t * 3 + i] + a * S.dX[t * 3 + i];
          const T err = xa[i] - S.goal[i];
          obj[c] += gm * (err * err) * w[i];
          if (t == 0) res[c] += fabs(S.x0[i] - xa[i]);
        }
        if (t < N) {
          const T v = S.U[t * 2] + a * S.dU[t * 2];
          const T om = S.U[t * 2 + 1] + a * S.dU[t * 2 + 1];
          const T nv = minp(v, T(0)), pv = maxp(v, T(0));
          obj[c] += p.reverse_squared ? T(p.w_neg) * (nv * nv) : T(p.w_neg) * nv;
          obj[c] += T(p.w_pos) * (pv * pv) + T(p.w_ang) * (om * om);
          const int n1 = (t + 1) * 3;
          res[c] += fabs(xa[0] + v * cos(xa[2]) * dt - (S.X[n1] + a * S.dX[n1]));
          res[c] += fabs(xa[1] + v * sin(xa[2]) * dt - (S.X[n1 + 1] + a * S.dX[n1 + 1]));
          res[c] += fabs(xa[2] + om * dt - (S.X[n1 + 2] + a * S.dX[n1 + 2]));
        }
      }
    }
    stage_steps<D, EL>(p, S, t, mu, f, [&](int fam, int idx, int sub, T, T s, T, T mask, T ds, T,
                                        T e, T de) {
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c) {
        if (c < nc) {
          const T a = cand[c];
          const T sa = s + a * ds;
          logs[c] += mask * log(maxp(sa, T(1e-30)));
          T ca;
          if (fam < 2) {
            ca = box_value(S, fam, sub, S.U[idx] + a * S.dU[idx]);
          } else if (fam < 4) {
            ca = box_value(S, fam, sub, S.X[idx] + a * S.dX[idx]);
          } else {
            const int n1 = (idx / K + 1) * 3;
            ca = obstacle_at(p, S, idx, S.X[n1] + a * S.dX[n1], S.X[n1 + 1] + a * S.dX[n1 + 1]).c;
          }
          if (EL && fam == 4) {
            const T ea = e + a * de;
            logs[c] += mask * log(maxp(ea, T(1e-30)));
            obj[c] += rho_e * (mask * ea);
            res[c] += mask * fabs(ca + ea - sa);
          } else {
            res[c] += mask * fabs(ca - sa);
          }
        }
      }
    });
  }
  T merit[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c)
    if (c < nc) merit[c] = warp_sum(obj[c]) - mu * warp_sum(logs[c]) + rho * warp_sum(res[c]);

  // Acceptance: the largest candidate whose merit does not rise beyond
  // rounding noise plus, in the small-step Newton regime only, the
  // curvature budget; else the deepest one if its merit is finite; else 0.
  const T m0 = merit[0];
  const bool newton = step_inf < T(Num<D>::newton());
  const T tol = T(16.0 * Num<D>::eps()) * (T(1) + fabs(m0)) +
                (newton ? T(10) * rho * step_inf * step_inf : T(0));
  int idx = 0;
  bool any_ok = false;
  T alpha = T(0), deepest = T(0);
  bool deepest_finite = false;
#pragma unroll
  for (int c = 1; c < kMaxCand; ++c) {
    if (c < nc) {
      const bool ok = isfin(merit[c]) && merit[c] <= m0 + tol;
      if (ok && !any_ok) {
        any_ok = true;
        idx = c - 1;
        alpha = cand[c];
      }
      if (c == nc - 1) {
        deepest = cand[c];
        deepest_finite = isfin(merit[c]);
      }
    }
  }
  if (!any_ok) alpha = deepest_finite ? deepest : T(0);
  a_nu = minp(a_nu, alpha);

  // Pass 3: the update, the dual clamp, and the new mean complementarity.
  void* const s_out[5] = {out.s_cl, out.s_cu, out.s_xl, out.s_xu, out.s_ob};
  void* const nu_out[5] = {out.nu_cl, out.nu_cu, out.nu_xl, out.nu_xu, out.nu_ob};
  D* const X_out = put(out.states, xs);
  D* const U_out = put(out.controls, us);
  D* const e_out = put(out.e_ob, os);
  T tot = T(0), cnt = T(0);
  for (int t = lane; t <= N; t += kLanes) {
    for (int i = 0; i < 3; ++i) X_out[t * 3 + i] = S.X[t * 3 + i] + alpha * S.dX[t * 3 + i];
    if (t < N)
      for (int j = 0; j < 2; ++j) U_out[t * 2 + j] = S.U[t * 2 + j] + alpha * S.dU[t * 2 + j];
    stage_steps<D, EL>(p, S, t, mu, f, [&](int fam, int idx, int, T, T s, T nu, T mask, T ds, T dnu,
                                        T e, T de) {
      const T sn = s + alpha * ds;
      const T center = mu / maxp(sn, f.fl);
      const T nn = mask * minp(maxp(nu + a_nu * dnu, center / T(1e10)), center * T(1e10));
      put(s_out[fam], offs[fam])[idx] = sn;
      put(nu_out[fam], offs[fam])[idx] = nn;
      tot += mask * sn * nn;
      cnt += mask;
      if (fam == 4) e_out[idx] = EL ? e + alpha * de : S.e_ob[idx];
    });
  }
  tot = warp_sum(tot);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    const T reg = *at(it.reg, b), sigma = *at(it.sigma, b);
    const bool grow = !any_ok || (idx >= 4 && !newton);
    *put(out.reg, b) = grow ? minp(maxp(reg, T(p.reg)) * T(8), T(1e8)) : maxp(reg / T(3), T(p.reg));
    T sig = sigma;
    if (p.adaptive_sigma)
      sig = (alpha < T(0.25) && !newton) ? minp(sigma * T(1.5), T(p.sigma_cap))
                                         : maxp(sigma * T(0.9), T(p.mu_sigma));
    *put(out.sigma, b) = sig;
    const T comp = tot / maxp(cnt, T(1));
    mu_out[b] = p.raw_mu ? comp : clipp(sig * comp, T(p.mu_floor), T(p.mu_init));
    alpha_out[b] = alpha;
  }
}

template <typename T, bool EL>
cudaError_t launch_condense(const SplitParams& p, const ProblemPtrs& pr, const IteratePtrs& it,
                            const void* mu, const CorrPtrs& corr, const LqrPtrs& out,
                            cudaStream_t stream) {
  const long long threads = static_cast<long long>(p.B) * (p.N + 1);
  const int blocks = static_cast<int>((threads + kCondenseThreads - 1) / kCondenseThreads);
  condense_kernel<T, EL><<<blocks, kCondenseThreads, 0, stream>>>(
      p, pr, it, static_cast<const T*>(mu), corr, out);
  return cudaGetLastError();
}

template <typename T, bool EL>
cudaError_t launch_step(const SplitParams& p, const ProblemPtrs& pr, const IteratePtrs& it,
                        const void* mu, const void* qx, const void* A, const void* dx,
                        const void* du, const CorrPtrs& corr, const IteratePtrs& out,
                        void* mu_out, void* alpha_out, cudaStream_t stream) {
  const int blocks = (p.B + kWarps - 1) / kWarps;
  step_kernel<T, EL><<<blocks, kWarps * kLanes, 0, stream>>>(
      p, pr, it, static_cast<const T*>(mu), static_cast<const T*>(qx),
      static_cast<const T*>(A), static_cast<const T*>(dx), static_cast<const T*>(du), corr, out,
      static_cast<T*>(mu_out), static_cast<T*>(alpha_out));
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
  return static_cast<int>(err);
}

template <typename T>
int step(const SplitParams* params, const ProblemPtrs* pr, const IteratePtrs* it, const void* mu,
         const void* qx, const void* A, const void* dx, const void* du, const CorrPtrs* corr,
         const IteratePtrs* out, void* mu_out, void* alpha_out, void* stream) {
  const SplitParams p = *params;
  if (p.B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.elastic && p.K > 0
          ? launch_step<T, true>(p, *pr, *it, mu, qx, A, dx, du, *corr, *out, mu_out, alpha_out, s)
          : launch_step<T, false>(p, *pr, *it, mu, qx, A, dx, du, *corr, *out, mu_out, alpha_out,
                                  s);
  return static_cast<int>(err);
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
                                      const CorrPtrs* corr, const IteratePtrs* out, void* mu_out,
                                      void* alpha_out, void* stream) {
  return step<float>(p, pr, it, mu, qx, A, dx, du, corr, out, mu_out, alpha_out, stream);
}

extern "C" int kissmpc_split_step_f64(const SplitParams* p, const ProblemPtrs* pr,
                                      const IteratePtrs* it, const void* mu, const void* qx,
                                      const void* A, const void* dx, const void* du,
                                      const CorrPtrs* corr, const IteratePtrs* out, void* mu_out,
                                      void* alpha_out, void* stream) {
  return step<double>(p, pr, it, mu, qx, A, dx, du, corr, out, mu_out, alpha_out, stream);
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
