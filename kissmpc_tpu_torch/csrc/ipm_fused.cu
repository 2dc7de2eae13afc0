// The whole fixed-iteration primal-dual IPM of the unicycle MPC, one launch
// per batched solve, for Hopper (sm_90a).
//
// Replaces: kissmpc_tpu/ops/pallas/ipm_fused.py::ipm_fused_kernel, the TPU
// kernel behind the "fused" solve backend.  Contract: ops/ipm_fused.py's
// plain version (`_plain`), which follows this kernel line by line.  Per
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
// e lives in its own K*N scratch rows, starts at max(s - c, mu / rho_e),
// and the condensation takes the eliminated stiffness
// sig_eff = (1/sig_s + 1/sig_e)^-1 with sig_e = mu / e^2.  The eliminated
// step (ds, de, dnu) is recomputed from the iterate wherever it is needed
// (fraction to the boundary, each line-search candidate, the update) rather
// than stored; e joins the fraction to the boundary, and the merit gains
// log e, rho_e * e and |c + e - s|.
//
// What bounds it: operations.  Its device-memory input and output is about
// 2 KB per scenario (27 problem rows, the warm start, the tracks, the
// solution and 6 diagnostics), while each iteration does tens of thousands
// of flops per scenario: the condensation, two sweeps, and one merit pass
// per line-search candidate, each with its sin, cos, sqrt and log.
//
// Design.  One thread per scenario, the time loops inside the thread.
// Every [T, BT] whole-plane op of the TPU kernel is a loop over t; the
// families, gradient coefficients and condensation are computed inside the
// backward sweep, stage by stage, so no stage rows are staged; each
// line-search candidate is one pass over t that accumulates objective,
// equality residuals, log barrier and obstacle consistency with no trial
// planes stored; the update and the dual clamp are one pass over the
// families.  The sweeps keep P, p and the adjoint in registers.  The
// iterate state that does not fit there (slacks and duals of every family,
// gains, the Newton direction; ~2,500 floats per scenario at N = 50, K = 8)
// lives in a global scratch that the wrapper allocates, with the solution
// outputs doubling as the trajectory iterate.  Every plane is laid out
// scenario-minor, element (row r, scenario b) at r * B + b, so the 32
// threads of a warp read one 128-byte line on each access.  The ragged
// edge is masked by b < B; nothing is padded.
//
// This first version is latency-bound: ~62 one-thread scenarios per SM at
// B = 8192, and the refine stages run their 64-128 iterations one after
// another on small sub-batches.  Making it fast is later work.
//
// The iteration count is read from device memory (`iters`), and the
// per-scenario centering sigma is an input row, so one build serves every
// refine stage.  Compiled without fast math: the safety logic needs IEEE
// sqrtf, logf, sinf, cosf and division (the non-finite merit guard, the
// freeze of a lane whose deepest trial was non-finite, sqrt(d^2 + 1e-16),
// log(max(s, 1e-30)), the fraction-to-boundary denominator
// min(dv, -1e-30)).  Max, min and clip propagate NaN, as jnp's and
// torch's do.
//
// TPU artefacts left behind: sublane packing and its tiling copies, the
// tree reductions (a plain sequential sum in the thread), the Mosaic
// scatter-add workaround, the staging of per-time rows that Mosaic needed
// for dynamic indexing, the VMEM placement shim, the 128-lane tile and the
// batch padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

namespace {

constexpr int kThreads = 32;
constexpr float kFloor = 1e-10f;     // slack floor in sigma = nu / s
constexpr float kSigmaMax = 1e12f;   // sigma safeguard
constexpr float kKappa = 1e10f;      // dual clamp around mu / s
constexpr float kEps = 1.1920929e-07f;

// Scratch rows per scenario: slacks and duals of the control families
// (4N each), of the state families (6(N+1) each), of the obstacles (KN
// each), the gains (8N), dx (3(N+1)) and du (2N); with elastic obstacles,
// their e (KN) last.
__host__ __device__ inline int scratch_rows(int N, int K, bool elastic) {
  return 18 * N + 15 * (N + 1) + (elastic ? 3 : 2) * K * N;
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

// One scenario's view of a scenario-minor [rows, B] plane.
struct Rows {
  float* p;
  size_t B;
  __device__ float& operator[](int r) const { return p[static_cast<size_t>(r) * B]; }
};

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

struct ElStep {  // its eliminated Newton step
  float ds, de, dnu;
};

template <bool ELASTIC>
__global__ void __launch_bounds__(kThreads) ipm_fused_kernel(
    const int* __restrict__ iters_in, const float* __restrict__ scal_in,
    const float* __restrict__ warm_in, const float* __restrict__ tx_in,
    const float* __restrict__ ty_in, const float* __restrict__ obinfo_in,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ th_out, float* __restrict__ v_out,
    float* __restrict__ w_out, float* __restrict__ diag_out,
    float* __restrict__ scratch, const FusedParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int N = p.N, K = p.K, T1 = N + 1;
  const size_t B = static_cast<size_t>(p.B);
  const float dt = p.dt;
  auto plane = [&](const float* base, size_t row0) {
    return Rows{const_cast<float*>(base) + row0 * B + b, B};
  };
  const Rows scal = plane(scal_in, 0), warm = plane(warm_in, 0);
  const Rows TXI = plane(tx_in, 0), TYI = plane(ty_in, 0), OBI = plane(obinfo_in, 0);
  const Rows X = plane(x_out, 0), Y = plane(y_out, 0), TH = plane(th_out, 0);
  const Rows V = plane(v_out, 0), W = plane(w_out, 0), DG = plane(diag_out, 0);
  size_t off = 0;
  auto take = [&](int rows) {
    const Rows r = plane(scratch, off);
    off += static_cast<size_t>(rows);
    return r;
  };
  const Rows Sc = take(4 * N), NUc = take(4 * N);         // vl, vu, wl, wu
  const Rows Sx = take(6 * T1), NUx = take(6 * T1);       // xl0..2, xu0..2
  const Rows Sob = take(K * N), NUob = take(K * N);       // k-major
  const Rows KK = take(8 * N);                            // K00..K12, k0, k1
  const Rows DX = take(3 * T1), DU = take(2 * N);         // Newton direction
  const Rows Eob = take(ELASTIC ? K * N : 0);             // elastic e, k-major

  // --- problem rows ----------------------------------------------------
  const float x0 = scal[0], y0 = scal[1], th0 = scal[2];
  const float gx = scal[3], gy = scal[4], gth = scal[5];
  const float v_lb = scal[6], v_ub = scal[7], w_lb = scal[8], w_ub = scal[9];
  const float m_vl = scal[10], m_vu = scal[11], m_wl = scal[12], m_wu = scal[13];
  float xlb[3], xub[3], m_xl[3], m_xu[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xlb[i] = scal[14 + i];
    xub[i] = scal[17 + i];
    m_xl[i] = scal[20 + i];
    m_xu[i] = scal[23 + i];
  }
  const float sig_row = scal[26];
  const float infl = K > 0 ? OBI[2 * K] : 0.f;
  const float w0 = p.w0, w1 = p.w1, w2 = p.w2;

  auto gm = [&](int t) {  // goal-cost weight of state t
    return (t >= 1 && (!p.exclude_terminal || t <= N - 1)) ? 1.f : 0.f;
  };
  // Obstacle k at column tt (state tt + 1), seen from the point (px, py).
  auto geo = [&](int k, int tt, float px, float py) {
    float cx, cy;
    if (p.affine) {
      cx = TXI[k] + static_cast<float>(tt) * TXI[K + k];
      cy = TYI[k] + static_cast<float>(tt) * TYI[K + k];
    } else {
      cx = TXI[k * N + tt];
      cy = TYI[k * N + tt];
    }
    const float dxk = px - cx, dyk = py - cy;
    const float dist = sqrtf(dxk * dxk + dyk * dyk + 1e-16f);
    const float ds_safe = maxp(dist, 1e-2f);
    return Geo{dist - (OBI[k] + infl), dxk / ds_safe, dyk / ds_safe};
  };
  auto dyn = [&](int t) {
    const float ct = cosf(TH[t]), st = sinf(TH[t]), v = V[t];
    return Dyn{-v * st * dt, v * ct * dt, ct * dt, st * dt,
               X[t] + v * ct * dt - X[t + 1], Y[t] + v * st * dt - Y[t + 1],
               TH[t] + W[t] * dt - TH[t + 1]};
  };
  // Visits every inequality element at the current iterate, in the order
  // controls (vl, vu, wl, wu), states (xl_i, xu_i), obstacles:
  // fn(c, s, nu, mask, J dz, row) with s and nu writable; row is the
  // obstacle element's scratch row, -1 for a box element.
  auto visit = [&](auto&& fn) {
    for (int t = 0; t < N; ++t) {
      const float v = V[t], w = W[t], dv = DU[t], dw = DU[N + t];
      fn(v - v_lb, Sc[t], NUc[t], m_vl, dv, -1);
      fn(v_ub - v, Sc[N + t], NUc[N + t], m_vu, -dv, -1);
      fn(w - w_lb, Sc[2 * N + t], NUc[2 * N + t], m_wl, dw, -1);
      fn(w_ub - w, Sc[3 * N + t], NUc[3 * N + t], m_wu, -dw, -1);
    }
    for (int t = 0; t <= N; ++t) {
      const float comp[3] = {X[t], Y[t], TH[t]};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float d = DX[i * T1 + t];
        fn(comp[i] - xlb[i], Sx[i * T1 + t], NUx[i * T1 + t], m_xl[i], d, -1);
        fn(xub[i] - comp[i], Sx[(3 + i) * T1 + t], NUx[(3 + i) * T1 + t],
           m_xu[i], -d, -1);
      }
    }
    for (int k = 0; k < K; ++k) {
      const float om = OBI[K + k];
      for (int tt = 0; tt < N; ++tt) {
        const Geo g = geo(k, tt, X[tt + 1], Y[tt + 1]);
        fn(g.c, Sob[k * N + tt], NUob[k * N + tt], om,
           g.nx * DX[tt + 1] + g.ny * DX[T1 + tt + 1], k * N + tt);
      }
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
  auto el_step = [&](const ElCoef& q, float m, float jdz) {
    const float beta = q.sig_e / maxp(q.sig_s + q.sig_e, kFloor);
    const float ds = m * beta * (jdz + q.r_c + (q.T - q.r_e) / q.sig_e);
    return ElStep{ds, m * (q.T - q.r_e - q.sig_s * ds) / q.sig_e, m * (q.T - q.sig_s * ds)};
  };

  // Merit components at z + a dz, with the slack steps of the current
  // iterate: objective, equality residuals (defects and initial-state pin),
  // the log barrier of every family and the obstacle consistency.  The box
  // families' consistency is affine along the step, (1 - a) * consist0,
  // and is added by the caller.  ``mu`` enters only the elastic step.
  auto merit_pass = [&](float a, float mu) {
    float s_goal = 0.f, s_neg = 0.f, s_pos = 0.f, s_ang = 0.f, s_el = 0.f;
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, lg = 0.f, cons = 0.f;
    float pin0 = 0.f, pin1 = 0.f, pin2 = 0.f;
    float xp = 0.f, yp = 0.f, thp = 0.f, vp = 0.f, wp = 0.f;  // trial step t-1
    for (int t = 0; t <= N; ++t) {
      const float comp[3] = {X[t], Y[t], TH[t]};
      const float dz[3] = {DX[t], DX[T1 + t], DX[2 * T1 + t]};
      const float xs = comp[0] + a * dz[0], ys = comp[1] + a * dz[1];
      const float ths = comp[2] + a * dz[2];
      const float ex = xs - gx, ey = ys - gy, eth = ths - gth;
      s_goal += gm(t) * (w0 * ex * ex + w1 * ey * ey + w2 * eth * eth);
      if (t == 0) {
        pin0 = fabsf(x0 - xs);
        pin1 = fabsf(y0 - ys);
        pin2 = fabsf(th0 - ths);
      } else {
        const float ct = cosf(thp), st = sinf(thp);
        e0 += fabsf(xp + vp * ct * dt - xs);
        e1 += fabsf(yp + vp * st * dt - ys);
        e2 += fabsf(thp + wp * dt - ths);
        for (int k = 0; k < K; ++k) {
          const float om = OBI[K + k];
          const Geo g = geo(k, t - 1, comp[0], comp[1]);
          const int r = k * N + t - 1;
          const float s = Sob[r], jdz = g.nx * dz[0] + g.ny * dz[1];
          if (ELASTIC) {
            const float e = Eob[r];
            const ElStep st = el_step(el_coef(g.c, s, NUob[r], e, om, mu), om, jdz);
            const float ts = s + a * st.ds, te = e + a * st.de;
            lg += om * logf(maxp(ts, 1e-30f));
            lg += om * logf(maxp(te, 1e-30f));
            s_el += om * te;
            cons += om * fabsf(geo(k, t - 1, xs, ys).c + te - ts);
          } else {
            const float ts = s + a * (om * (jdz + g.c - s));
            lg += om * logf(maxp(ts, 1e-30f));
            cons += om * fabsf(geo(k, t - 1, xs, ys).c - ts);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float sl = Sx[i * T1 + t], su = Sx[(3 + i) * T1 + t];
        const float cl = comp[i] - xlb[i], cu = xub[i] - comp[i];
        const float dsl = m_xl[i] * (dz[i] + cl - sl);
        const float dsu = m_xu[i] * (-dz[i] + cu - su);
        lg += m_xl[i] * logf(maxp(sl + a * dsl, 1e-30f));
        lg += m_xu[i] * logf(maxp(su + a * dsu, 1e-30f));
      }
      if (t < N) {
        const float vc = V[t], wc = W[t], dv = DU[t], dw = DU[N + t];
        const float vs = vc + a * dv, ws = wc + a * dw;
        const float neg = minp(vs, 0.f), pos = maxp(vs, 0.f);
        s_neg += p.reverse_squared ? neg * neg : neg;
        s_pos += pos * pos;
        s_ang += ws * ws;
        const float cc[4] = {vc - v_lb, v_ub - vc, wc - w_lb, w_ub - wc};
        const float jd[4] = {dv, -dv, dw, -dw};
        const float mm[4] = {m_vl, m_vu, m_wl, m_wu};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float s = Sc[f * N + t];
          const float ds = mm[f] * (jd[f] + cc[f] - s);
          lg += mm[f] * logf(maxp(s + a * ds, 1e-30f));
        }
        xp = xs;
        yp = ys;
        thp = ths;
        vp = vs;
        wp = ws;
      }
    }
    float obj = s_goal;
    obj = obj + p.w_neg * s_neg;
    obj = obj + p.w_pos * s_pos;
    obj = obj + p.w_ang * s_ang;
    if (ELASTIC) obj = obj + p.rho_e * s_el;
    return Merit{obj, e0 + e1 + e2 + pin0 + pin1 + pin2, lg, cons};
  };

  // Complementarity sum, mask count, largest dual and box consistency at
  // the current iterate.
  struct Red {
    float tot, cnt, nu_max, cons_box;
  };
  auto reduce = [&]() {
    Red r{0.f, 0.f, 0.f, 0.f};
    visit([&](float c, float& s, float& nu, float m, float, int row) {
      r.tot += m * s * nu;
      r.cnt += m;
      r.nu_max = maxp(r.nu_max, m * nu);
      if (row < 0) r.cons_box += m * fabsf(c - s);
    });
    return r;
  };

  // --- init from the warm start ------------------------------------------
  for (int t = 0; t < T1; ++t) {
    X[t] = warm[t];
    Y[t] = warm[T1 + t];
    TH[t] = warm[2 * T1 + t];
    DX[t] = DX[T1 + t] = DX[2 * T1 + t] = 0.f;
  }
  for (int t = 0; t < N; ++t) {
    V[t] = warm[3 * T1 + t];
    W[t] = warm[3 * T1 + N + t];
    DU[t] = DU[N + t] = 0.f;
  }
  visit([&](float c, float& s, float& nu, float m, float, int row) {
    if (m > 0.f) {
      s = maxp(c, 1e-2f);
      nu = p.mu_init / s;
    } else {
      s = 1.f;
      nu = 0.f;
    }
    // Central-ish elastic init: e solves c + e = s where violated, else
    // sits at mu / rho_e.
    if (ELASTIC && row >= 0) Eob[row] = m > 0.f ? maxp(s - c, p.mu_init / p.rho_e) : 1.f;
  });
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

  struct StateQ {  // condensed stage of state t: Hessian diag, (x, y), gradient
    float Q[3], Qxy, q[3];
  };
  struct CtrlQ {  // condensed stage of control t
    float Qv, Qw, qv, qw;
  };
  const float goal[3] = {gx, gy, gth}, wgoal[3] = {w0, w1, w2};
  auto state_stage = [&](int t, float mu, float reg) {
    const float comp[3] = {X[t], Y[t], TH[t]};
    const float g = gm(t);
    StateQ S;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S.q[i] = 2.f * g * wgoal[i] * (comp[i] - goal[i]);
      S.Q[i] = 2.f * g * wgoal[i];
      const int rl = i * T1 + t, ru = (3 + i) * T1 + t;
      const float sl = Sx[rl], nul = NUx[rl], su = Sx[ru], nuu = NUx[ru];
      const float sgl = sigma(nul, sl, m_xl[i]), sgu = sigma(nuu, su, m_xu[i]);
      const float gl = m_xl[i] * (mu / maxp(sl, kFloor) - sgl * ((comp[i] - xlb[i]) - sl));
      const float gu = m_xu[i] * (mu / maxp(su, kFloor) - sgu * ((xub[i] - comp[i]) - su));
      S.q[i] = S.q[i] - gl + gu;
      S.Q[i] = S.Q[i] + sgl + sgu;
    }
    S.Qxy = 0.f;
    if (t >= 1 && K > 0) {
      float addx = 0.f, addy = 0.f, a00 = 0.f, a01 = 0.f, a11 = 0.f;
      for (int k = 0; k < K; ++k) {
        const float om = OBI[K + k];
        const Geo G = geo(k, t - 1, comp[0], comp[1]);
        const float s = Sob[k * N + t - 1], nu = NUob[k * N + t - 1];
        float sg, gc;
        if (ELASTIC) {
          const ElCoef q = el_coef(G.c, s, nu, Eob[k * N + t - 1], om, mu);
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
        addx += -G.nx * gc;
        addy += -G.ny * gc;
        a00 += h00;
        a01 += h01;
        a11 += h11;
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
    const float cc[4] = {v - v_lb, v_ub - v, w - w_lb, w_ub - w};
    const float mm[4] = {m_vl, m_vu, m_wl, m_wu};
    float g[4], sg[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float s = Sc[f * N + t], nu = NUc[f * N + t];
      sg[f] = sigma(nu, s, mm[f]);
      g[f] = mm[f] * (mu / maxp(s, kFloor) - sg[f] * (cc[f] - s));
    }
    return CtrlQ{Hv + sg[0] + sg[1] + reg, 2.f * p.w_ang + sg[2] + sg[3] + reg,
                 grad_v(v) - g[0] + g[1], 2.f * p.w_ang * w - g[2] + g[3]};
  };

  float reg = p.reg, sig_c = sig_row;
  const int iters = *iters_in;
  for (int it = 0; it < iters; ++it) {
    const Red r = reduce();
    const float mu = clipp(sig_c * r.tot / maxp(r.cnt, 1.f), p.mu_floor, p.mu_init);

    // --- backward Riccati sweep, condensing each stage on the way ---------
    StateQ S = state_stage(N, mu, reg);
    float P00 = S.Q[0], P01 = S.Qxy, P02 = 0.f, P11 = S.Q[1], P12 = 0.f, P22 = S.Q[2];
    float p0 = S.q[0], p1 = S.q[1], p2 = S.q[2];
    float l0 = p0, l1 = p1, l2 = p2;  // adjoint estimate of the dynamics duals
    float lam_max = maxp(fabsf(p0), maxp(fabsf(p1), fabsf(p2)));
    for (int t = N - 1; t >= 0; --t) {
      const Dyn D = dyn(t);
      const CtrlQ C = ctrl_stage(t, mu, reg);
      S = state_stage(t, mu, reg);
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

    // --- forward rollout ---------------------------------------------------
    float dx0 = x0 - X[0], dx1 = y0 - Y[0], dx2 = th0 - TH[0];
    DX[0] = dx0;
    DX[T1] = dx1;
    DX[2 * T1] = dx2;
    float step_inf = maxp(0.f, maxp(fabsf(dx0), maxp(fabsf(dx1), fabsf(dx2))));
    for (int t = 0; t < N; ++t) {
      const float du0 = KK[t] * dx0 + KK[N + t] * dx1 + KK[2 * N + t] * dx2 + KK[6 * N + t];
      const float du1 =
          KK[3 * N + t] * dx0 + KK[4 * N + t] * dx1 + KK[5 * N + t] * dx2 + KK[7 * N + t];
      DU[t] = du0;
      DU[N + t] = du1;
      const Dyn D = dyn(t);
      const float n0 = dx0 + D.a02 * dx2 + D.b00 * du0 + D.d0;
      const float n1 = dx1 + D.a12 * dx2 + D.b10 * du0 + D.d1;
      const float n2 = dx2 + dt * du1 + D.d2;
      dx0 = n0;
      dx1 = n1;
      dx2 = n2;
      DX[t + 1] = dx0;
      DX[T1 + t + 1] = dx1;
      DX[2 * T1 + t + 1] = dx2;
      step_inf = maxp(step_inf, maxp(maxp(fabsf(du0), fabsf(du1)),
                                     maxp(fabsf(dx0), maxp(fabsf(dx1), fabsf(dx2)))));
    }

    // --- slack / dual steps: fraction to the boundary ----------------------
    float alpha_s = 1.f, alpha_nu = 1.f;
    visit([&](float c, float& s, float& nu, float m, float jdz, int row) {
      if (ELASTIC && row >= 0) {
        const float e = Eob[row];
        const ElStep st = el_step(el_coef(c, s, nu, e, m, mu), m, jdz);
        alpha_s = minp(alpha_s, ftb(s, st.ds));
        alpha_s = minp(alpha_s, ftb(e, st.de));
        alpha_nu = minp(alpha_nu, ftb(nu, st.dnu));
        return;
      }
      const float ds = m * (jdz + c - s);
      const float dnu = m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds);
      alpha_s = minp(alpha_s, ftb(s, ds));
      alpha_nu = minp(alpha_nu, ftb(nu, dnu));
    });
    // l1 penalty: dominate the inequality duals and the dynamics adjoints.
    const float rho = maxp(p.merit_penalty, 2.f * maxp(r.nu_max, lam_max));

    // --- merit line search -------------------------------------------------
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
    // finite; a frozen lane keeps its merit components.
    const bool keep = found || fin_last;
    const float alpha = keep ? alpha_best : 0.f;
    if (keep) {
      m_obj = s_obj;
      m_log = s_log;
      m_eqc = s_eqc;
    }
    alpha_nu = minp(alpha_nu, alpha);

    // --- updates with the dual clamp -----------------------------------------
    visit([&](float c, float& s, float& nu, float m, float jdz, int row) {
      float ds, dnu;
      if (ELASTIC && row >= 0) {
        const ElStep st = el_step(el_coef(c, s, nu, Eob[row], m, mu), m, jdz);
        ds = st.ds;
        dnu = st.dnu;
        Eob[row] = Eob[row] + alpha * st.de;
      } else {
        ds = m * (jdz + c - s);
        dnu = m * (mu / maxp(s, kFloor) - nu - sigma(nu, s, m) * ds);
      }
      const float s_new = s + alpha * ds;
      const float center = mu / maxp(s_new, kFloor);
      nu = m * clipp(nu + alpha_nu * dnu, center / kKappa, center * kKappa);
      s = s_new;
    });
    for (int t = 0; t <= N; ++t) {
      X[t] = X[t] + alpha * DX[t];
      Y[t] = Y[t] + alpha * DX[T1 + t];
      TH[t] = TH[t] + alpha * DX[2 * T1 + t];
    }
    for (int t = 0; t < N; ++t) {
      V[t] = V[t] + alpha * DU[t];
      W[t] = W[t] + alpha * DU[N + t];
    }
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
  float nu_sum = 0.f, nu_cnt = 0.f, viol = 0.f, comp = 0.f, tot = 0.f;
  visit([&](float c, float& s, float& nu, float m, float, int) {
    nu_sum += m * fabsf(nu);
    nu_cnt += m;
    viol = maxp(viol, m * maxp(-c, 0.f));
    comp = maxp(comp, m * fabsf(s * nu));
    tot += m * s * nu;
  });
  float s_goal = 0.f, s_neg = 0.f, s_pos = 0.f, s_ang = 0.f, feas = 0.f;
  for (int t = 0; t <= N; ++t) {
    const float ex = X[t] - gx, ey = Y[t] - gy, eth = TH[t] - gth;
    s_goal += gm(t) * (w0 * ex * ex + w1 * ey * ey + w2 * eth * eth);
  }
  for (int t = 0; t < N; ++t) {
    const float v = V[t], neg = minp(v, 0.f), pos = maxp(v, 0.f);
    s_neg += p.reverse_squared ? neg * neg : neg;
    s_pos += pos * pos;
    s_ang += W[t] * W[t];
    const Dyn D = dyn(t);
    feas = maxp(feas, maxp(fabsf(D.d0), maxp(fabsf(D.d1), fabsf(D.d2))));
  }
  feas = maxp(feas, fabsf(x0 - X[0]));
  feas = maxp(feas, fabsf(y0 - Y[0]));
  feas = maxp(feas, fabsf(th0 - TH[0]));
  feas = maxp(feas, viol);
  float obj = s_goal;
  obj = obj + p.w_neg * s_neg;
  obj = obj + p.w_pos * s_pos;
  obj = obj + p.w_ang * s_ang;

  // Lagrangian gradient of state t with the final duals (stored masked).
  struct Vec3 {
    float v[3];
  };
  auto grad_L = [&](int t) {
    const float comp_t[3] = {X[t], Y[t], TH[t]};
    const float g = gm(t);
    Vec3 G;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      G.v[i] = 2.f * g * wgoal[i] * (comp_t[i] - goal[i]) - NUx[i * T1 + t] +
               NUx[(3 + i) * T1 + t];
    if (t >= 1 && K > 0) {
      float addx = 0.f, addy = 0.f;
      for (int k = 0; k < K; ++k) {
        const Geo Gk = geo(k, t - 1, comp_t[0], comp_t[1]);
        const float nu = NUob[k * N + t - 1];
        addx += -Gk.nx * nu;
        addy += -Gk.ny * nu;
      }
      G.v[0] = G.v[0] + addx;
      G.v[1] = G.v[1] + addy;
    }
    return G;
  };
  // Adjoint sweep for the control stationarity.
  Vec3 G = grad_L(N);
  float l0 = G.v[0], l1 = G.v[1], l2 = G.v[2], ru_max = 0.f;
  for (int t = N - 1; t >= 0; --t) {
    const Dyn D = dyn(t);
    const float gu0 = grad_v(V[t]) - NUc[t] + NUc[N + t];
    const float gu1 = 2.f * p.w_ang * W[t] - NUc[2 * N + t] + NUc[3 * N + t];
    const float ru0 = gu0 + D.b00 * l0 + D.b10 * l1;
    const float ru1 = gu1 + dt * l2;
    ru_max = maxp(ru_max, maxp(fabsf(ru0), fabsf(ru1)));
    G = grad_L(t);
    const float nl2 = G.v[2] + D.a02 * l0 + D.a12 * l1 + l2;
    l0 = G.v[0] + l0;
    l1 = G.v[1] + l1;
    l2 = nl2;
  }
  // IPOPT's s_d scaling of the dual residual (s_max = 100).
  const float s_d = maxp(100.f, nu_sum / maxp(nu_cnt, 1.f)) / 100.f;
  const float stationarity = ru_max / s_d;
  const float mu_fin = clipp(sig_c * tot / maxp(nu_cnt, 1.f), p.mu_floor, p.mu_init);
  const bool converged =
      stationarity < p.kkt_tol && feas < p.kkt_tol && comp / s_d < p.comp_tol;
  DG[0] = converged ? 1.f : 0.f;
  DG[1] = stationarity;
  DG[2] = feas;
  DG[3] = comp;
  DG[4] = obj;
  DG[5] = mu_fin;
}

}  // namespace

extern "C" int kissmpc_ipm_fused_scratch_rows(int N, int K, int elastic) {
  return scratch_rows(N, K, elastic != 0);
}

extern "C" int kissmpc_ipm_fused_f32(
    const void* iters, const void* scal, const void* warm, const void* tx,
    const void* ty, const void* obinfo, void* x, void* y, void* th, void* v,
    void* w, void* diag, void* scratch, const FusedParams* params,
    void* stream) {
  const FusedParams p = *params;
  if (p.B > 0) {
    const int blocks = (p.B + kThreads - 1) / kThreads;
    auto* kernel = p.elastic && p.K > 0 ? ipm_fused_kernel<true> : ipm_fused_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(iters), static_cast<const float*>(scal),
        static_cast<const float*>(warm), static_cast<const float*>(tx),
        static_cast<const float*>(ty), static_cast<const float*>(obinfo),
        static_cast<float*>(x), static_cast<float*>(y), static_cast<float*>(th),
        static_cast<float*>(v), static_cast<float*>(w), static_cast<float*>(diag),
        static_cast<float*>(scratch), p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kissmpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
