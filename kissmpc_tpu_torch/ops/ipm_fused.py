"""The fused IPM solve: one CUDA kernel per batched solve (`csrc/ipm_fused.cu`).

`solve_batch_fused(cfg, problems, *, iterations=None, mu_sigma=None)` runs
the whole fixed-iteration primal-dual IPM, from the slack/dual init through
every Newton step and line search to the exact KKT diagnostics, in one
launch.  It replaces the TPU kernel
`kissmpc_tpu/ops/pallas/ipm_fused.py::ipm_fused_kernel` and has its
wrapper's contract (`solve_batch_fused`, minus the TPU tile settings
``interpret``, ``bt`` and ``sb``).  For problems on the CPU it runs
`solve_batch_fused_plain`; for CUDA tensors it launches the kernel or
raises, and counts each launch in ``solve_batch_fused.launches``.

The plain version follows the kernel, not `solver/ipm.py`; the two differ
where the fused algorithm does:

* the merit components (objective, log barrier, equality + consistency
  residuals) are carried across iterations instead of being re-evaluated at
  alpha = 0;
* box-family consistency along a trial step is ``(1 - alpha) * consist0``
  in closed form (box constraints are linear in the step);
* ``mu_sigma`` is a per-scenario runtime row, both the initial centering
  and the adaptive decay floor;
* the all-rejected line search executes the deepest candidate only if its
  merit was finite, and a frozen lane keeps its previous merit components;
* obstacle tracks may come as (start, per-step delta) pairs
  (``fused_affine_tracks``), with a per-scenario certificate that they are
  affine;
* floors and tolerances are the float32 ones whatever the dtype, so the
  plain version also runs in float64 as a measure of the f32 system's
  conditioning.

With ``elastic_obstacles`` (and K > 0) each obstacle constraint becomes
c + e - s = 0, e >= 0, penalised by ``elastic_penalty * e``: e starts
central-ish, the condensation takes the eliminated stiffness of
`solver/ipm.py::elastic_coef`, the step eliminates (ds, de, dnu), e joins
the fraction to the boundary and the merit (log e, rho_e * e, |c + e - s|),
and e is carried with the iterate.  The kernel takes the branch as a
compile-time switch, so the hard path is built without it.

``iterations`` and ``mu_sigma`` are runtime inputs: the trip count reaches
the kernel as a one-element int32 tensor on the card that the kernel reads,
so one build serves every refine stage.  ``mu_sigma`` may be a scalar or a
per-scenario [B] tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ..config import MPCConfig
from ..solver.ipm import _amax, _sum, elastic_coef, elastic_step
from ..solver.problem import Diagnostics, Problem, Solution

SOURCE = _build.CSRC / "ipm_fused.cu"

EPS32 = 1.1920929e-07
F32_FLOOR = 1e-10
SIGMA_MAX = 1e12
KAPPA = 1e10
# A track that deviates from its affine reconstruction by more than this is
# certified non-affine: far above f32 rounding, far below real curvature.
AFFINE_TOL = 1e-4


class FusedInputs(NamedTuple):
    """The kernel's inputs, batch-major ([B, rows] each).

    scal: x0 (3), goal (3), v/w lower/upper bounds with +-inf replaced by 0
    (4), their finiteness masks (4), state lower/upper bounds (6), their
    masks (6), mu_sigma (1).  warm: x, y, th (N+1 each), v, w (N each).
    tx / ty: obstacle tracks, k-major [K*N] (row k*N + t covers state t+1),
    or [2K] (start rows, then per-step delta rows) with affine tracks.
    obinfo: radii (K), mask (K), inflation (1).  affine_dev: [B] deviation
    of the tracks from their affine reconstruction, or None.
    """

    scal: torch.Tensor
    warm: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    obinfo: torch.Tensor
    affine_dev: torch.Tensor | None


def _elastic(cfg: MPCConfig) -> bool:
    """Whether the elastic obstacle branch runs (it needs obstacles)."""
    return cfg.max_obstacles > 0 and cfg.solver.elastic_obstacles


def _check_supported(cfg: MPCConfig) -> None:
    sc = cfg.solver
    if sc.mehrotra != "off":
        raise ValueError(
            f"the fused backend has no predictor-corrector; mehrotra must be "
            f"'off', got {sc.mehrotra!r}"
        )


def pack_inputs(cfg: MPCConfig, problems: Problem, mu_sigma=None,
                dtype=torch.float32) -> FusedInputs:
    """The kernel's batch-major inputs from a Problem batch, in ``dtype``."""
    N, K = cfg.horizon, cfg.max_obstacles
    B = problems.initial_state.shape[0]
    dev = problems.initial_state.device
    fin = lambda b: torch.isfinite(b).to(dtype)
    safe = lambda b: torch.where(torch.isfinite(b), b, torch.zeros_like(b)).to(dtype)
    cl, cu = problems.control_lower, problems.control_upper
    sig = cfg.solver.mu_sigma if mu_sigma is None else mu_sigma
    sig = torch.as_tensor(sig, dtype=dtype, device=dev).reshape(-1, 1).expand(B, 1)
    scal = torch.cat(
        [
            problems.initial_state.to(dtype), problems.goal_state.to(dtype),
            safe(cl[:, 0:1]), safe(cu[:, 0:1]), safe(cl[:, 1:2]), safe(cu[:, 1:2]),
            fin(cl[:, 0:1]), fin(cu[:, 0:1]), fin(cl[:, 1:2]), fin(cu[:, 1:2]),
            safe(problems.state_lower), safe(problems.state_upper),
            fin(problems.state_lower), fin(problems.state_upper),
            sig,
        ],
        dim=1,
    )
    ws, wc = problems.warm_states.to(dtype), problems.warm_controls.to(dtype)
    warm = torch.cat([ws[..., 0], ws[..., 1], ws[..., 2], wc[..., 0], wc[..., 1]], dim=1)
    affine_dev = None
    if K == 0:
        empty = torch.zeros((B, 0), dtype=dtype, device=dev)
        return FusedInputs(scal, warm, empty, empty, empty, None)
    c = problems.obstacle_centers.to(dtype)  # [B, K, N, 2]
    if cfg.solver.fused_affine_tracks:
        d = c[:, :, 1] - c[:, :, 0] if N > 1 else torch.zeros_like(c[:, :, 0])
        t_idx = torch.arange(N, dtype=dtype, device=dev)[None, None, :, None]
        recon = c[:, :, 0:1] + t_idx * d[:, :, None]
        mask = problems.obstacle_mask.to(dtype)[..., None, None]
        affine_dev = (torch.abs(recon - c) * mask).flatten(1).amax(dim=1)
        tx = torch.cat([c[:, :, 0, 0], d[..., 0]], dim=1)
        ty = torch.cat([c[:, :, 0, 1], d[..., 1]], dim=1)
    else:
        tx = c[..., 0].reshape(B, K * N)
        ty = c[..., 1].reshape(B, K * N)
    obinfo = torch.cat(
        [
            problems.obstacle_radii.to(dtype), problems.obstacle_mask.to(dtype),
            problems.inflation_radius.to(dtype).reshape(B, 1),
        ],
        dim=1,
    )
    return FusedInputs(scal, warm, tx, ty, obinfo, affine_dev)


def _solution(inp: FusedInputs, x, y, th, v, w, diag) -> Solution:
    """Solution from the kernel's batch-major outputs; applies the affine
    certificate (non-affine tracks were solved against the wrong
    constraints: withdraw convergence, report the deviation as
    infeasibility)."""
    converged = diag[:, 0] > 0.5
    feas = diag[:, 2]
    if inp.affine_dev is not None:
        affine_ok = inp.affine_dev <= AFFINE_TOL
        converged = converged & affine_ok
        feas = torch.maximum(feas, torch.where(affine_ok, torch.zeros_like(feas),
                                               inp.affine_dev))
    return Solution(
        states=torch.stack([x, y, th], dim=-1),
        controls=torch.stack([v, w], dim=-1),
        diagnostics=Diagnostics(
            converged=converged,
            kkt_stationarity=diag[:, 1],
            kkt_feasibility=feas,
            kkt_complementarity=diag[:, 3],
            final_cost=diag[:, 4],
            final_mu=diag[:, 5],
        ),
    )


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _sigma(nu, s, mask):
    return torch.clamp(mask * nu / torch.clamp(s, min=F32_FLOOR), 0.0, SIGMA_MAX)


def _ftb(v, dv, tau):
    ratio = torch.where(dv < 0, -tau * v / torch.clamp(dv, max=-1e-30), torch.ones_like(v))
    return ratio.flatten(1).amin(dim=1)


def _plain(cfg: MPCConfig, inp: FusedInputs, iterations: int):
    """The fused IPM on batch-major tensors; returns (x, y, th, v, w, diag)."""
    N, K = cfg.horizon, cfg.max_obstacles
    sc, cc = cfg.solver, cfg.cost
    dt = cfg.time_step
    T1 = N + 1
    scal = inp.scal
    B = scal.shape[0]
    col = lambda i: scal[:, i:i + 1]  # [B, 1]
    x0p, y0p, th0p = col(0), col(1), col(2)
    gx, gy, gth = col(3), col(4), col(5)
    v_lb, v_ub, w_lb, w_ub = col(6), col(7), col(8), col(9)
    m_c = [col(10), col(11), col(12), col(13)]  # vl, vu, wl, wu
    xlb = [col(14 + i) for i in range(3)]
    xub = [col(17 + i) for i in range(3)]
    m_x = [col(20 + i) for i in range(3)] + [col(23 + i) for i in range(3)]
    sig_row = scal[:, 26]
    w0, w1, w2 = cc.goal_weights
    w_neg = cc.negative_velocity_weight
    w_pos = cc.positive_velocity_weight
    w_ang = cc.angular_velocity_weight
    squared = cc.reverse_penalty_mode == "squared"
    rows = torch.arange(T1, device=scal.device)
    gm = (rows >= 1) & ((rows <= N - 1) if cc.goal_cost_mode == "exclude_terminal" else True)
    gm = gm.to(scal.dtype)[None, :]  # [1, T1]
    mu_floor = max(sc.mu_min, 50.0 * EPS32)
    zeros = torch.zeros(B, dtype=scal.dtype, device=scal.device)
    elastic = _elastic(cfg)
    rho_e = sc.elastic_penalty

    if K > 0:
        ob = inp.obinfo
        radinfl = (ob[:, :K] + ob[:, 2 * K:2 * K + 1])[..., None]  # [B, K, 1]
        obm = ob[:, K:2 * K][..., None]
        if sc.fused_affine_tracks:
            t_idx = torch.arange(N, dtype=scal.dtype, device=scal.device)
            tx = inp.tx[:, :K, None] + t_idx * inp.tx[:, K:, None]
            ty = inp.ty[:, :K, None] + t_idx * inp.ty[:, K:, None]
        else:
            tx, ty = inp.tx.reshape(B, K, N), inp.ty.reshape(B, K, N)

    def box_values(x, y, th, v, w):
        """Box constraint values, family order vl, vu, wl, wu, xl0..2, xu0..2."""
        comps = (x, y, th)
        return ([v - v_lb, v_ub - v, w - w_lb, w_ub - w]
                + [comps[i] - xlb[i] for i in range(3)]
                + [xub[i] - comps[i] for i in range(3)])

    masks = m_c + m_x

    def obstacle(x, y):
        """(c, nx, ny) [B, K, N] at the states 1..N of (x, y)."""
        dxk = x[:, None, 1:] - tx
        dyk = y[:, None, 1:] - ty
        dist = torch.sqrt(dxk * dxk + dyk * dyk + 1e-16)
        ds_safe = torch.clamp(dist, min=1e-2)
        return dist - radinfl, dxk / ds_safe, dyk / ds_safe

    def merit_terms(x, y, th, v, w):
        ct, st = torch.cos(th[:, :-1]), torch.sin(th[:, :-1])
        ex, ey, eth = x - gx, y - gy, th - gth
        obj = _sum(gm * (w0 * ex * ex + w1 * ey * ey + w2 * eth * eth))
        neg = torch.clamp(v, max=0.0)
        obj = obj + w_neg * _sum(neg * neg if squared else neg)
        pos = torch.clamp(v, min=0.0)
        obj = obj + w_pos * _sum(pos * pos)
        obj = obj + w_ang * _sum(w * w)
        d0 = x[:, :-1] + v * ct * dt - x[:, 1:]
        d1 = y[:, :-1] + v * st * dt - y[:, 1:]
        d2 = th[:, :-1] + w * dt - th[:, 1:]
        eq = (_sum(torch.abs(d0)) + _sum(torch.abs(d1)) + _sum(torch.abs(d2))
              + torch.abs(x0p - x[:, :1])[:, 0] + torch.abs(y0p - y[:, :1])[:, 0]
              + torch.abs(th0p - th[:, :1])[:, 0])
        return obj, eq, (ct, st, d0, d1, d2)

    # --- init from the warm start --------------------------------------
    warm = inp.warm
    x, y, th = warm[:, :T1], warm[:, T1:2 * T1], warm[:, 2 * T1:3 * T1]
    v, w = warm[:, 3 * T1:3 * T1 + N], warm[:, 3 * T1 + N:]
    mu0 = sc.mu_init

    def init_pair(c, mask):
        on = mask > 0
        s = torch.where(on, torch.clamp(c, min=1e-2), torch.ones_like(c))
        nu = torch.where(on, mu0 / s, torch.zeros_like(c))
        return s, nu

    pairs = [init_pair(c, m) for c, m in zip(box_values(x, y, th, v, w), masks)]
    s_box, nu_box = [s for s, _ in pairs], [nu for _, nu in pairs]
    if K > 0:
        c_ob, _, _ = obstacle(x, y)
        s_ob, nu_ob = init_pair(c_ob, obm)
        if elastic:
            # Central-ish elastic init: e solves c + e = s where violated,
            # else sits at mu / rho_e.
            e_ob = torch.where(obm > 0, torch.clamp(s_ob - c_ob, min=mu0 / rho_e),
                               torch.ones_like(s_ob))

    m_obj, m_eq, _ = merit_terms(x, y, th, v, w)
    m_log, m_cons = zeros, zeros
    for c, s, m in zip(box_values(x, y, th, v, w), s_box, masks):
        m_log = m_log + _sum(m * torch.log(torch.clamp(s, min=1e-30)))
        m_cons = m_cons + _sum(m * torch.abs(c - s))
    if K > 0:
        m_log = m_log + _sum(obm * torch.log(torch.clamp(s_ob, min=1e-30)))
        if elastic:
            m_log = m_log + _sum(obm * torch.log(torch.clamp(e_ob, min=1e-30)))
            m_obj = m_obj + rho_e * _sum(obm * e_ob)
            m_cons = m_cons + _sum(obm * torch.abs(c_ob + e_ob - s_ob))
        else:
            m_cons = m_cons + _sum(obm * torch.abs(c_ob - s_ob))
    m_eqc = m_eq + m_cons

    reg = torch.full_like(zeros, sc.reg)
    sigma_c = sig_row
    for _ in range(iterations):
        boxc = box_values(x, y, th, v, w)
        if K > 0:
            c_ob, nx, ny = obstacle(x, y)
        fam_s = s_box + ([s_ob] if K > 0 else [])
        fam_nu = nu_box + ([nu_ob] if K > 0 else [])
        fam_m = masks + ([obm] if K > 0 else [])

        tot, cnt = zeros, zeros
        for s, nu, m in zip(fam_s, fam_nu, fam_m):
            tot = tot + _sum(m * s * nu)
            cnt = cnt + _sum(m * torch.ones_like(s))
        mu = torch.clamp(sigma_c * tot / torch.clamp(cnt, min=1.0), mu_floor, sc.mu_init)
        mu1 = mu[:, None]
        reg1 = reg[:, None]

        # --- cost derivatives + condensation ------------------------------
        ct, st = torch.cos(th[:, :-1]), torch.sin(th[:, :-1])
        qx = [2.0 * gm * w0 * (x - gx), 2.0 * gm * w1 * (y - gy), 2.0 * gm * w2 * (th - gth)]
        Qd = [(2.0 * gm * wi).expand(B, T1) for wi in (w0, w1, w2)]
        negm = (v < 0.0).to(v.dtype)
        posm = (v > 0.0).to(v.dtype)
        if squared:
            gv = 2.0 * w_neg * torch.clamp(v, max=0.0)
            Hv = 2.0 * w_neg * negm
        else:
            gv = w_neg * negm
            Hv = torch.zeros_like(v)
        gv = gv + 2.0 * w_pos * torch.clamp(v, min=0.0)
        Hv = Hv + 2.0 * w_pos * posm
        gw = 2.0 * w_ang * w
        Hw = 2.0 * w_ang

        mu3 = mu[:, None, None]

        def grad_coef(c, s, nu, m):
            sig = _sigma(nu, s, m)
            mu_b = mu3 if s.dim() == 3 else mu1
            return m * (mu_b / torch.clamp(s, min=F32_FLOOR) - sig * (c - s)), sig

        gs = [grad_coef(c, s, nu, m) for c, s, nu, m in zip(boxc, s_box, nu_box, masks)]
        qv = gv - gs[0][0] + gs[1][0]
        qw = gw - gs[2][0] + gs[3][0]
        Qv = Hv + gs[0][1] + gs[1][1] + reg1
        Qw = Hw + gs[2][1] + gs[3][1] + reg1
        for i in range(3):
            (g_l, s_l), (g_u, s_u) = gs[4 + i], gs[7 + i]
            qx[i] = qx[i] - g_l + g_u
            Qd[i] = Qd[i] + s_l + s_u
        Qxy = torch.zeros_like(x)  # state-indexed, zero at state 0
        if K > 0:
            if elastic:
                el = elastic_coef(c_ob, s_ob, nu_ob, e_ob, obm, mu3, rho_e,
                                  F32_FLOOR, SIGMA_MAX)
                g_o, sig_o = el.g, el.sig_eff
            else:
                g_o, sig_o = grad_coef(c_ob, s_ob, nu_ob, obm)
            h00 = sig_o * nx * nx
            h01 = sig_o * nx * ny
            h11 = sig_o * ny * ny
            if sc.obstacle_curvature:
                dsafe = torch.clamp(c_ob + radinfl, min=1e-2)
                wc = torch.maximum(-obm * nu_ob / dsafe, -0.9 * sig_o)
                h00 = h00 + wc * (1.0 - nx * nx)
                h01 = h01 - wc * nx * ny
                h11 = h11 + wc * (1.0 - ny * ny)
            pad = lambda a: torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
            qx[0] = qx[0] + pad((-nx * g_o).sum(dim=1))
            qx[1] = qx[1] + pad((-ny * g_o).sum(dim=1))
            Qd[0] = Qd[0] + pad(h00.sum(dim=1))
            Qd[1] = Qd[1] + pad(h11.sum(dim=1))
            Qxy = pad(h01.sum(dim=1))
        Qd = [q + reg1 for q in Qd]

        # --- dynamics ----------------------------------------------------
        a02 = -v * st * dt
        a12 = v * ct * dt
        b00 = ct * dt
        b10 = st * dt
        d0r = x[:, :-1] + v * ct * dt - x[:, 1:]
        d1r = y[:, :-1] + v * st * dt - y[:, 1:]
        d2r = th[:, :-1] + w * dt - th[:, 1:]

        # --- backward Riccati sweep, with the adjoint running max ----------
        P00, P01, P02 = Qd[0][:, N], Qxy[:, N], zeros
        P11, P12, P22 = Qd[1][:, N], zeros, Qd[2][:, N]
        p0, p1, p2 = qx[0][:, N], qx[1][:, N], qx[2][:, N]
        l0, l1, l2 = p0, p1, p2
        lmax = torch.maximum(torch.abs(p0), torch.maximum(torch.abs(p1), torch.abs(p2)))
        gains = [[None] * N for _ in range(8)]
        for t in range(N - 1, -1, -1):
            a02t, a12t, b00t, b10t = a02[:, t], a12[:, t], b00[:, t], b10[:, t]
            d0t, d1t, d2t = d0r[:, t], d1r[:, t], d2r[:, t]
            Pa0 = P00 * a02t + P01 * a12t + P02
            Pa1 = P01 * a02t + P11 * a12t + P12
            Pa2 = P02 * a02t + P12 * a12t + P22
            Pd0 = P00 * d0t + P01 * d1t + P02 * d2t + p0
            Pd1 = P01 * d0t + P11 * d1t + P12 * d2t + p1
            Pd2 = P02 * d0t + P12 * d1t + P22 * d2t + p2
            PB00 = b00t * P00 + b10t * P01
            PB01 = b00t * P01 + b10t * P11
            PB02 = b00t * P02 + b10t * P12
            e00 = b00t * PB00 + b10t * PB01
            e01 = dt * PB02
            e11 = dt * dt * P22
            Quu00 = Qv[:, t] + e00
            Quu01 = e01
            Quu11 = Qw[:, t] + e11
            Qux00, Qux01 = PB00, PB01
            Qux02 = b00t * Pa0 + b10t * Pa1
            Qux10, Qux11, Qux12 = dt * P02, dt * P12, dt * Pa2
            qu0 = qv[:, t] + b00t * Pd0 + b10t * Pd1
            qu1 = qw[:, t] + dt * Pd2
            inv = 1.0 / (Quu00 * Quu11 - Quu01 * Quu01)
            i00, i01, i11 = Quu11 * inv, -Quu01 * inv, Quu00 * inv
            K00 = -(i00 * Qux00 + i01 * Qux10)
            K01 = -(i00 * Qux01 + i01 * Qux11)
            K02 = -(i00 * Qux02 + i01 * Qux12)
            K10 = -(i01 * Qux00 + i11 * Qux10)
            K11 = -(i01 * Qux01 + i11 * Qux11)
            K12 = -(i01 * Qux02 + i11 * Qux12)
            k0 = -(i00 * qu0 + i01 * qu1)
            k1 = -(i01 * qu0 + i11 * qu1)
            for g, val in enumerate((K00, K01, K02, K10, K11, K12, k0, k1)):
                gains[g][t] = val
            aPa = a02t * Pa0 + a12t * Pa1 + Pa2
            S00 = Qux00 * K00 + Qux10 * K10
            S01 = Qux00 * K01 + Qux10 * K11
            S02 = Qux00 * K02 + Qux10 * K12
            S10 = Qux01 * K00 + Qux11 * K10
            S11 = Qux01 * K01 + Qux11 * K11
            S12 = Qux01 * K02 + Qux11 * K12
            S20 = Qux02 * K00 + Qux12 * K10
            S21 = Qux02 * K01 + Qux12 * K11
            S22 = Qux02 * K02 + Qux12 * K12
            q0t, q1t, q2t = qx[0][:, t], qx[1][:, t], qx[2][:, t]
            nP00 = Qd[0][:, t] + P00 + S00
            nP01 = Qxy[:, t] + P01 + 0.5 * (S01 + S10)
            nP02 = Pa0 + 0.5 * (S02 + S20)
            nP11 = Qd[1][:, t] + P11 + S11
            nP12 = Pa1 + 0.5 * (S12 + S21)
            nP22 = Qd[2][:, t] + aPa + S22
            np0 = q0t + Pd0 + Qux00 * k0 + Qux10 * k1
            np1 = q1t + Pd1 + Qux01 * k0 + Qux11 * k1
            np2 = q2t + a02t * Pd0 + a12t * Pd1 + Pd2 + Qux02 * k0 + Qux12 * k1
            nl0 = q0t + l0
            nl1 = q1t + l1
            nl2 = q2t + a02t * l0 + a12t * l1 + l2
            lmax = torch.maximum(lmax, torch.maximum(
                torch.abs(nl0), torch.maximum(torch.abs(nl1), torch.abs(nl2))))
            P00, P01, P02, P11, P12, P22 = nP00, nP01, nP02, nP11, nP12, nP22
            p0, p1, p2, l0, l1, l2 = np0, np1, np2, nl0, nl1, nl2
        lam_max = lmax

        # --- forward rollout ----------------------------------------------
        dxs = [x0p[:, 0] - x[:, 0]]
        dys = [y0p[:, 0] - y[:, 0]]
        dths = [th0p[:, 0] - th[:, 0]]
        dvs, dws = [], []
        for t in range(N):
            dx0, dx1, dx2 = dxs[-1], dys[-1], dths[-1]
            G = [gains[g][t] for g in range(8)]
            du0 = G[0] * dx0 + G[1] * dx1 + G[2] * dx2 + G[6]
            du1 = G[3] * dx0 + G[4] * dx1 + G[5] * dx2 + G[7]
            dvs.append(du0)
            dws.append(du1)
            dxs.append(dx0 + a02[:, t] * dx2 + b00[:, t] * du0 + d0r[:, t])
            dys.append(dx1 + a12[:, t] * dx2 + b10[:, t] * du0 + d1r[:, t])
            dths.append(dx2 + dt * du1 + d2r[:, t])
        ddx, ddy, ddth = (torch.stack(a, dim=1) for a in (dxs, dys, dths))
        ddv, ddw = torch.stack(dvs, dim=1), torch.stack(dws, dim=1)

        # --- slack / dual steps, fraction to the boundary ------------------
        jdz = [ddv, -ddv, ddw, -ddw, ddx, ddy, ddth, -ddx, -ddy, -ddth]
        ds_box = [m * (j + c - s) for m, j, c, s in zip(masks, jdz, boxc, s_box)]

        def dnu_of(s, nu, m, ds):
            mu_b = mu3 if s.dim() == 3 else mu1
            return m * (mu_b / torch.clamp(s, min=F32_FLOOR) - nu - _sigma(nu, s, m) * ds)

        dnu_box = [dnu_of(s, nu, m, ds) for s, nu, m, ds in zip(s_box, nu_box, masks, ds_box)]
        fam_ds, fam_dnu = ds_box[:], dnu_box[:]
        if K > 0:
            jdz_ob = nx * ddx[:, None, 1:] + ny * ddy[:, None, 1:]
            if elastic:
                # The eliminated (ds, de, dnu) of c + e - s = 0, from the
                # condensation's coefficients (same iterate, same mu).
                ds_ob, de_ob, dnu_ob = elastic_step(el, obm, jdz_ob, F32_FLOOR)
            else:
                ds_ob = obm * (jdz_ob + c_ob - s_ob)
                dnu_ob = dnu_of(s_ob, nu_ob, obm, ds_ob)
            fam_ds.append(ds_ob)
            fam_dnu.append(dnu_ob)

        tau = sc.tau
        alpha_s = torch.ones_like(zeros)
        alpha_nu = torch.ones_like(zeros)
        for s, nu, ds, dnu in zip(fam_s, fam_nu, fam_ds, fam_dnu):
            alpha_s = torch.minimum(alpha_s, _ftb(s, ds, tau))
            alpha_nu = torch.minimum(alpha_nu, _ftb(nu, dnu, tau))
        if elastic:
            alpha_s = torch.minimum(alpha_s, _ftb(e_ob, de_ob, tau))

        nu_max = zeros
        for nu, m in zip(fam_nu, fam_m):
            nu_max = torch.maximum(nu_max, _amax(m * nu))
        rho = torch.clamp(2.0 * torch.maximum(nu_max, lam_max), min=sc.merit_penalty)

        # --- merit line search --------------------------------------------
        consist0_box = zeros
        for c, s, m in zip(boxc, s_box, masks):
            consist0_box = consist0_box + _sum(m * torch.abs(c - s))

        def merit_at(alpha):
            a = alpha[:, None]
            txv, tyv = x + a * ddx, y + a * ddy
            obj, eq, _ = merit_terms(txv, tyv, th + a * ddth, v + a * ddv, w + a * ddw)
            log_term = zeros
            consist = (1.0 - alpha) * consist0_box
            for s, ds, m in zip(s_box, ds_box, masks):
                log_term = log_term + _sum(m * torch.log(torch.clamp(s + a * ds, min=1e-30)))
            if K > 0:
                ts = s_ob + a[..., None] * ds_ob
                log_term = log_term + _sum(obm * torch.log(torch.clamp(ts, min=1e-30)))
                c_trial, _, _ = obstacle(txv, tyv)
                if elastic:
                    te = e_ob + a[..., None] * de_ob
                    log_term = log_term + _sum(obm * torch.log(torch.clamp(te, min=1e-30)))
                    obj = obj + rho_e * _sum(obm * te)
                    consist = consist + _sum(obm * torch.abs(c_trial + te - ts))
                else:
                    consist = consist + _sum(obm * torch.abs(c_trial - ts))
            eqc = eq + consist
            return obj - mu * log_term + rho * eqc, obj, log_term, eqc

        merit0 = m_obj - mu * m_log + rho * m_eqc
        step_inf = zeros
        for dz in (ddx, ddy, ddth, ddv, ddw):
            step_inf = torch.maximum(step_inf, _amax(torch.abs(dz)))
        newton = step_inf < 1e-2
        tol = 16.0 * EPS32 * (1.0 + torch.abs(merit0)) + torch.where(
            newton, 10.0 * rho * step_inf * step_inf, zeros)

        alpha_best = alpha_s * float(float(sc.ls_backtrack) ** (sc.ls_iters - 1))
        found = torch.zeros_like(zeros, dtype=torch.bool)
        fin_last = found
        n_rej = zeros
        s_obj, s_log, s_eqc = zeros, zeros, zeros
        aj = alpha_s
        for j in range(sc.ls_iters):
            m, c_obj, c_log, c_eqc = merit_at(aj)
            m_fin = torch.isfinite(m)
            ok = m_fin & (m <= merit0 + tol)
            take = ok & ~found
            found = found | ok
            sel = take | (~found) if j == sc.ls_iters - 1 else take
            alpha_best = torch.where(take, aj, alpha_best)
            s_obj = torch.where(sel, c_obj, s_obj)
            s_log = torch.where(sel, c_log, s_log)
            s_eqc = torch.where(sel, c_eqc, s_eqc)
            if j == sc.ls_iters - 1:
                fin_last = m_fin
            n_rej = n_rej + (~found).to(zeros.dtype)
            aj = aj * sc.ls_backtrack
        # All rejected: execute the deepest candidate only if its merit was
        # finite; a frozen lane keeps its previous merit components.
        keep = found | fin_last
        alpha = torch.where(keep, alpha_best, zeros)
        m_obj = torch.where(keep, s_obj, m_obj)
        m_log = torch.where(keep, s_log, m_log)
        m_eqc = torch.where(keep, s_eqc, m_eqc)
        alpha_nu = torch.minimum(alpha_nu, alpha)

        # --- updates with the dual clamp -----------------------------------
        a1, an1 = alpha[:, None], alpha_nu[:, None]

        def update(s, nu, m, ds, dnu, a, an, mu_b):
            s_new = s + a * ds
            center = mu_b / torch.clamp(s_new, min=F32_FLOOR)
            nu_new = m * torch.minimum(torch.maximum(nu + an * dnu, center / KAPPA),
                                       center * KAPPA)
            return s_new, nu_new

        new = [update(s, nu, m, ds, dnu, a1, an1, mu1)
               for s, nu, m, ds, dnu in zip(s_box, nu_box, masks, ds_box, dnu_box)]
        s_box, nu_box = [s for s, _ in new], [nu for _, nu in new]
        if K > 0:
            s_ob, nu_ob = update(s_ob, nu_ob, obm, ds_ob, dnu_ob, a1[..., None],
                                 an1[..., None], mu3)
            if elastic:
                e_ob = e_ob + a1[..., None] * de_ob
        x, y, th = x + a1 * ddx, y + a1 * ddy, th + a1 * ddth
        v, w = v + a1 * ddv, w + a1 * ddw

        grow = (~found) | ((n_rej >= 4.0) & ~newton)
        reg = torch.where(
            grow,
            torch.clamp(torch.clamp(reg, min=sc.reg) * 8.0, max=1e8),
            torch.clamp(reg / 3.0, min=sc.reg),
        )
        if sc.mu_sigma_max > 0.0:
            sigma_c = torch.where(
                (alpha < 0.25) & ~newton,
                torch.minimum(sigma_c * 1.5, torch.clamp(sig_row, min=sc.mu_sigma_max)),
                torch.maximum(sigma_c * 0.9, sig_row),
            )

    # --- exact KKT diagnostics at the final iterate ----------------------
    boxc = box_values(x, y, th, v, w)
    fam_c, fam_s, fam_nu, fam_m = boxc, s_box, nu_box, masks
    gxL = [2.0 * gm * w0 * (x - gx), 2.0 * gm * w1 * (y - gy), 2.0 * gm * w2 * (th - gth)]
    gxL = [gxL[i] - nu_box[4 + i] + nu_box[7 + i] for i in range(3)]
    if squared:
        gv = 2.0 * w_neg * torch.clamp(v, max=0.0)
    else:
        gv = w_neg * (v < 0.0).to(v.dtype)
    gv = gv + 2.0 * w_pos * torch.clamp(v, min=0.0)
    guL0 = gv - nu_box[0] + nu_box[1]
    guL1 = 2.0 * w_ang * w - nu_box[2] + nu_box[3]
    if K > 0:
        c_ob, nx, ny = obstacle(x, y)
        pad = lambda a: torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        gxL[0] = gxL[0] + pad((-nx * nu_ob).sum(dim=1))
        gxL[1] = gxL[1] + pad((-ny * nu_ob).sum(dim=1))
        fam_c, fam_s, fam_nu, fam_m = (boxc + [c_ob], s_box + [s_ob],
                                       nu_box + [nu_ob], masks + [obm])
    ctf, stf = torch.cos(th[:, :-1]), torch.sin(th[:, :-1])
    a02, a12, b00, b10 = -v * stf * dt, v * ctf * dt, ctf * dt, stf * dt
    l0, l1, l2 = gxL[0][:, N], gxL[1][:, N], gxL[2][:, N]
    ru_max = zeros
    for t in range(N - 1, -1, -1):
        ru0 = guL0[:, t] + b00[:, t] * l0 + b10[:, t] * l1
        ru1 = guL1[:, t] + dt * l2
        ru_max = torch.maximum(ru_max, torch.maximum(torch.abs(ru0), torch.abs(ru1)))
        l0, l1, l2 = (gxL[0][:, t] + l0, gxL[1][:, t] + l1,
                      gxL[2][:, t] + a02[:, t] * l0 + a12[:, t] * l1 + l2)

    nu_sum, nu_cnt, viol, comp, tot = zeros, zeros, zeros, zeros, zeros
    for c, s, nu, m in zip(fam_c, fam_s, fam_nu, fam_m):
        nu_sum = nu_sum + _sum(m * torch.abs(nu))
        nu_cnt = nu_cnt + _sum(m * torch.ones_like(s))
        viol = torch.maximum(viol, _amax(m * torch.clamp(-c, min=0.0)))
        comp = torch.maximum(comp, _amax(m * torch.abs(s * nu)))
        tot = tot + _sum(m * s * nu)
    s_d = torch.clamp(nu_sum / torch.clamp(nu_cnt, min=1.0), min=100.0) / 100.0
    stationarity = ru_max / s_d
    obj, _, (_, _, d0r, d1r, d2r) = merit_terms(x, y, th, v, w)
    feas = torch.maximum(_amax(torch.abs(d0r)), torch.maximum(
        _amax(torch.abs(d1r)), _amax(torch.abs(d2r))))
    for pin in (x0p - x[:, :1], y0p - y[:, :1], th0p - th[:, :1]):
        feas = torch.maximum(feas, torch.abs(pin[:, 0]))
    feas = torch.maximum(feas, viol)
    mu_fin = torch.clamp(sigma_c * tot / torch.clamp(nu_cnt, min=1.0), mu_floor, sc.mu_init)
    tol = max(sc.kkt_tol, 50.0 * 3.4526698e-04)
    converged = ((stationarity < tol) & (feas < tol)
                 & (comp / s_d < max(10.0 * sc.mu_min, tol)))
    diag = torch.stack([converged.to(zeros.dtype), stationarity, feas, comp, obj, mu_fin],
                       dim=1)
    return x, y, th, v, w, diag


def solve_batch_fused_plain(cfg: MPCConfig, problems: Problem, *,
                            iterations: int | None = None,
                            mu_sigma=None) -> Solution:
    """The plain PyTorch version of the fused kernel, on the problems'
    device and in their dtype (float32 or float64, with the float32 floors
    and tolerances either way)."""
    _check_supported(cfg)
    dtype = problems.initial_state.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the plain fused IPM takes float32 or float64, got {dtype}")
    iters = cfg.solver.iterations if iterations is None else int(iterations)
    with torch.no_grad():
        inp = pack_inputs(cfg, problems, mu_sigma, dtype)
        return _solution(inp, *_plain(cfg, inp, iters))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``struct FusedParams`` in `csrc/ipm_fused.cu` (4-byte fields
    only, so the two layouts agree without padding)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "N", "K", "ls_iters", "exclude_terminal", "reverse_squared",
        "curvature", "affine", "adaptive_sigma", "elastic",
    )] + [(name, ctypes.c_float) for name in (
        "dt", "tau", "reg", "mu_init", "mu_floor", "mu_sigma_max",
        "ls_backtrack", "alpha_min_factor", "merit_penalty", "kkt_tol",
        "comp_tol", "w0", "w1", "w2", "w_neg", "w_pos", "w_ang", "rho_e",
    )]


def _params(cfg: MPCConfig, B: int) -> _Params:
    sc, cc = cfg.solver, cfg.cost
    kkt_tol = max(sc.kkt_tol, 50.0 * 3.4526698e-04)
    w0, w1, w2 = cc.goal_weights
    return _Params(
        B=B, N=cfg.horizon, K=cfg.max_obstacles, ls_iters=sc.ls_iters,
        exclude_terminal=int(cc.goal_cost_mode == "exclude_terminal"),
        reverse_squared=int(cc.reverse_penalty_mode == "squared"),
        curvature=int(sc.obstacle_curvature),
        affine=int(cfg.max_obstacles > 0 and sc.fused_affine_tracks),
        adaptive_sigma=int(sc.mu_sigma_max > 0.0),
        elastic=int(_elastic(cfg)),
        dt=cfg.time_step, tau=sc.tau, reg=sc.reg, mu_init=sc.mu_init,
        mu_floor=max(sc.mu_min, 50.0 * EPS32), mu_sigma_max=sc.mu_sigma_max,
        ls_backtrack=sc.ls_backtrack,
        alpha_min_factor=float(sc.ls_backtrack) ** (sc.ls_iters - 1),
        merit_penalty=sc.merit_penalty, kkt_tol=kkt_tol,
        comp_tol=max(10.0 * sc.mu_min, kkt_tol),
        w0=w0, w1=w1, w2=w2, w_neg=cc.negative_velocity_weight,
        w_pos=cc.positive_velocity_weight, w_ang=cc.angular_velocity_weight,
        rho_e=sc.elastic_penalty,
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launcher's signature on a loaded build of ``SOURCE``."""
    fn = lib.kissmpc_ipm_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kissmpc_ipm_fused_scratch_rows.argtypes = [ctypes.c_int] * 3
    lib.kissmpc_ipm_fused_scratch_rows.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE, "kissmpc_ipm_fused"))


def _check_problems(cfg: MPCConfig, problems: Problem) -> None:
    """The batch the kernel takes: float32, one device, contiguous, shapes
    of ``cfg``."""
    N, K = cfg.horizon, cfg.max_obstacles
    B = problems.initial_state.shape[0]
    expected = {
        "initial_state": (B, 3), "goal_state": (B, 3), "control_lower": (B, 2),
        "control_upper": (B, 2), "state_lower": (B, 3), "state_upper": (B, 3),
        "obstacle_centers": (B, K, N, 2), "obstacle_radii": (B, K),
        "obstacle_mask": (B, K), "inflation_radius": (B,),
        "warm_states": (B, N + 1, 3), "warm_controls": (B, N, 2),
    }
    device = problems.initial_state.device
    for name, shape in expected.items():
        x = getattr(problems, name)
        if tuple(x.shape) != shape:
            raise ValueError(f"Problem.{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or x.device != device:
            raise TypeError(
                f"Problem.{name} is {x.dtype} on {x.device}; the fused kernel "
                f"takes float32 on {device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"Problem.{name} must be contiguous")


def solve_batch_fused(cfg: MPCConfig, problems: Problem, *,
                      iterations: int | None = None,
                      mu_sigma=None) -> Solution:
    """Batched fused IPM solve: the CUDA kernel for problems on the card,
    the plain version for problems on the CPU.  float32 only."""
    _check_supported(cfg)
    _check_problems(cfg, problems)
    device = problems.initial_state.device
    if device.type == "cpu":
        return solve_batch_fused_plain(cfg, problems, iterations=iterations,
                                       mu_sigma=mu_sigma)
    if device.type != "cuda":
        raise ValueError(f"the fused kernel runs on CUDA or CPU tensors, got {device}")
    N, K = cfg.horizon, cfg.max_obstacles
    T1 = N + 1
    B = problems.initial_state.shape[0]
    iters = cfg.solver.iterations if iterations is None else int(iterations)
    lib = _library()
    with torch.no_grad(), torch.cuda.device(device):
        inp = pack_inputs(cfg, problems, mu_sigma, torch.float32)
        # Scenario-minor planes: row r of scenario b at r * B + b, so a
        # warp's 32 threads read one 128-byte line per access.
        planes = [t.t().contiguous() for t in (inp.scal, inp.warm, inp.tx, inp.ty, inp.obinfo)]
        trips = torch.tensor([iters], dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        outs = [torch.empty((rows, B), **f32) for rows in (T1, T1, T1, N, N, 6)]
        # The elastic e rows are allocated only when the branch is on.
        rows = lib.kissmpc_ipm_fused_scratch_rows(N, K, int(_elastic(cfg)))
        scratch = torch.empty(rows * B, **f32)
        params = _params(cfg, B)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kissmpc_ipm_fused_f32(
            trips.data_ptr(), *(t.data_ptr() for t in planes),
            *(t.data_ptr() for t in outs), scratch.data_ptr(),
            ctypes.byref(params), stream,
        )
        _build.check_launch(lib, err, "fused IPM kernel")
        solve_batch_fused.launches += 1
        x, y, th, v, w, diag = (t.t() for t in outs)
        return _solution(inp, x, y, th, v, w, diag)


solve_batch_fused.launches = 0
