"""Batched primal-dual interior-point SQP for the unicycle MPC NLP (torch).

Port of `kissmpc_tpu/solver/ipm.py` with the batch axis written out: every
iterate leaf is [B, ...], and step sizes, mu, rho, reg and sigma are [B]
per scenario, as under the reference's `jax.vmap(ipm.solve)`.  The
algorithm is the reference's (see its module docstring): slack
reformulation, stage-local condensation into a Riccati Newton-KKT solve,
fraction-to-boundary, an l1-merit line search over ``ls_iters`` candidates
with the finite-merit fallback, dual clamp, adaptive reg and centering.

The Newton-KKT solve goes to the CUDA Riccati kernel for CUDA tensors and to
the plain `ops/lqr.py` for CPU tensors (`ops/riccati.solve_lqr_cuda`
decides by device).  ``mehrotra`` "pc" (affine probe, then the corrected
solve at sigma = (mu_aff / mu)^3) and "soc" (the centred solve, then one
corrected re-solve at the same mu) make two Riccati solves per iteration.
``elastic_obstacles`` softens each obstacle constraint to c + e - s = 0,
e >= 0, with the linear penalty ``elastic_penalty * e``; (ds, de, dnu) are
eliminated, so the Riccati system keeps its shape.  Mehrotra with elastic,
and any other ``mehrotra`` string, raise ValueError.

Solver lessons kept from the reference (do not regress): rho dominates all
multipliers including the dynamics adjoints; sigma = nu/s is never clipped
below its central-path value; merit acceptance carries a rounding and
curvature tolerance in the small-step regime only; the all-rejected
fallback executes the deepest candidate only if its merit is finite; dual
steps are coupled to the primal alpha, with the kappa clamp as backstop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import pin_full_f32
from ..config import MPCConfig
from ..models import costs, unicycle
from ..ops.lqr import LQRData
from ..ops.riccati import solve_lqr_cuda
from .problem import Diagnostics, Problem, Solution


def _floor(dtype) -> float:
    return 1e-14 if dtype == torch.float64 else 1e-10


def _sigma_max(dtype) -> float:
    """Dual/slack ratio safeguard (IPOPT's kappa_Sigma analogue), far above
    the largest legitimate central-path sigma."""
    return 1e18 if dtype == torch.float64 else 1e12


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the batch axis -> [B]."""
    return x.flatten(1).sum(dim=1)


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1).amax(dim=1)


def _amin(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1).amin(dim=1)


def _col(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] per-scenario value shaped to broadcast against ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


class IPMState(NamedTuple):
    states: torch.Tensor  # [B, N+1, 3]
    controls: torch.Tensor  # [B, N, 2]
    s_cl: torch.Tensor  # [B, N, 2]
    s_cu: torch.Tensor
    s_xl: torch.Tensor  # [B, N+1, 3]
    s_xu: torch.Tensor
    s_ob: torch.Tensor  # [B, N, K]
    nu_cl: torch.Tensor
    nu_cu: torch.Tensor
    nu_xl: torch.Tensor
    nu_xu: torch.Tensor
    nu_ob: torch.Tensor
    # Elastic variables of the obstacle constraints (c + e - s = 0, e >= 0);
    # ones and unused unless elastic_obstacles is set.
    e_ob: torch.Tensor  # [B, N, K]
    reg: torch.Tensor  # [B] adaptive Levenberg regularization
    sigma: torch.Tensor  # [B] adaptive centering parameter


class _Masks(NamedTuple):
    cl: torch.Tensor  # [B, N, 2]
    cu: torch.Tensor
    xl: torch.Tensor  # [B, N+1, 3]
    xu: torch.Tensor
    ob: torch.Tensor  # [B, N, K]


def _check_supported(cfg: MPCConfig) -> None:
    sc = cfg.solver
    if sc.mehrotra not in ("off", "pc", "soc"):
        raise ValueError(
            f"unknown mehrotra mode {sc.mehrotra!r}; expected 'off', 'pc' or 'soc'"
        )
    if sc.mehrotra != "off" and sc.elastic_obstacles:
        raise ValueError(
            "mehrotra predictor-corrector does not support elastic_obstacles"
        )


def _constraint_masks(cfg: MPCConfig, problem: Problem, dtype) -> _Masks:
    N, K = cfg.horizon, cfg.max_obstacles
    B = problem.initial_state.shape[0]
    fin = lambda x, n: torch.isfinite(x)[:, None, :].expand(B, n, x.shape[-1]).to(dtype)
    return _Masks(
        fin(problem.control_lower, N),
        fin(problem.control_upper, N),
        fin(problem.state_lower, N + 1),
        fin(problem.state_upper, N + 1),
        (problem.obstacle_mask > 0.5)[:, None, :].expand(B, N, K).to(dtype),
    )


def _finite(bound: torch.Tensor) -> torch.Tensor:
    """Replace +-inf bound entries (masked anyway) by 0, as [B, 1, n]."""
    return torch.where(torch.isfinite(bound), bound, torch.zeros_like(bound))[:, None, :]


def _constraint_values(cfg: MPCConfig, problem: Problem, states, controls):
    """Values of every inequality family c(z) (>= 0 when feasible); masked
    entries are forced to 1.  Also returns the obstacle normals [B, N, K, 2],
    the floored distances and the masks."""
    m = _constraint_masks(cfg, problem, states.dtype)
    c_cl = controls - _finite(problem.control_lower)
    c_cu = _finite(problem.control_upper) - controls
    c_xl = states - _finite(problem.state_lower)
    c_xu = _finite(problem.state_upper) - states
    p = states[:, 1:, :2]  # [B, N, 2]
    diff = p[:, :, None, :] - problem.obstacle_centers.transpose(1, 2)  # [B,N,K,2]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-16)  # [B, N, K]
    c_ob = (
        dist
        - problem.obstacle_radii[:, None, :]
        - problem.inflation_radius[:, None, None]
    )
    one = lambda c, mask: torch.where(mask > 0, c, torch.ones_like(c))
    vals = (
        one(c_cl, m.cl), one(c_cu, m.cu), one(c_xl, m.xl), one(c_xu, m.xu),
        one(c_ob, m.ob),
    )
    # Floored distance: a point on an obstacle center has no usable normal.
    dist_safe = torch.clamp(dist, min=1e-2)
    normals = diff / dist_safe[..., None]
    return vals, normals, dist_safe, m


def _init_state(cfg: MPCConfig, problem: Problem) -> IPMState:
    states = problem.warm_states
    controls = problem.warm_controls
    vals, _, _, m = _constraint_values(cfg, problem, states, controls)
    mu0 = cfg.solver.mu_init
    B = states.shape[0]

    def init_pair(c, mask):
        on = mask > 0
        s = torch.where(on, torch.clamp(c, min=1e-2), torch.ones_like(c))
        nu = torch.where(on, mu0 / s, torch.zeros_like(c))
        return s, nu

    pairs = [init_pair(c, mask) for c, mask in zip(vals, m)]
    s_ob = pairs[4][0]
    if cfg.solver.elastic_obstacles:
        # Central-ish elastic init: e solves c + e = s where violated, else
        # sits at its barrier-central value mu / rho_e.
        e_ob = torch.where(
            m.ob > 0,
            torch.clamp(s_ob - vals[4], min=mu0 / cfg.solver.elastic_penalty),
            torch.ones_like(s_ob),
        )
    else:
        e_ob = torch.ones_like(s_ob)
    full = lambda v: torch.full((B,), v, dtype=states.dtype, device=states.device)
    return IPMState(
        states, controls,
        *(s for s, _ in pairs),
        *(nu for _, nu in pairs),
        e_ob,
        reg=full(cfg.solver.reg),
        sigma=full(cfg.solver.mu_sigma),
    )


def _slacks(it: IPMState):
    return (it.s_cl, it.s_cu, it.s_xl, it.s_xu, it.s_ob)


def _duals(it: IPMState):
    return (it.nu_cl, it.nu_cu, it.nu_xl, it.nu_xu, it.nu_ob)


def _sigma(nu, s, mask):
    return torch.clamp(
        mask * nu / torch.clamp(s, min=_floor(s.dtype)), 0.0, _sigma_max(s.dtype)
    )


def _grad_coef(c, s, nu, mask, mu, corr=None):
    """Condensed gradient coefficient g_i = (mu - corr_i)/s - sigma*(c - s);
    ``mu`` is [B] shaped to broadcast, ``corr`` the Mehrotra correction
    ds_aff * dnu_aff of the family (None for the plain system)."""
    sig = _sigma(nu, s, mask)
    num = mu - corr if corr is not None else mu
    return mask * (num / torch.clamp(s, min=_floor(s.dtype)) - sig * (c - s)), sig


class Elastic(NamedTuple):
    """Condensed quantities of an elastic inequality c + e - s = 0."""

    g: torch.Tensor  # gradient coefficient of the z rows
    T: torch.Tensor  # mu/s - nu
    r_e: torch.Tensor  # rho_e - mu/e - nu
    r_c: torch.Tensor  # c + e - s
    sig_s: torch.Tensor  # nu/s
    sig_e: torch.Tensor  # mu/e^2
    sig_eff: torch.Tensor  # (1/sig_s + 1/sig_e)^-1, the condensed stiffness


def elastic_coef(c, s, nu, e, mask, mu, rho_e, floor, sigma_max) -> Elastic:
    """Eliminating (ds, de, dnu) from the primal-dual Newton system of
    c + e - s = 0 leaves the stiffness sig_eff = (1/sig_s + 1/sig_e)^-1
    and the gradient coefficient

        g = nu - sig_eff*r_c + sig_eff*(T/sig_s + r_e/sig_e);

    as sig_e -> inf (e pinned at 0) this is the hard coefficient
    mu/s - sig_s*(c - s).  ``floor`` and ``sigma_max`` are the caller's."""
    s_safe = torch.clamp(s, min=floor)
    e_safe = torch.clamp(e, min=floor)
    sig_s = torch.clamp(mask * nu / s_safe, 0.0, sigma_max)
    sig_e = torch.clamp(mu / (e_safe * e_safe), 0.0, sigma_max)
    sig_eff = mask * sig_s * sig_e / torch.clamp(sig_s + sig_e, min=floor)
    T = mu / s_safe - nu
    r_e = rho_e - mu / e_safe - nu
    r_c = c + e - s
    g = mask * (nu - sig_eff * r_c
                + sig_eff * (T / torch.clamp(sig_s, min=floor) + r_e / sig_e))
    return Elastic(g, T, r_e, r_c, sig_s, sig_e, sig_eff)


def elastic_step(el: Elastic, mask, jdz, floor):
    """The eliminated (ds, de, dnu) for the constraint step ``jdz`` = J dz."""
    beta = el.sig_e / torch.clamp(el.sig_s + el.sig_e, min=floor)
    ds = mask * beta * (jdz + el.r_c + (el.T - el.r_e) / el.sig_e)
    de = mask * (el.T - el.r_e - el.sig_s * ds) / el.sig_e
    return ds, de, mask * (el.T - el.sig_s * ds)


def _elastic(cfg: MPCConfig, it: IPMState, c_ob, mask, mu) -> Elastic:
    dtype = it.states.dtype
    return elastic_coef(c_ob, it.s_ob, it.nu_ob, it.e_ob, mask, mu,
                        cfg.solver.elastic_penalty, _floor(dtype), _sigma_max(dtype))


def _merit(cfg: MPCConfig, problem: Problem, states, controls, slacks, mu, rho):
    """l1 merit per scenario: barrier objective + rho * equality residuals.
    ``slacks`` = (s_cl, s_cu, s_xl, s_xu, s_ob), with e_ob appended in
    elastic mode, where the obstacle consistency is |c + e - s| and the
    objective gains rho_e*e - mu*ln(e)."""
    vals, _, _, m = _constraint_values(cfg, problem, states, controls)
    obj = costs.total_cost(cfg.cost, states, controls, problem.goal_state)
    log_term = 0.0
    consist = 0.0
    for c, s, mask in zip(vals[:4], slacks[:4], m[:4]):
        log_term = log_term + _sum(mask * torch.log(torch.clamp(s, min=1e-30)))
        consist = consist + _sum(mask * torch.abs(c - s))
    c_ob, s_ob = vals[4], slacks[4]
    if s_ob.numel():
        log_term = log_term + _sum(m.ob * torch.log(torch.clamp(s_ob, min=1e-30)))
        if cfg.solver.elastic_obstacles:
            e_ob = slacks[5]
            log_term = log_term + _sum(m.ob * torch.log(torch.clamp(e_ob, min=1e-30)))
            obj = obj + cfg.solver.elastic_penalty * _sum(m.ob * e_ob)
            consist = consist + _sum(m.ob * torch.abs(c_ob + e_ob - s_ob))
        else:
            consist = consist + _sum(m.ob * torch.abs(c_ob - s_ob))
    d = unicycle.defects(states, controls, cfg.time_step)
    pin = problem.initial_state - states[:, 0]
    eq = _sum(torch.abs(d)) + _sum(torch.abs(pin))
    return obj - mu * log_term + rho * (eq + consist)


class _Corr(NamedTuple):
    """Mehrotra second-order corrections ds_aff * dnu_aff per family."""

    cl: torch.Tensor
    cu: torch.Tensor
    xl: torch.Tensor
    xu: torch.Tensor
    ob: torch.Tensor


def _build_lqr(cfg: MPCConfig, problem: Problem, it: IPMState, mu,
               corr: _Corr | None = None) -> LQRData:
    """Assemble the condensed stage-wise quadratic model ([B] ``mu``).
    ``corr`` (Mehrotra) changes only the gradient coefficients."""
    sc = cfg.solver
    dtype = it.states.dtype
    (c_cl, c_cu, c_xl, c_xu, c_ob), normals, dist, m = _constraint_values(
        cfg, problem, it.states, it.controls
    )
    gx, gu = costs.stage_gradients(cfg.cost, it.states, it.controls, problem.goal_state)
    Hx, Hu = costs.stage_hessians(cfg.cost, it.states, it.controls)
    mu3 = mu[:, None, None]
    cr = lambda f: getattr(corr, f) if corr is not None else None

    g_cl, sig_cl = _grad_coef(c_cl, it.s_cl, it.nu_cl, m.cl, mu3, cr("cl"))
    g_cu, sig_cu = _grad_coef(c_cu, it.s_cu, it.nu_cu, m.cu, mu3, cr("cu"))
    qu = gu - g_cl + g_cu
    Hu_diag = Hu + sig_cl + sig_cu

    g_xl, sig_xl = _grad_coef(c_xl, it.s_xl, it.nu_xl, m.xl, mu3, cr("xl"))
    g_xu, sig_xu = _grad_coef(c_xu, it.s_xu, it.nu_xu, m.xu, mu3, cr("xu"))
    qx = gx - g_xl + g_xu
    Qxx = torch.diag_embed(Hx + sig_xl + sig_xu)  # [B, N+1, 3, 3]
    Quu = torch.diag_embed(Hu_diag)  # [B, N, 2, 2]

    if cfg.max_obstacles > 0:
        if sc.elastic_obstacles:
            el = _elastic(cfg, it, c_ob, m.ob, mu3)
            g_ob, sig_ob = el.g, el.sig_eff
        else:
            g_ob, sig_ob = _grad_coef(c_ob, it.s_ob, it.nu_ob, m.ob, mu3, cr("ob"))
        n = normals  # [B, N, K, 2]
        qx[:, 1:, :2] -= torch.einsum("btkd,btk->btd", n, g_ob)
        # Gauss-Newton term sum_k sigma_k n n'.
        H_ob = torch.einsum("btk,btkd,btke->btde", sig_ob, n, n)
        if sc.obstacle_curvature:
            # Exact curvature (I - n n')/dist weighted by -nu, damped so the
            # 2x2 block stays positive definite (reference ipm.py:380-393).
            w = -m.ob * it.nu_ob / torch.clamp(dist, min=1e-6)
            w = torch.maximum(w, -0.9 * sig_ob)
            eye = torch.eye(2, dtype=dtype, device=w.device)
            H_curv = w.sum(dim=-1)[..., None, None] * eye - torch.einsum(
                "btk,btkd,btke->btde", w, n, n
            )
            H_ob = H_ob + H_curv
        Qxx[:, 1:, :2, :2] += H_ob

    # Levenberg shift: static floor + adaptive component.
    reg = (sc.reg + it.reg)[:, None, None]
    Qxx.diagonal(dim1=-2, dim2=-1).add_(reg)
    Quu.diagonal(dim1=-2, dim2=-1).add_(reg)

    A, B = unicycle.linearize(it.states, it.controls, cfg.time_step)
    d = unicycle.defects(it.states, it.controls, cfg.time_step)
    d0 = problem.initial_state - it.states[:, 0]
    return LQRData(
        A=A, B=B, d=d.contiguous(), d0=d0.contiguous(), Qxx=Qxx,
        qx=qx.contiguous(), Quu=Quu, qu=qu.contiguous(),
    )


def _ftb(v, dv, tau):
    """Fraction-to-boundary step limit per scenario ([B])."""
    ratio = torch.where(
        dv < 0, -tau * v / torch.clamp(dv, max=-1e-30), torch.ones_like(v)
    )
    return torch.clamp(_amin(ratio), max=1.0)


def _iteration(cfg: MPCConfig, problem: Problem, it: IPMState, mu) -> IPMState:
    """One Newton step with line search.  ``mu`` is the barrier parameter,
    or for mehrotra="pc" the raw mean complementarity that the affine probe
    rescales."""
    sc = cfg.solver
    dtype = it.states.dtype
    floor = _floor(dtype)
    vals, normals, _, m = _constraint_values(cfg, problem, it.states, it.controls)
    elastic = sc.elastic_obstacles and it.s_ob.numel() > 0

    def all_steps(dx, du, mu_b, corr: _Corr | None = None):
        """Slack and dual steps ds = J dz + (c - s),
        dnu = (mu - corr)/s - nu - sigma ds, per family."""
        jdz = (du, -du, dx, -dx, torch.einsum("btkd,btd->btk", normals, dx[:, 1:, :2]))
        out = []
        for i, (c, s, nu, mask, j) in enumerate(zip(vals, _slacks(it), _duals(it), m, jdz)):
            ds = mask * (j + c - s)
            num = mu_b - corr[i] if corr is not None else mu_b
            dnu = mask * (num / torch.clamp(s, min=floor) - nu - _sigma(nu, s, mask) * ds)
            out.append((ds, dnu))
        return out, jdz[4]

    def ftb_all(pairs):
        alpha = torch.ones_like(mu)
        for v, dv in pairs:
            if v.numel():
                alpha = torch.minimum(alpha, _ftb(v, dv, sc.tau))
        return alpha

    if sc.mehrotra == "pc":
        # Affine-scaling predictor (mu = 0): how far pure Newton pushes the
        # complementarity.  It shares the Hessian with the corrector; only
        # the right-hand side differs.
        zero = torch.zeros_like(mu)
        sol_aff = solve_lqr_cuda(_build_lqr(cfg, problem, it, zero), sc.reg)
        aff, _ = all_steps(sol_aff.dx, sol_aff.du, zero[:, None, None])
        a_aff = torch.minimum(
            ftb_all([(s, d[0]) for s, d in zip(_slacks(it), aff)]),
            ftb_all([(nu, d[1]) for nu, d in zip(_duals(it), aff)]),
        )
        a3 = a_aff[:, None, None]
        tot = torch.zeros_like(mu)
        cnt = torch.zeros_like(mu)
        for s, nu, mask, (ds, dnu) in zip(_slacks(it), _duals(it), m, aff):
            if s.numel():
                tot = tot + _sum(mask * (s + a3 * ds) * (nu + a3 * dnu))
                cnt = cnt + _sum(mask)
        mu_aff = tot / torch.clamp(cnt, min=1.0)
        # Mehrotra's centring sigma = (mu_aff / mu)^3: near 0 when the
        # affine step is unblocked, near 1 when blocked.
        sigma_m = torch.clamp((mu_aff / torch.clamp(mu, min=floor)) ** 3, 0.0, 1.0)
        mu_floor = max(sc.mu_min, 50.0 * torch.finfo(dtype).eps)
        mu = torch.clamp(sigma_m * mu, mu_floor, sc.mu_init)
        corr = _Corr(*(ds * dnu for ds, dnu in aff))
    elif sc.mehrotra == "soc":
        # The centred solve plays predictor; its ds * dnu products feed one
        # corrected re-solve at the same mu.
        sol_c = solve_lqr_cuda(_build_lqr(cfg, problem, it, mu), sc.reg)
        pre, _ = all_steps(sol_c.dx, sol_c.du, mu[:, None, None])
        corr = _Corr(*(ds * dnu for ds, dnu in pre))
    else:
        corr = None
    mu3 = mu[:, None, None]

    data = _build_lqr(cfg, problem, it, mu, corr)
    sol = solve_lqr_cuda(data, sc.reg)
    dx, du = sol.dx, sol.du
    steps, jdz_ob = all_steps(dx, du, mu3, corr)
    ds_all = [ds for ds, _ in steps]
    dnu_all = [dnu for _, dnu in steps]
    if elastic:
        el = _elastic(cfg, it, vals[4], m.ob, mu3)
        ds_all[4], de_ob, dnu_all[4] = elastic_step(el, m.ob, jdz_ob, floor)

    alpha_s = ftb_all(list(zip(_slacks(it), ds_all)) + ([(it.e_ob, de_ob)] if elastic else []))
    alpha_nu = ftb_all(list(zip(_duals(it), dnu_all)))

    # Parallel backtracking candidates [B, ls].
    ladder = sc.ls_backtrack ** torch.arange(sc.ls_iters, dtype=dtype, device=mu.device)
    alphas = alpha_s[:, None] * ladder

    # l1 penalty weight: dominate the inequality duals and the dynamics
    # adjoints (one adjoint sweep of the condensed gradients).
    nu_max = torch.zeros_like(mu)
    for v, mask in zip(_duals(it), m):
        if v.numel():
            nu_max = torch.maximum(nu_max, _amax(mask * v))
    lam = data.qx[:, -1]
    lam_max = _amax(torch.abs(lam))
    AT = data.A.transpose(-1, -2)
    for t in range(cfg.horizon - 1, -1, -1):
        lam = data.qx[:, t] + (AT[:, t] @ lam.unsqueeze(-1)).squeeze(-1)
        lam_max = torch.maximum(lam_max, _amax(torch.abs(lam)))
    rho = torch.clamp(2.0 * torch.maximum(nu_max, lam_max), min=sc.merit_penalty)

    def merit_at(alpha):
        return _merit(
            cfg, problem,
            it.states + _col(alpha, dx) * dx,
            it.controls + _col(alpha, du) * du,
            tuple(s + _col(alpha, ds) * ds for s, ds in zip(_slacks(it), ds_all))
            + ((it.e_ob + _col(alpha, de_ob) * de_ob,) if elastic else ()),
            mu, rho,
        )

    merit0 = merit_at(torch.zeros_like(mu))
    merits = torch.stack([merit_at(alphas[:, j]) for j in range(sc.ls_iters)], dim=1)
    # Accept the largest alpha whose merit does not rise beyond rounding
    # noise plus, in the small-step Newton regime only, the curvature budget.
    eps = torch.finfo(dtype).eps
    step_inf = torch.maximum(_amax(torch.abs(dx)), _amax(torch.abs(du)))
    newton_regime = step_inf < (1e-4 if dtype == torch.float64 else 1e-2)
    tol = 16.0 * eps * (1.0 + torch.abs(merit0)) + torch.where(
        newton_regime, 10.0 * rho * step_inf * step_inf, torch.zeros_like(rho)
    )
    ok = torch.isfinite(merits) & (merits <= (merit0 + tol)[:, None])
    idx = torch.argmax(ok.to(torch.uint8), dim=1)  # first True
    any_ok = ok.any(dim=1)
    # All-rejected fallback: the deepest candidate, only if its merit is finite.
    alpha = torch.where(
        any_ok,
        torch.gather(alphas, 1, idx[:, None])[:, 0],
        torch.where(
            torch.isfinite(merits[:, -1]), alphas[:, -1], torch.zeros_like(mu)
        ),
    )
    # Dual step coupled to the accepted primal step.
    alpha_nu = torch.minimum(alpha_nu, alpha)

    KAPPA = 1e10

    def clamp(nu_new, s_new, mask):
        center = mu3 / torch.clamp(s_new, min=floor)
        return mask * torch.minimum(torch.maximum(nu_new, center / KAPPA), center * KAPPA)

    a3 = alpha[:, None, None]
    an3 = alpha_nu[:, None, None]
    s_new = [s + a3 * ds for s, ds in zip(_slacks(it), ds_all)]
    nu_new = [
        clamp(nu + an3 * dnu, s_n, mask)
        for nu, dnu, s_n, mask in zip(_duals(it), dnu_all, s_new, m)
    ]
    # Grow reg on genuine large-step merit rejections, decay otherwise.
    grow = (~any_ok) | ((idx >= 4) & ~newton_regime)
    reg = torch.where(
        grow,
        torch.clamp(torch.clamp(it.reg, min=sc.reg) * 8.0, max=1e8),
        torch.clamp(it.reg / 3.0, min=sc.reg),
    )
    e_new = it.e_ob + a3 * de_ob if elastic else it.e_ob
    sigma = it.sigma
    if sc.mu_sigma_max > 0.0:
        # Adaptive centering: throttled steps outside the Newton regime slow
        # the schedule toward max(mu_sigma_max, mu_sigma); healthy steps
        # decay it back to mu_sigma.
        sigma = torch.where(
            (alpha < 0.25) & ~newton_regime,
            torch.clamp(it.sigma * 1.5, max=max(sc.mu_sigma_max, sc.mu_sigma)),
            torch.clamp(it.sigma * 0.9, min=sc.mu_sigma),
        )
    return IPMState(
        it.states + a3 * dx,
        it.controls + a3 * du,
        *s_new,
        *nu_new,
        e_new,
        reg=reg,
        sigma=sigma,
    )


def _diagnostics(cfg: MPCConfig, problem: Problem, it: IPMState, mu) -> Diagnostics:
    """Exact KKT residuals with adjoint-estimated dynamics multipliers."""
    vals, normals, _, m = _constraint_values(cfg, problem, it.states, it.controls)
    gx, gu = costs.stage_gradients(cfg.cost, it.states, it.controls, problem.goal_state)
    gx_L = gx - m.xl * it.nu_xl + m.xu * it.nu_xu
    gu_L = gu - m.cl * it.nu_cl + m.cu * it.nu_cu
    if cfg.max_obstacles > 0:
        gx_L = gx_L.clone()
        gx_L[:, 1:, :2] -= torch.einsum("btkd,btk->btd", normals, m.ob * it.nu_ob)
    A, B = unicycle.linearize(it.states, it.controls, cfg.time_step)
    AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)

    lam = gx_L[:, -1]
    r_u_max = None
    for t in range(cfg.horizon - 1, -1, -1):
        r_u = gu_L[:, t] + (BT[:, t] @ lam.unsqueeze(-1)).squeeze(-1)
        lam = gx_L[:, t] + (AT[:, t] @ lam.unsqueeze(-1)).squeeze(-1)
        r = _amax(torch.abs(r_u))
        r_u_max = r if r_u_max is None else torch.maximum(r_u_max, r)
    # IPOPT-style scaling of the dual residual (its s_d, s_max = 100).
    nu_sum = torch.zeros_like(mu)
    nu_cnt = torch.zeros_like(mu)
    for v, mask in zip(_duals(it), m):
        if v.numel():
            nu_sum = nu_sum + _sum(mask * torch.abs(v))
            nu_cnt = nu_cnt + _sum(mask)
    s_max = 100.0
    s_d = torch.clamp(nu_sum / torch.clamp(nu_cnt, min=1.0), min=s_max) / s_max
    stationarity = r_u_max / s_d

    d = unicycle.defects(it.states, it.controls, cfg.time_step)
    pin = problem.initial_state - it.states[:, 0]
    viol = torch.zeros_like(mu)
    comp = torch.zeros_like(mu)
    for c, s, nu, mask in zip(vals, _slacks(it), _duals(it), m):
        if c.numel():
            viol = torch.maximum(viol, _amax(mask * torch.clamp(-c, min=0.0)))
            comp = torch.maximum(comp, _amax(mask * torch.abs(s * nu)))
    feasibility = torch.maximum(
        torch.maximum(_amax(torch.abs(d)), _amax(torch.abs(pin))), viol
    )
    eps = torch.finfo(it.states.dtype).eps
    tol = max(cfg.solver.kkt_tol, 50.0 * eps ** 0.5)
    comp_scaled = comp / s_d
    converged = (
        (stationarity < tol)
        & (feasibility < tol)
        & (comp_scaled < max(10.0 * cfg.solver.mu_min, tol))
    )
    final_cost = costs.total_cost(cfg.cost, it.states, it.controls, problem.goal_state)
    return Diagnostics(
        converged=converged,
        kkt_stationarity=stationarity,
        kkt_feasibility=feasibility,
        kkt_complementarity=comp,
        final_cost=final_cost,
        final_mu=mu,
    )


def _mean_complementarity(it: IPMState, masks: _Masks) -> torch.Tensor:
    total = torch.zeros_like(it.reg)
    count = torch.zeros_like(it.reg)
    for s, nu, mask in zip(_slacks(it), _duals(it), masks):
        if s.numel():
            total = total + _sum(mask * s * nu)
            count = count + _sum(mask)
    return total / torch.clamp(count, min=1.0)


def _adaptive_mu(cfg: MPCConfig, it: IPMState, masks: _Masks) -> torch.Tensor:
    sc = cfg.solver
    comp = _mean_complementarity(it, masks)
    # The barrier floor respects the dtype (50 eps), as in the reference.
    mu_floor = max(sc.mu_min, 50.0 * torch.finfo(it.states.dtype).eps)
    return torch.clamp(it.sigma * comp, mu_floor, sc.mu_init)


def solve(cfg: MPCConfig, problem: Problem) -> Solution:
    """Solve a batch of MPC scenarios ([B] leading axis on every leaf) on
    the device its tensors lie on, in their dtype.  Float32 matrix products
    on the card are pinned to full float32 (no TF32)."""
    _check_supported(cfg)
    pin_full_f32()
    with torch.no_grad():
        it = _init_state(cfg, problem)
        masks = _constraint_masks(cfg, problem, it.states.dtype)
        for _ in range(cfg.solver.iterations):
            if cfg.solver.mehrotra == "pc":
                # Predictor-corrector centres itself from the raw mean
                # complementarity (sigma_m = (mu_aff / comp)^3).
                mu = _mean_complementarity(it, masks)
            else:
                mu = _adaptive_mu(cfg, it, masks)
            it = _iteration(cfg, problem, it, mu)
        diag = _diagnostics(cfg, problem, it, _adaptive_mu(cfg, it, masks))
    return Solution(states=it.states, controls=it.controls, diagnostics=diag)
