"""The split iteration's plain halves against the JAX package, and the
kernels' wrapper on the CPU.

`ipm.condense_plain` is held against the JAX `_build_lqr`
(`kissmpc_tpu/solver/ipm.py:328`), and one iteration, `condense_plain`
-> `ops/lqr.py::solve_lqr` -> `step_plain` (Mehrotra's predictor first
for "pc" and "soc"), against the JAX `_iteration` (`:407`), on the same
iterate: the JAX `_init_state` of five problems (tests/test_torch_ipm.py's
pairs, N=12), moved off the central path by a numpy seed, carried to the
port by numpy.  Hard and elastic, K=0 and K=4, with and without the
curvature term, "pc" and "soc", float32 and float64.  Tolerances, each
relative to the field's largest magnitude (at least 1): float64 1e-9 for
the condensation and 1e-8 for the iteration; float32 1e-4 for both (the
two frameworks round in different orders; the line search takes the same
candidate on every scenario of these iterates).

On the CPU `ipm.solve` runs the plain halves through the wrappers and is
bitwise `ipm.solve_plain`.  The wrappers' card path (`_condense`,
`_step`) is driven through a stand-in launcher: the parameters and
pointers it hands the kernels, the step's layout (warps per scenario from
the batch, or forced) and its optional merit outputs, the launch counters,
a failed launch, and no host round-trip on the way; and the wrappers'
input checks.  `step_plain` asked for its merits returns the same step bit
for bit, and its merit at alpha = 0 is the JAX `_merit` (`:272`) at the
iterate with the same rho.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch.bridge import problem_from_numpy
from kissmpc_tpu_torch.ops import ipm_split
from kissmpc_tpu_torch.ops.lqr import solve_lqr
from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
from kissmpc_tpu_torch.solver import ipm as tipm

from .test_torch_capture import _SyncOps
from .test_torch_ipm import N, _problems


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run beside others in parallel
    workers, where many threads per worker only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# name -> (K, dynamic obstacles, solver fields)
CASES = {
    "free": (0, False, {}),
    "k4": (4, True, {"mu_sigma_max": 0.7}),
    "k4_nocurv": (4, False, {"obstacle_curvature": False, "ls_iters": 3}),
    "k4_elastic": (4, True, {"elastic_obstacles": True}),
    "k4_pc": (4, True, {"mehrotra": "pc"}),
    "k4_soc": (4, False, {"mehrotra": "soc"}),
}
DTYPES = ["float32", "float64"]


def _configs(K, solver):
    kw = dict(horizon=N, time_step=0.1, max_obstacles=K)
    j, t = JConfig(**kw), TConfig(**kw)
    return (j.replace(solver=dataclasses.replace(j.solver, **solver)),
            t.replace(solver=dataclasses.replace(t.solver, solve_backend="split", **solver)))


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """(jcfg, tcfg, JAX problem, JAX iterate, JAX mu, port problem, port
    iterate, port mu): an iterate off the central path, made by a numpy
    seed from the JAX init state; mu the JAX one (the raw mean
    complementarity for "pc")."""
    K, dynamic, solver = CASES[name]
    jcfg, tcfg = _configs(K, solver)
    jdt = getattr(jnp, dtype)
    jp = _problems(jcfg, K, dynamic, jdt)
    it = jax.vmap(lambda p: jipm._init_state(jcfg, p))(jp)
    masks = jax.vmap(lambda p: jipm._constraint_masks(jcfg, p, jdt))(jp)
    rng = np.random.default_rng(sum(map(ord, name)))
    arr = {f: np.array(getattr(it, f)) for f in it._fields}
    for f in ("states", "controls"):
        arr[f] = arr[f] + 0.03 * rng.standard_normal(arr[f].shape)
    for fam in ("cl", "cu", "xl", "xu", "ob"):
        on = np.asarray(getattr(masks, fam)) > 0
        for f in (f"s_{fam}", f"nu_{fam}") + (("e_ob",) if fam == "ob" else ()):
            scaled = arr[f] * np.exp(0.3 * rng.standard_normal(arr[f].shape))
            arr[f] = np.where(on, scaled, arr[f])
    B = arr["reg"].shape[0]
    arr["reg"] = 1e-8 * 10.0 ** rng.uniform(0.0, 2.0, B)
    arr["sigma"] = rng.uniform(0.2, 0.7, B)
    arr = {k: v.astype(dtype) for k, v in arr.items()}
    jit = jipm.IPMState(**{k: jnp.asarray(v) for k, v in arr.items()})
    if solver.get("mehrotra") == "pc":
        jmu = jax.vmap(lambda i, m: jipm._mean_complementarity(i, m, jdt))(jit, masks)
    else:
        jmu = jax.vmap(lambda i, m: jipm._adaptive_mu(jcfg, i, m, jdt))(jit, masks)
    tp = problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    tit = tipm.IPMState(**{k: torch.from_numpy(v) for k, v in arr.items()})
    tmu = torch.from_numpy(np.array(jmu))
    return jcfg, tcfg, jp, jit, jmu, tp, tit, tmu


def _assert_close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"{what}: max|port-jax| {err:.3e} > {rtol:g} x scale {scale:.3e}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_condense_plain_matches_jax_build_lqr(name, dtype):
    jcfg, tcfg, jp, jit, jmu, tp, tit, tmu = _case(name, dtype)
    ref = jax.jit(jax.vmap(functools.partial(jipm._build_lqr, jcfg)))(jp, jit, jmu)
    got = tipm.condense_plain(tcfg, tp, tit, tmu)
    for f in got._fields:
        assert getattr(got, f).dtype == getattr(torch, dtype)
        _assert_close(getattr(got, f), getattr(ref, f), 1e-9 if dtype == "float64" else 1e-4,
                      f"LQRData.{f}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_iteration_matches_jax_iteration(name, dtype):
    """condense_plain -> solve_lqr -> step_plain (after the predictor for
    "pc"/"soc") is the JAX `_iteration`; the step's next mu is the JAX
    `_adaptive_mu` (or mean complementarity) of the new iterate."""
    jcfg, tcfg, jp, jit, jmu, tp, tit, tmu = _case(name, dtype)
    ref = jax.jit(jax.vmap(functools.partial(jipm._iteration, jcfg)))(jp, jit, jmu)
    got = tipm._iteration(tcfg, tp, tit, tmu)
    rtol = 1e-8 if dtype == "float64" else 1e-4
    for f in got.it._fields:
        _assert_close(getattr(got.it, f), getattr(ref, f), rtol, f"IPMState.{f}")
    jdt = getattr(jnp, dtype)
    masks = jax.vmap(lambda p: jipm._constraint_masks(jcfg, p, jdt))(jp)
    if tcfg.solver.mehrotra == "pc":
        ref_mu = jax.vmap(lambda i, m: jipm._mean_complementarity(i, m, jdt))(ref, masks)
    else:
        ref_mu = jax.vmap(lambda i, m: jipm._adaptive_mu(jcfg, i, m, jdt))(ref, masks)
    _assert_close(got.mu, ref_mu, rtol, "next mu")
    assert bool(((got.alpha >= 0) & (got.alpha <= 1)).all())


@pytest.mark.parametrize("name", list(CASES))
def test_solve_on_the_cpu_is_solve_plain_bitwise(name):
    """On CPU tensors the wrappers run the plain halves: `solve` (through
    `condense_cuda`, `solve_lqr_cuda`, `step_cuda`) and `solve_plain`
    give the same bits."""
    K, _, solver = CASES[name]
    _, tcfg = _configs(K, {**solver, "iterations": 6})
    p = obstacle_problems(tcfg, 4, seed=2, n_dynamic=1, device="cpu") if K else \
        free_problems(tcfg, 4, seed=2, device="cpu")
    a, b = tipm.solve(tcfg, p), tipm.solve_plain(tcfg, p)
    for x, y in zip((a.states, a.controls, *a.diagnostics), (b.states, b.controls, *b.diagnostics)):
        assert torch.equal(x, y)


def test_iterate_fields_are_ipm_states():
    assert ipm_split.ITERATE_FIELDS == tipm.IPMState._fields


class _Launcher:
    """Stands in for the library: records what each launcher is handed,
    writes nothing, returns ``err``."""

    def __init__(self, err=0, scratch=0):
        self.err = err
        self.scratch = scratch
        self.calls = []

    def _record(self, kind, params, *rest):
        self.calls.append((kind, params._obj, rest))
        return self.err

    def kissmpc_split_condense_f32(self, *a):
        return self._record("condense_f32", *a)

    def kissmpc_split_condense_f64(self, *a):
        return self._record("condense_f64", *a)

    def kissmpc_split_step_f32(self, *a):
        return self._record("step_f32", *a)

    def kissmpc_split_step_f64(self, *a):
        return self._record("step_f64", *a)

    def kissmpc_split_step_scratch_bytes(self, *a):
        return self.scratch

    def kissmpc_cuda_error_string(self, err):
        return b"stand-in failure"


def _iterate(cfg, dtype=torch.float32, B=3):
    p = tipm._contiguous(obstacle_problems(cfg, B, seed=1, n_dynamic=1, dtype=dtype,
                                           device="cpu"))
    it = tipm._init_state(cfg, p)
    mu = tipm._next_mu(cfg, it, tipm._constraint_masks(cfg, p, dtype))
    return p, it, mu


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["off", "pc"])
def test_card_path_hands_the_kernels_cfg_and_pointers(dtype, mode):
    """The card path launches once per call with the config's parameters
    (the dtype's mu floor, the line search, the modes), the iterate's
    pointers in IPMState order, the correction rows or nulls, outputs of
    the right shapes, and counts each launch; it issues no host
    round-trip."""
    _, cfg = _configs(3, {"mehrotra": mode, "ls_iters": 3, "mu_sigma_max": 0.6})
    p, it, mu = _iterate(cfg, dtype)
    corr = tipm._Corr(*(torch.rand_like(x) for x in (it.s_cl, it.s_cu, it.s_xl, it.s_xu,
                                                       it.s_ob))) if mode == "pc" else None
    lib = _Launcher()
    before = (ipm_split.condense_cuda.launches, ipm_split.step_cuda.launches)
    with _SyncOps() as sync:
        data = ipm_split._condense(lib, 0, cfg, p, it, mu, corr)
        sol = solve_lqr(tipm.condense_plain(cfg, p, it, mu, corr), cfg.solver.reg)
        step = ipm_split._step(lib, 0, cfg, p, it, mu, data, sol, corr)
    assert not sync.seen, dict(sync.seen)
    assert (ipm_split.condense_cuda.launches - before[0],
            ipm_split.step_cuda.launches - before[1]) == (1, 1)
    suffix = "f32" if dtype == torch.float32 else "f64"
    assert [c[0] for c in lib.calls] == [f"condense_{suffix}", f"step_{suffix}"]
    eps = torch.finfo(dtype).eps
    for _, params, rest in lib.calls:
        assert (params.B, params.N, params.K, params.ls_iters) == (3, cfg.horizon, 3, 3)
        assert params.raw_mu == (mode == "pc") and params.adaptive_sigma == 1
        assert params.mu_floor == max(cfg.solver.mu_min, 50.0 * eps)
        assert params.sigma_cap == 0.6 and params.elastic == 0 and params.curvature == 1
        iterate = rest[1]._obj
        assert [getattr(iterate, f) for f in ipm_split.ITERATE_FIELDS] == [
            x.data_ptr() for x in it]
        assert rest[2] == mu.data_ptr()
    corr_ptrs = lib.calls[0][2][3]._obj
    want = [None] * 5 if corr is None else [x.data_ptr() for x in corr]
    assert [getattr(corr_ptrs, f) for f in ipm_split.CORR_FIELDS] == want
    assert tuple(data.Qxx.shape) == (3, cfg.horizon + 1, 3, 3) and data.Qxx.dtype == dtype
    assert all(x.is_contiguous() for x in data)
    assert tuple(step.it.states.shape) == tuple(it.states.shape) and step.mu.shape == (3,)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["k4", "k4_elastic", "k4_pc"])
def test_step_plain_merits_leave_the_step_bitwise(name, dtype):
    """Asked for its merits, `step_plain` returns the same step bit for bit,
    the merits at alpha = 0 and at each candidate ([B, 1 + ls_iters]) and
    rho ([B], at least merit_penalty); the merit at alpha = 0 is the JAX
    `_merit` at the iterate with that rho (float64 1e-9, float32 1e-4 of
    its scale)."""
    jcfg, tcfg, jp, jit, jmu, tp, tit, tmu = _case(name, dtype)
    data = tipm.condense_plain(tcfg, tp, tit, tmu)
    sol = solve_lqr(data, tcfg.solver.reg)
    plain = tipm.step_plain(tcfg, tp, tit, tmu, data, sol)
    step, merits = tipm.step_plain(tcfg, tp, tit, tmu, data, sol, merits=True)
    for a, b in zip((*plain.it, plain.mu, plain.alpha), (*step.it, step.mu, step.alpha),
                    strict=True):
        assert torch.equal(a, b)
    B = tmu.shape[0]
    assert tuple(merits.merit.shape) == (B, 1 + tcfg.solver.ls_iters)
    assert tuple(merits.rho.shape) == (B,) and bool((merits.rho >= tcfg.solver.merit_penalty).all())
    slacks = (jit.s_cl, jit.s_cu, jit.s_xl, jit.s_xu, jit.s_ob, jit.e_ob)
    jrho = jnp.asarray(merits.rho.numpy())
    ref = jax.vmap(lambda p, x, u, s, m, r: jipm._merit(jcfg, p, x, u, s, m, r))(
        jp, jit.states, jit.controls, slacks, jmu, jrho)
    _assert_close(merits.merit[:, 0], ref, 1e-9 if dtype == "float64" else 1e-4, "merit at 0")


def test_step_layout_follows_the_batch():
    """One warp per scenario where the batch fills the card and the
    scenario is small, a block of several warps otherwise; the launch
    takes the wrapper's choice, a forced one, or raises outside
    1..MAX_WARPS; the merit outputs and a global arena reach the launcher
    only when asked for or needed."""
    for N, K in ((50, 0), (7, 4)):  # 506 and 104 elements
        assert ipm_split.step_warps(8192, N, K) == 1
        assert ipm_split.step_warps(ipm_split.ONE_WARP_MIN_BATCH, N, K) == 1
        for B in (ipm_split.ONE_WARP_MIN_BATCH - 1, 164, 1):
            assert ipm_split.step_warps(B, N, K) == ipm_split.SMALL_BATCH_WARPS
    assert ipm_split.step_warps(8192, 50, 8) == ipm_split.SMALL_BATCH_WARPS  # 906 elements
    _, cfg = _configs(3, {"ls_iters": 3})
    p, it, mu = _iterate(cfg)
    data = tipm.condense_plain(cfg, p, it, mu)
    sol = solve_lqr(data, cfg.solver.reg)
    lib = _Launcher()
    ipm_split._step(lib, 0, cfg, p, it, mu, data, sol)
    step, merits = ipm_split._step(lib, 0, cfg, p, it, mu, data, sol, merits=True, warps=1)
    big = _Launcher(scratch=640)
    ipm_split._step(big, 0, cfg, p, it, mu, data, sol, warps=2)
    (_, auto, rest0), (_, forced, rest1), (_, two, rest2) = lib.calls + big.calls
    assert (auto.warps, forced.warps, two.warps) == (ipm_split.SMALL_BATCH_WARPS, 1, 2)
    out0, out1, out2 = rest0[-2]._obj, rest1[-2]._obj, rest2[-2]._obj
    assert (out0.merit, out0.rho, out0.scratch) == (None, None, None)
    assert (out1.merit, out1.rho) == (merits.merit.data_ptr(), merits.rho.data_ptr())
    assert tuple(merits.merit.shape) == (3, 4) and tuple(merits.rho.shape) == (3,)
    assert out2.scratch is not None and out1.mu == step.mu.data_ptr()
    for warps in (0, ipm_split.MAX_WARPS + 1):
        with pytest.raises(ValueError, match="warps"):
            ipm_split._step(lib, 0, cfg, p, it, mu, data, sol, warps=warps)


def test_card_path_raises_on_a_failed_launch():
    _, cfg = _configs(2, {})
    p, it, mu = _iterate(cfg)
    with pytest.raises(RuntimeError, match="stand-in failure"):
        ipm_split._condense(_Launcher(err=98), 0, cfg, p, it, mu)


def test_wrappers_check_their_inputs():
    """Wrong dtype, shape, layout or line search raise before any work."""
    _, cfg = _configs(2, {})
    p, it, mu = _iterate(cfg)
    with pytest.raises(TypeError):
        ipm_split.condense_cuda(cfg, p, it, mu.double())
    with pytest.raises(ValueError, match="shape"):
        ipm_split.condense_cuda(cfg, p, it._replace(s_ob=it.s_ob[:, :-1]), mu)
    with pytest.raises(ValueError, match="contiguous"):
        ipm_split.condense_cuda(cfg, p._replace(obstacle_centers=p.obstacle_centers.transpose(
            2, 3).contiguous().transpose(2, 3)), it, mu)
    long = cfg.replace(solver=dataclasses.replace(cfg.solver, ls_iters=ipm_split.MAX_LS_ITERS + 1))
    with pytest.raises(ValueError, match="line-search"):
        ipm_split.condense_cuda(long, p, it, mu)
    data = tipm.condense_plain(cfg, p, it, mu)
    sol = solve_lqr(data, cfg.solver.reg)
    with pytest.raises(ValueError, match="dx"):
        ipm_split.step_cuda(cfg, p, it, mu, data, sol._replace(dx=sol.dx[:, :-1]))
    step = ipm_split.step_cuda(cfg, p, it, mu, data, sol)
    assert isinstance(step, tipm.Step)
