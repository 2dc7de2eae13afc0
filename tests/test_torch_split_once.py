"""The split solve's init and diagnostics on the CPU: their plain versions
against the JAX package, and the kernels' wrappers.

`ipm.init_plain` (`_init_state` and the first `_next_mu`) is held against
the JAX `_init_state` (`kissmpc_tpu/solver/ipm.py:180`) and its first mu
(`_adaptive_mu`, or `_mean_complementarity` under "pc") on five problems
(tests/test_torch_ipm.py's pairs, N=12); `ipm.diagnostics_plain`
(`_adaptive_mu` and `_diagnostics`) against the JAX `_diagnostics`
(`:715`) at the final `_adaptive_mu` (`:817`), on tests/test_torch_ipm_split.py's
iterate off the central path.  Hard and elastic, K=0 and K=4, "pc",
float32 and float64; every field within 1e-9 (float64) or 1e-4 (float32)
of its scale, ``converged`` equal.

A split `ipm.solve` runs the init wrapper, the iterations' three
wrappers and the diagnostics wrapper, in that order, once each per solve
and per iteration; on the CPU each runs its plain version.  The wrappers'
card path (`ipm_split._init`, `_diagnostics`) is driven through a
stand-in launcher: the parameters (the config's, the dtype's floors and
thresholds), the Problem's and the iterate's pointers (the first iterate's
trajectory is the warm start's), the outputs, one launch counted each, no
host round-trip; and the wrappers' input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu_torch.bridge import problem_from_numpy
from kissmpc_tpu_torch.ops import ipm_split
from kissmpc_tpu_torch.scenarios import obstacle_problems
from kissmpc_tpu_torch.solver import ipm as tipm

from .test_torch_capture import _SyncOps
from .test_torch_ipm_split import CASES, DTYPES, _assert_close, _case, _configs
from .test_torch_ipm import _problems


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run beside others in parallel
    workers, where many threads per worker only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ONCE_CASES = ["free", "k4", "k4_elastic", "k4_pc"]


def _rtol(dtype):
    return 1e-9 if dtype == "float64" else 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ONCE_CASES)
def test_init_plain_matches_jax_init_state(name, dtype):
    K, dynamic, solver = CASES[name]
    jcfg, tcfg = _configs(K, solver)
    jdt = getattr(jnp, dtype)
    jp = _problems(jcfg, K, dynamic, jdt)
    jit = jax.vmap(lambda p: jipm._init_state(jcfg, p))(jp)
    masks = jax.vmap(lambda p: jipm._constraint_masks(jcfg, p, jdt))(jp)
    if solver.get("mehrotra") == "pc":
        jmu = jax.vmap(lambda i, m: jipm._mean_complementarity(i, m, jdt))(jit, masks)
    else:
        jmu = jax.vmap(lambda i, m: jipm._adaptive_mu(jcfg, i, m, jdt))(jit, masks)
    tp = problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    it, mu = tipm.init_plain(tcfg, tp)
    for field in tipm.IPMState._fields:
        _assert_close(getattr(it, field), getattr(jit, field), _rtol(dtype), field)
    _assert_close(mu, jmu, _rtol(dtype), "mu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ONCE_CASES)
def test_diagnostics_plain_matches_jax_diagnostics(name, dtype):
    jcfg, tcfg, jp, jit, _, tp, tit, _ = _case(name, dtype)
    jdt = getattr(jnp, dtype)
    masks = jax.vmap(lambda p: jipm._constraint_masks(jcfg, p, jdt))(jp)
    jmu = jax.vmap(lambda i, m: jipm._adaptive_mu(jcfg, i, m, jdt))(jit, masks)
    ref = jax.vmap(lambda p, i, m: jipm._diagnostics(jcfg, p, i, m))(jp, jit, jmu)
    got = tipm.diagnostics_plain(tcfg, tp, tit)
    assert np.array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for field in ref._fields[1:]:
        _assert_close(getattr(got, field), getattr(ref, field), _rtol(dtype), field)


def test_solve_runs_init_iterations_and_diagnostics_through_the_wrappers(monkeypatch):
    """`ipm.solve` calls the init wrapper once, each iteration's three
    wrappers once per iteration, then the diagnostics wrapper once: on the
    card 1 + 3 x iterations + 1 launches."""
    _, cfg = _configs(3, {"iterations": 4})
    p = obstacle_problems(cfg, 3, seed=4, n_dynamic=1, device="cpu")
    calls = []

    def spy(module, name, label):
        real = getattr(module, name)

        def inner(*args, **kwargs):
            calls.append(label)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, inner)

    spy(ipm_split, "init_cuda", "init")
    spy(ipm_split, "condense_cuda", "condense")
    spy(tipm, "solve_lqr_cuda", "riccati")
    spy(ipm_split, "step_cuda", "step")
    spy(ipm_split, "diagnostics_cuda", "diagnostics")
    got = tipm.solve(cfg, p)
    assert calls == ["init"] + ["condense", "riccati", "step"] * 4 + ["diagnostics"]
    ref = tipm.solve_plain(cfg, p)
    for x, y in zip((got.states, got.controls, *got.diagnostics),
                    (ref.states, ref.controls, *ref.diagnostics)):
        assert torch.equal(x, y)


class _Launcher:
    """Stands in for the library: records what each launcher is handed,
    writes nothing, returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def _record(self, kind, params, problem, iterate, out, stream):
        self.calls.append((kind, params._obj, problem._obj, iterate._obj, out, stream))
        return self.err

    def kissmpc_split_init_f32(self, *a):
        return self._record("init_f32", *a)

    def kissmpc_split_init_f64(self, *a):
        return self._record("init_f64", *a)

    def kissmpc_split_diagnostics_f32(self, *a):
        return self._record("diagnostics_f32", *a)

    def kissmpc_split_diagnostics_f64(self, *a):
        return self._record("diagnostics_f64", *a)

    def kissmpc_cuda_error_string(self, err):
        return b"stand-in failure"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["off", "pc"])
def test_card_path_hands_init_and_diagnostics_cfg_and_pointers(dtype, mode):
    """One launch each with the config's parameters (the dtype's mu floor
    and KKT thresholds, raw mu under "pc", elastic off), the Problem's and
    the iterate's pointers in their field order (the first iterate's
    trajectory the warm start's tensors), mu and the Diagnostics of the
    right shapes, each launch counted, no host round-trip."""
    _, cfg = _configs(3, {"mehrotra": mode, "mu_sigma_max": 0.6, "kkt_tol": 1e-12})
    p = tipm._contiguous(obstacle_problems(cfg, 3, seed=1, n_dynamic=1, dtype=dtype,
                                           device="cpu"))
    lib = _Launcher()
    before = (ipm_split.init_cuda.launches, ipm_split.diagnostics_cuda.launches)
    with _SyncOps() as sync:
        it, mu = ipm_split._init(lib, 0, cfg, p)
        diag = ipm_split._diagnostics(lib, 0, cfg, p, it)
    assert not sync.seen, dict(sync.seen)
    assert (ipm_split.init_cuda.launches - before[0],
            ipm_split.diagnostics_cuda.launches - before[1]) == (1, 1)
    suffix = "f32" if dtype == torch.float32 else "f64"
    assert [c[0] for c in lib.calls] == [f"init_{suffix}", f"diagnostics_{suffix}"]
    eps = torch.finfo(dtype).eps
    tol = max(1e-12, 50.0 * eps ** 0.5)
    for _, params, problem, iterate, _, stream in lib.calls:
        assert (params.B, params.N, params.K, stream) == (3, cfg.horizon, 3, 0)
        assert params.raw_mu == (mode == "pc") and params.elastic == 0
        assert params.mu_floor == max(cfg.solver.mu_min, 50.0 * eps)
        assert params.kkt_tol == tol
        assert params.comp_tol == max(10.0 * cfg.solver.mu_min, tol)
        assert [getattr(problem, f) for f in p._fields[:10]] == [x.data_ptr() for x in p[:10]]
        assert [getattr(iterate, f) for f in ipm_split.ITERATE_FIELDS] == [
            x.data_ptr() for x in it]
    assert it.states is p.warm_states and it.controls is p.warm_controls
    assert lib.calls[0][4] == mu.data_ptr() and tuple(mu.shape) == (3,)
    out = lib.calls[1][4]._obj
    assert [getattr(out, f) for f in diag._fields] == [x.data_ptr() for x in diag]
    assert diag.converged.dtype == torch.bool and tuple(diag.final_cost.shape) == (3,)
    for field in ("s_ob", "nu_ob", "e_ob"):
        assert tuple(getattr(it, field).shape) == (3, cfg.horizon, 3)


def test_card_path_raises_on_a_failed_launch():
    _, cfg = _configs(2, {})
    p = tipm._contiguous(obstacle_problems(cfg, 2, seed=1, n_dynamic=1, device="cpu"))
    with pytest.raises(RuntimeError, match="stand-in failure"):
        ipm_split._init(_Launcher(err=98), 0, cfg, p)
    it, _ = tipm.init_plain(cfg, p)
    with pytest.raises(RuntimeError, match="stand-in failure"):
        ipm_split._diagnostics(_Launcher(err=98), 0, cfg, p, it)


def test_once_wrappers_check_their_inputs():
    """Wrong dtype, shape or layout raise before any work."""
    _, cfg = _configs(2, {})
    p = tipm._contiguous(obstacle_problems(cfg, 2, seed=1, n_dynamic=1, device="cpu"))
    it, _ = tipm.init_plain(cfg, p)
    with pytest.raises(ValueError, match="warm_states"):
        ipm_split.init_cuda(cfg, p._replace(warm_states=p.warm_states[:, :-1]))
    with pytest.raises(ValueError, match="contiguous"):
        ipm_split.init_cuda(cfg, p._replace(warm_controls=p.warm_controls.transpose(
            1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(TypeError):
        ipm_split.diagnostics_cuda(cfg, p, it._replace(sigma=it.sigma.double()))
    with pytest.raises(ValueError, match="shape"):
        ipm_split.diagnostics_cuda(cfg, p, it._replace(nu_ob=it.nu_ob[:, :-1]))


def test_once_wrappers_run_the_plain_versions_on_the_cpu():
    _, cfg = _configs(2, {"elastic_obstacles": True})
    p = tipm._contiguous(obstacle_problems(cfg, 2, seed=1, n_dynamic=1, device="cpu"))
    it, mu = ipm_split.init_cuda(cfg, p)
    ref_it, ref_mu = tipm.init_plain(cfg, p)
    for x, y in zip((*it, mu), (*ref_it, ref_mu), strict=True):
        assert torch.equal(x, y)
    for x, y in zip(ipm_split.diagnostics_cuda(cfg, p, it), tipm.diagnostics_plain(cfg, p, it),
                    strict=True):
        assert torch.equal(x, y)
