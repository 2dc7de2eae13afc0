"""Port parity: the batched torch IPM against `jax.vmap(ipm.solve)`, compiled.

One problem batch per case, built by the JAX package and handed to the port
through the numpy bridge.  float64: controls to 1e-6 and identical
`converged` flags; float32: controls to 1e-3 without obstacles and 2e-3 with
them (the budget of tests/test_ipm_fused.py).  All six Diagnostics fields
are compared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.obstacles import obstacles as jobs
from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu.solver.problem import default_problem, problem_with_obstacles
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.solver import ipm as tipm

N, DT = 12, 0.1
PAIRS = [
    ((0.0, 0.0, 0.0), (1.0, 0.4, 0.0)),
    ((0.2, -0.3, 1.0), (0.8, 0.6, 0.5)),
    ((0.0, 0.0, -2.0), (-0.5, 0.5, 0.0)),
    ((0.0, -0.4, 0.5), (1.2, 0.3, 0.0)),
    ((0.1, 0.1, 0.0), (30.0, 0.0, 0.0)),  # far goal: bound-riding
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(K, mu_sigma_max):
    kw = dict(horizon=N, time_step=DT, max_obstacles=K)
    skw = dict(iterations=32, mu_sigma_max=mu_sigma_max)
    j = JConfig(**kw)
    t = TConfig(**kw)
    return (
        j.replace(solver=dataclasses.replace(j.solver, **skw)),
        t.replace(solver=dataclasses.replace(t.solver, solve_backend="split", **skw)),
    )


def _problems(cfg, K, dynamic, dtype):
    """The JAX problems of PAIRS, built once per key, in one compiled call:
    the JAX build reads only the horizon, the time step, the obstacle slots
    and ``bound_y`` of ``cfg`` (op by op, its repair and rollout take
    seconds per problem)."""
    key = (cfg.horizon, cfg.time_step, cfg.max_obstacles, cfg.bound_y, K, dynamic,
           jnp.dtype(dtype))
    if key not in _BUILT:
        _BUILT[key] = _build_problems(cfg, K, dynamic, dtype)
    return _BUILT[key]


_BUILT = {}


def _build_problems(cfg, K, dynamic, dtype):
    starts = jnp.asarray([s for s, _ in PAIRS], dtype)
    goals = jnp.asarray([g for _, g in PAIRS], dtype)
    if K == 0:
        return jax.jit(jax.vmap(lambda s, g: default_problem(cfg, s, g, dtype=dtype)))(
            starts, goals)
    if dynamic:
        obs = jobs.dynamic_set([[0.6, 0.05], [0.9, 0.7]], [1.6, -2.0], 0.4,
                               radius=0.2, max_obstacles=K, dtype=dtype)
    else:
        obs = jobs.static_set([[0.6, 0.05], [2.5, 2.5]], [0.2, 0.2],
                              max_obstacles=K, dtype=dtype)
    return jax.jit(jax.vmap(lambda s, g: problem_with_obstacles(
        cfg, s, g, obs, inflation_radius=0.25, prediction_dt=DT, dtype=dtype)))(starts, goals)


CASES = [
    # K, dynamic, mu_sigma_max, dtype, control tolerance
    (0, False, 0.0, "float64", 1e-6),
    (2, False, 0.0, "float64", 1e-6),
    (2, True, 0.0, "float64", 1e-6),
    (2, True, 0.7, "float64", 1e-6),
    (0, False, 0.0, "float32", 1e-3),
    (2, False, 0.0, "float32", 2e-3),
    (2, True, 0.7, "float32", 2e-3),
]


@pytest.mark.parametrize("K,dynamic,mu_sigma_max,dtype,tol", CASES)
def test_ipm_matches_jax(K, dynamic, mu_sigma_max, dtype, tol):
    jcfg, tcfg = _configs(K, mu_sigma_max)
    jp = _problems(jcfg, K, dynamic, getattr(jnp, dtype))
    ref = jax.jit(jax.vmap(functools.partial(jipm.solve, jcfg)))(jp)
    tp = problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                            device="cpu")
    got = solution_to_numpy(tipm.solve(tcfg, tp))

    assert got.controls.dtype == np.dtype(dtype)
    err = np.max(np.abs(got.controls - np.asarray(ref.controls)))
    assert err <= tol, f"torch vs jax max control diff {err:.2e}"
    np.testing.assert_allclose(got.states, np.asarray(ref.states), atol=tol, rtol=0)
    rd = ref.diagnostics
    if dtype == "float64":
        np.testing.assert_array_equal(got.diagnostics.converged, np.asarray(rd.converged))
        rel = dict(kkt_stationarity=1e-5, kkt_feasibility=1e-9,
                   kkt_complementarity=1e-9, final_cost=1e-9, final_mu=1e-9)
    else:
        # f32 residuals sit at rounding level; their agreement is relative
        # to the quantity's own scale.
        assert np.mean(got.diagnostics.converged == np.asarray(rd.converged)) >= 0.8
        rel = dict(kkt_stationarity=5e-2, kkt_feasibility=1e-3,
                   kkt_complementarity=1e-3, final_cost=1e-4, final_mu=1e-3)
    for name, rtol in rel.items():
        a = np.asarray(getattr(rd, name), np.float64)
        b = getattr(got.diagnostics, name).astype(np.float64)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol, err_msg=name)


def test_ipm_refuses_unported_modes():
    """Every mode of the reference is ported now (Mehrotra "pc"/"soc" and
    elastic obstacles: tests/test_torch_mehrotra.py, test_torch_elastic.py);
    what remains refused is what the reference refuses or never defined:
    an unknown mode string, and Mehrotra combined with elastic."""
    _, tcfg = _configs(0, 0.0)
    tp = problem_from_numpy(
        {k: np.asarray(v) for k, v in
         _problems(_configs(0, 0.0)[0], 0, False, jnp.float64)._asdict().items()},
        device="cpu",
    )
    for kw, err in (
        (dict(mehrotra="Off"), ValueError),
        (dict(mehrotra="pc", elastic_obstacles=True), ValueError),
        (dict(mehrotra="soc", elastic_obstacles=True), ValueError),
    ):
        cfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver, **kw))
        with pytest.raises(err):
            tipm.solve(cfg, tp)


def test_ipm_keeps_float32_on_the_cpu():
    _, tcfg = _configs(0, 0.0)
    tp = problem_from_numpy(
        {k: np.asarray(v) for k, v in
         _problems(_configs(0, 0.0)[0], 0, False, jnp.float32)._asdict().items()},
        device="cpu",
    )
    sol = tipm.solve(tcfg, tp)
    assert sol.controls.dtype == torch.float32
    assert sol.controls.device.type == "cpu"
    assert sol.diagnostics.converged.dtype == torch.bool
