"""Port parity of elastic obstacle mode on both backends.

Split path (`solver/ipm.py`), float64, against the JAX `ipm.solve` on the
three scenarios of tests/test_elastic.py, to 1e-9.  The symmetric-deadlock
scenario is held at 20 iterations: there the two runs are bit-identical
through 5 iterations, after which the ill-conditioned stationary point
amplifies round-off about tenfold every two iterations (measured 1e-16 at 8,
1e-11 at 20, 3e-5 at 30); at the full count the port is held to the
reference test's own properties instead.

Fused plain version (`ops/ipm_fused.py`), float32, against the JAX fused
kernel in interpret mode on the batch of tests/test_elastic.py (one
feasible scenario, one start trapped inside an inflated disk), to 1e-5
through 20 iterations (measured 8e-7): both do the kernel's arithmetic in
float32 in different summation orders, so they agree to a few ulps of the
iterate per iteration.  At the full 40 iterations the feasible scenario has
converged at the float32 noise floor, where flat directions drift (measured
2e-5), so there the reference test's own 2e-4 budget holds, with identical
converged flags.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import default_problem, problem_with_obstacles
from kissmpc_tpu.obstacles import static_set
from kissmpc_tpu.ops.pallas.ipm_fused import solve_batch_fused as j_fused
from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import solve_batch
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
from kissmpc_tpu_torch.solver import ipm as tipm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(kw, **solver):
    j, t = JConfig(**kw), TConfig(**kw)
    return (j.replace(solver=dataclasses.replace(j.solver, **solver)),
            t.replace(solver=dataclasses.replace(t.solver, **solver)))


def _port(jp, batched=False):
    lead = (lambda v: np.asarray(v)) if batched else (lambda v: np.asarray(v)[None])
    return problem_from_numpy({k: lead(v) for k, v in jp._asdict().items()}, device="cpu")


def _feasible(jcfg):
    obs = static_set([[0.8, 0.05], [2.5, 2.5]], [0.25, 0.3], max_obstacles=2,
                     dtype=jnp.float64)
    return problem_with_obstacles(jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.6, 0.1, 0.0]),
                                  obs, inflation_radius=0.4, dtype=jnp.float64)


def _deadlock(jcfg):
    """Warm start straight through a disk on its symmetry axis, both
    conditioning passes off."""
    obs = static_set([[0.4, 0.0]], [0.2], dtype=jnp.float64)
    n = jcfg.horizon
    warm_states = np.stack([np.linspace(0, 1, n + 1), np.zeros(n + 1), np.zeros(n + 1)], axis=1)
    return problem_with_obstacles(
        jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0]), obs,
        inflation_radius=0.2, warm_states=jnp.asarray(warm_states),
        warm_controls=jnp.asarray(np.tile(np.array([0.5, 0.0]), (n, 1))),
        repair_warm_start_states=False, complete_warm_start_states=False, dtype=jnp.float64,
    )


def _free(jcfg):
    return default_problem(jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.5, 0.0]),
                           dtype=jnp.float64)


CASES = {
    "feasible": (dict(horizon=20, time_step=0.1, max_obstacles=2), {}, _feasible),
    "deadlock": (dict(horizon=20, time_step=0.1, max_obstacles=1), dict(iterations=20),
                 _deadlock),
    "no_obstacles": (dict(horizon=15, time_step=0.1), {}, _free),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_elastic_matches_jax(case):
    kw, solver, build = CASES[case]
    jcfg, tcfg = _configs(kw, elastic_obstacles=True, **solver)
    jp = build(jcfg)
    ref = jax.jit(lambda p: jipm.solve(jcfg, p))(jp)
    got = solution_to_numpy(tipm.solve(tcfg, _port(jp)))
    np.testing.assert_allclose(got.controls[0], np.asarray(ref.controls), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.states[0], np.asarray(ref.states), rtol=0, atol=1e-9)
    assert bool(got.diagnostics.converged[0]) == bool(ref.diagnostics.converged)
    for name in ("kkt_feasibility", "final_cost", "final_mu"):
        np.testing.assert_allclose(getattr(got.diagnostics, name)[0],
                                   np.asarray(getattr(ref.diagnostics, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_split_elastic_matches_hard_when_feasible():
    _, hard = _configs(CASES["feasible"][0])
    jcfg, elastic = _configs(CASES["feasible"][0], elastic_obstacles=True)
    tp = _port(_feasible(jcfg))
    s_hard, s_el = tipm.solve(hard, tp), tipm.solve(elastic, tp)
    assert bool(s_hard.diagnostics.converged[0]) and bool(s_el.diagnostics.converged[0])
    np.testing.assert_allclose(s_el.controls.numpy(), s_hard.controls.numpy(), rtol=0, atol=1e-9)


def test_split_elastic_is_a_noop_without_obstacles():
    _, hard = _configs(CASES["no_obstacles"][0])
    jcfg, elastic = _configs(CASES["no_obstacles"][0], elastic_obstacles=True)
    tp = _port(_free(jcfg))
    assert torch.equal(tipm.solve(elastic, tp).controls, tipm.solve(hard, tp).controls)


def test_split_elastic_deadlock_is_stationary_and_honest():
    """The reference test's properties at the full iteration count: a
    stationary elastic point with bounded duals that reports infeasibility."""
    jcfg, tcfg = _configs(CASES["deadlock"][0], elastic_obstacles=True)
    sol = tipm.solve(tcfg, _port(_deadlock(jcfg)))
    d = sol.diagnostics
    assert bool(torch.isfinite(sol.states).all())
    assert float(d.kkt_stationarity[0]) < 1e-2
    assert float(d.kkt_feasibility[0]) > 0.1
    assert not bool(d.converged[0])


FUSED_KW = dict(horizon=10, time_step=0.1, max_obstacles=2)


@functools.lru_cache(maxsize=None)
def _fused_case():
    """The JAX interpret-mode kernel, one compile with the trip count as a
    runtime argument, and the batch of tests/test_elastic.py."""
    jcfg, tcfg = _configs(FUSED_KW, elastic_obstacles=True)
    obs = static_set([[0.6, 0.0], [2.5, 2.5]], [0.3, 0.2], max_obstacles=2, dtype=jnp.float32)
    starts = jnp.asarray([[0.0, -1.2, 0.0], [0.55, 0.05, 0.0]], jnp.float32)
    goals = jnp.asarray([[1.4, -1.0, 0.0], [1.6, 0.0, 0.0]], jnp.float32)
    jp = jax.vmap(lambda s, g: problem_with_obstacles(
        jcfg, s, g, obs, inflation_radius=0.35, dtype=jnp.float32))(starts, goals)
    kernel = jax.jit(lambda p, it: j_fused(jcfg, p, iterations=it, interpret=True, bt=2, sb=1))
    return jcfg, tcfg, jp, kernel


@pytest.mark.parametrize("iterations", [0, 1, 10, 20])
def test_fused_plain_elastic_matches_jax_kernel(iterations):
    _, tcfg, jp, kernel = _fused_case()
    ref = jax.tree.map(np.asarray, kernel(jp, iterations))
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp, batched=True),
                                              iterations=iterations))
    scale = max(1.0, np.abs(ref.states).max(), np.abs(ref.controls).max())
    np.testing.assert_allclose(got.states, ref.states, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.controls, ref.controls, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(got.diagnostics.converged, ref.diagnostics.converged)
    np.testing.assert_allclose(got.diagnostics.final_cost, ref.diagnostics.final_cost,
                               rtol=1e-5)


def test_fused_plain_elastic_full_solve_matches_jax_kernel():
    jcfg, tcfg, jp, kernel = _fused_case()
    ref = jax.tree.map(np.asarray, kernel(jp, jcfg.solver.iterations))
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp, batched=True)))
    np.testing.assert_allclose(got.controls, ref.controls, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got.diagnostics.converged, ref.diagnostics.converged)
    assert got.diagnostics.converged.tolist() == [True, False]  # the trapped start is honest
    assert np.isfinite(got.diagnostics.final_cost).all()


@pytest.mark.parametrize("backend", ["fused", "split"])
def test_dispatch_accepts_elastic(backend):
    """Both backends run elastic batches through `solve_batch` on the CPU
    (float32: the fused plain version; split: the torch IPM)."""
    from kissmpc_tpu_torch.scenarios import obstacle_problems

    cfg = TConfig(horizon=8, time_step=0.1, max_obstacles=2)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, elastic_obstacles=True, solve_backend=backend, iterations=12,
        refine_stages=((0.5, 8, 0.2),)))
    sol = solve_batch(cfg, obstacle_problems(cfg, 4, seed=1, device="cpu"), device="cpu")
    assert bool(torch.isfinite(sol.diagnostics.final_cost).all())
    assert bool(torch.isfinite(sol.states).all())
