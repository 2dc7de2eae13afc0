"""Port parity of the Mehrotra modes of the split IPM, "pc"
(predictor-corrector) and "soc" (second-order corrector), in float64
against the JAX `ipm.solve`, after tests/test_ipm_basic.py's Mehrotra
cases.  Both make two Riccati solves per iteration; the port agrees with
JAX to round-off (1e-9), converged or not ("soc" deadlocks on these
problems in the reference too, and is held to the same iterates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import default_problem, problem_with_obstacles
from kissmpc_tpu.obstacles import static_set
from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import make_solver
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.ops import riccati


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


def _free(jcfg):
    return default_problem(jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.5, 0.8, 0.5]),
                           dtype=jnp.float64)


def _obstacle(jcfg):
    obs = static_set([[0.8, 0.05], [2.5, 2.5]], [0.25, 0.3], max_obstacles=2,
                     dtype=jnp.float64)
    return problem_with_obstacles(jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.6, 0.1, 0.0]),
                                  obs, inflation_radius=0.4, dtype=jnp.float64)


CASES = {
    "free": (dict(horizon=15, time_step=0.1), _free),
    "obstacle": (dict(horizon=15, time_step=0.1, max_obstacles=2), _obstacle),
}


def _port(jp):
    return problem_from_numpy({k: np.asarray(v)[None] for k, v in jp._asdict().items()},
                              device="cpu")


@pytest.mark.parametrize("mode", ["pc", "soc"])
@pytest.mark.parametrize("case", list(CASES))
def test_mehrotra_matches_jax(mode, case):
    kw, build = CASES[case]
    jcfg, tcfg = _configs(kw, mehrotra=mode)
    jp = build(jcfg)
    ref = jax.jit(lambda p: jipm.solve(jcfg, p))(jp)
    got = solution_to_numpy(make_solver(tcfg, device="cpu")(_port(jp)))
    np.testing.assert_allclose(got.controls[0], np.asarray(ref.controls), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.states[0], np.asarray(ref.states), rtol=0, atol=1e-9)
    assert bool(got.diagnostics.converged[0]) == bool(ref.diagnostics.converged)
    for name in ("kkt_stationarity", "kkt_feasibility", "final_cost", "final_mu"):
        np.testing.assert_allclose(getattr(got.diagnostics, name)[0],
                                   np.asarray(getattr(ref.diagnostics, name)),
                                   rtol=1e-7, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_pc_matches_baseline_solution(case):
    """As in tests/test_ipm_basic.py: "pc" converges to the baseline's KKT
    point (and clears the active obstacle by the margin)."""
    kw, build = CASES[case]
    jcfg, pc = _configs(kw, mehrotra="pc")
    _, base = _configs(kw)
    tp = _port(build(jcfg))
    a, b = make_solver(base, device="cpu")(tp), make_solver(pc, device="cpu")(tp)
    assert bool(a.diagnostics.converged[0]) and bool(b.diagnostics.converged[0])
    assert float((a.controls - b.controls).abs().max()) <= 1e-4
    if kw.get("max_obstacles"):
        d = np.linalg.norm(b.states[0, 1:, :2].numpy() - np.array([0.8, 0.05]), axis=1) - 0.25
        assert float(d.min()) >= 0.4 - 1e-6


@pytest.mark.parametrize("mode", ["pc", "soc"])
def test_two_riccati_solves_per_iteration(mode, monkeypatch):
    """Each iteration makes two Newton-KKT solves (predictor or centred
    solve, then the corrected one); "off" makes one."""
    from kissmpc_tpu_torch.solver import ipm

    calls = []
    real = riccati.solve_lqr_cuda

    def counting(data, reg=0.0):
        calls.append(1)
        return real(data, reg)

    monkeypatch.setattr(ipm, "solve_lqr_cuda", counting)
    kw, build = CASES["free"]
    jcfg, tcfg = _configs(kw, mehrotra=mode, iterations=7)
    make_solver(tcfg, device="cpu")(_port(build(jcfg)))
    assert len(calls) == 14
    calls.clear()
    _, off = _configs(kw, iterations=7)
    make_solver(off, device="cpu")(_port(build(jcfg)))
    assert len(calls) == 7


def test_mehrotra_with_elastic_is_refused():
    kw, build = CASES["free"]
    jcfg, tcfg = _configs(kw, mehrotra="pc", elastic_obstacles=True)
    with pytest.raises(ValueError, match="elastic"):
        make_solver(tcfg, device="cpu")(_port(build(jcfg)))
