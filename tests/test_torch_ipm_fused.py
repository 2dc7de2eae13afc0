"""Port parity of the fused IPM (`kissmpc_tpu_torch/ops/ipm_fused.py`).

The same problem batches, built by the JAX package from fixed endpoints (or
drawn by its scenario sampler from a numpy seed) and handed to the port
through the numpy bridge, go through the JAX fused kernel
(`solve_batch_fused(..., interpret=True, bt=8)`, the way
tests/test_ipm_fused.py runs it on the CPU) and through the port's
`solve_batch_fused` on CPU tensors, which runs its plain version.  Each JAX
configuration is jitted once with the trip count and sigma as runtime
arguments, so one interpret-mode compile serves every case of it.

Tolerances: the plain version repeats the kernel's arithmetic in another
summation order, so at one iteration states and controls agree to 1e-5 of
their scale; over a full solve the f32 budget of tests/test_ipm_fused.py
(controls 1e-3 without obstacles, 2e-3 with them) with identical converged
flags.  Cases that the reference holds against its jnp path
(`ipm.solve`) are held against that path here, to the same budgets.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.obstacles import ObstacleSet, static_set
from kissmpc_tpu.ops.pallas.ipm_fused import solve_batch_fused as j_fused
from kissmpc_tpu.scenarios import obstacle_problems as j_obstacle_problems
from kissmpc_tpu.solver import ipm as jipm
from kissmpc_tpu.solver.api import make_batch_solver as j_make_batch_solver
from kissmpc_tpu.solver.problem import default_problem, problem_with_obstacles
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import solve_batch
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
from kissmpc_tpu_torch.ops.probe import dynamic_trip, dynamic_trip_plain

N, DT = 12, 0.1
FREE_PAIRS = [
    ((0.0, 0.0, 0.0), (1.0, 0.4, 0.0)),
    ((0.2, -0.3, 1.0), (0.8, 0.6, 0.5)),
    ((0.0, 0.0, -2.0), (-0.5, 0.5, 0.0)),
]
OBST_PAIRS = [
    ((0.0, 0.0, 0.0), (1.2, 0.1, 0.0)),
    ((0.0, -0.4, 0.5), (1.2, 0.3, 0.0)),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(K=0, **solver):
    kw = dict(horizon=N, time_step=DT, max_obstacles=K)
    j, t = JConfig(**kw), TConfig(**kw)
    return (j.replace(solver=dataclasses.replace(j.solver, **solver)),
            t.replace(solver=dataclasses.replace(t.solver, **solver)))


def _stack(ps):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *ps)


def _problems(jcfg, K, obstacles=None):
    """JAX Problem batch (f32) of the reference tests' endpoints; with the
    default obstacles built once per key (the JAX build reads only the
    horizon, the time step, the obstacle slots and ``bound_y`` of
    ``jcfg``)."""
    if obstacles is not None:
        return _build_problems(jcfg, K, obstacles)
    key = (jcfg.horizon, jcfg.time_step, jcfg.max_obstacles, jcfg.bound_y, K)
    if key not in _BUILT:
        _BUILT[key] = _build_problems(jcfg, K)
    return _BUILT[key]


_BUILT = {}


def _build_problems(jcfg, K, obstacles=None):
    if K == 0:
        return _stack([
            default_problem(jcfg, jnp.asarray(s, jnp.float32), jnp.asarray(g, jnp.float32),
                            dtype=jnp.float32)
            for s, g in FREE_PAIRS
        ])
    if obstacles is None:
        obstacles = static_set([[0.6, 0.05], [2.5, 2.5]], [0.2, 0.2], max_obstacles=K,
                               dtype=jnp.float32)
    return _stack([
        problem_with_obstacles(jcfg, jnp.asarray(s, jnp.float32), jnp.asarray(g, jnp.float32),
                               obstacles, inflation_radius=0.25, prediction_dt=DT,
                               dtype=jnp.float32)
        for s, g in OBST_PAIRS
    ])


def _port(jp, dtype=None):
    return problem_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                              device="cpu", dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_kernel(jcfg):
    """The JAX fused kernel in interpret mode, one compile per config, with
    the trip count and sigma as runtime arguments."""
    return jax.jit(lambda p, it, ms: j_fused(jcfg, p, iterations=it, mu_sigma=ms,
                                             interpret=True, bt=8))


def _run_jax(jcfg, jp, iterations=None, mu_sigma=None):
    it = jcfg.solver.iterations if iterations is None else iterations
    ms = jcfg.solver.mu_sigma if mu_sigma is None else mu_sigma
    return solution_to_numpy_jax(_jax_kernel(jcfg)(jp, it, jnp.float32(ms)))


def solution_to_numpy_jax(sol):
    return jax.tree.map(np.asarray, sol)


def _jnp_solve(jcfg, jp):
    """The reference's jnp path, `jax.vmap(ipm.solve)`, compiled."""
    return jax.jit(jax.vmap(functools.partial(jipm.solve, jcfg)))(jp)


@pytest.fixture(scope="module", params=[0, 2], ids=["free", "obstacles"])
def kernel_case(request):
    """(K, JAX configs, port config, JAX problems, JAX results at one
    iteration and at the full default count)."""
    K = request.param
    jcfg, tcfg = _configs(K)
    jp = _problems(jcfg, K)
    return K, jcfg, tcfg, jp, _run_jax(jcfg, jp, iterations=1), _run_jax(jcfg, jp)


def test_fused_matches_jax_kernel(kernel_case):
    K, _, tcfg, jp, _, ref = kernel_case
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp)))
    tol = 1e-3 if K == 0 else 2e-3
    err = np.max(np.abs(got.controls - ref.controls))
    assert err <= tol, f"port vs JAX fused kernel max control diff {err:.2e}"
    np.testing.assert_array_equal(got.diagnostics.converged, ref.diagnostics.converged)
    assert got.diagnostics.converged.all()
    if K:  # clearance holds
        p = got.states[:, 1:, :2]
        assert np.min(np.linalg.norm(p - np.array([0.6, 0.05]), axis=-1) - 0.2) >= 0.25 - 1e-3


def test_fused_one_iteration_matches_jax_kernel(kernel_case):
    _, _, tcfg, jp, ref, _ = kernel_case
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp), iterations=1))
    scale = max(1.0, np.abs(ref.states).max(), np.abs(ref.controls).max())
    np.testing.assert_allclose(got.states, ref.states, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.controls, ref.controls, rtol=0, atol=1e-5 * scale)
    for name in ("kkt_stationarity", "kkt_complementarity", "final_cost", "final_mu"):
        np.testing.assert_allclose(getattr(got.diagnostics, name),
                                   getattr(ref.diagnostics, name), rtol=2e-5, atol=1e-6,
                                   err_msg=name)


def test_runtime_stage_params_match_static():
    """iterations / mu_sigma as runtime inputs reproduce the statically
    configured solve bit for bit, and a per-scenario [B] sigma is accepted."""
    jstatic, tstatic = _configs(iterations=14, mu_sigma=0.35, mu_sigma_max=0.7)
    _, trt = _configs(iterations=5, mu_sigma=0.1, mu_sigma_max=0.7)
    tp = _port(_problems(jstatic, 0))
    ref = solve_batch_fused(tstatic, tp)
    rt = solve_batch_fused(trt, tp, iterations=14, mu_sigma=0.35)
    rt2 = solve_batch_fused(trt, tp, iterations=14, mu_sigma=torch.full((3,), 0.35))
    for got in (rt, rt2):
        assert torch.equal(got.controls, ref.controls)
        assert torch.equal(got.diagnostics.converged, ref.diagnostics.converged)
    # A per-scenario row is scenario-local: changing one scenario's sigma
    # leaves the others untouched.
    rt3 = solve_batch_fused(trt, tp, iterations=14,
                            mu_sigma=torch.tensor([0.35, 0.35, 0.6]))
    assert torch.equal(rt3.controls[:2], ref.controls[:2])
    assert not torch.equal(rt3.controls[2], ref.controls[2])


@pytest.mark.parametrize("stage_sigma", [None, 0.9], ids=["below_cap", "above_cap"])
def test_adaptive_sigma_matches_jax(stage_sigma):
    """mu_sigma_max > 0: per-scenario adaptive centering, capped at
    max(mu_sigma_max, runtime sigma) when a refine stage runs above the cap.
    Held against the JAX fused kernel with the same runtime sigma."""
    jcfg, tcfg = _configs(2, mu_sigma_max=0.7)
    jp = _problems(jcfg, 2)
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp), mu_sigma=stage_sigma))
    ref = _run_jax(jcfg, jp, mu_sigma=stage_sigma)
    np.testing.assert_allclose(got.controls, ref.controls, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got.diagnostics.converged, ref.diagnostics.converged)
    if stage_sigma is None:
        assert got.diagnostics.converged.all()


def _moving(angular_velocity):
    k = len(angular_velocity)
    return ObstacleSet(
        position=jnp.array([[0.7, -0.3], [0.4, 0.6]][:k], jnp.float32),
        radius=jnp.array([0.15, 0.2][:k], jnp.float32),
        orientation=jnp.array([2.2, -0.8][:k], jnp.float32),
        linear_velocity=jnp.array([0.6, 0.4][:k], jnp.float32),
        angular_velocity=jnp.asarray(angular_velocity, jnp.float32),
        active=jnp.ones((k,), jnp.float32),
    )


def test_affine_tracks_match_full_tracks():
    """Constant-velocity tracks shipped as (start, per-step delta) give the
    full-track solve to f32 noise, and the JAX kernel's affine result."""
    jcfg, tcfg = _configs(2)
    jaff, taff = _configs(2, fused_affine_tracks=True)
    jp = _problems(jcfg, 2, _moving([0.0, 0.0]))
    full = solution_to_numpy(solve_batch_fused(tcfg, _port(jp)))
    aff = solution_to_numpy(solve_batch_fused(taff, _port(jp)))
    assert np.max(np.abs(aff.controls - full.controls)) <= 1e-4
    np.testing.assert_array_equal(aff.diagnostics.converged, full.diagnostics.converged)
    ref = _run_jax(jaff, jp)
    np.testing.assert_allclose(aff.controls, ref.controls, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(aff.diagnostics.converged, ref.diagnostics.converged)


def test_affine_guard_flags_curved_tracks():
    """Curved tracks under fused_affine_tracks: convergence is withdrawn and
    the deviation surfaces as infeasibility; straight tracks pass."""
    jcfg, tcfg = _configs(1)
    _, taff = _configs(1, fused_affine_tracks=True)
    curved = _port(_problems(jcfg, 1, _moving([0.8])))
    sol = solve_batch_fused(taff, curved)
    assert not bool(sol.diagnostics.converged.any())
    assert float(sol.diagnostics.kkt_feasibility.min()) > 1e-2
    straight = _port(_problems(jcfg, 1, _moving([0.0])))
    np.testing.assert_array_equal(
        solve_batch_fused(taff, straight).diagnostics.converged.numpy(),
        solve_batch_fused(tcfg, straight).diagnostics.converged.numpy(),
    )


def test_diagnostics_match_jax_on_same_iterate():
    """iterations=0: both evaluate the exact KKT diagnostics at the warm
    start with the same slack/dual init, so every field agrees to f32
    rounding (against the reference's jnp path, as its own test does)."""
    jcfg, tcfg = _configs(2, iterations=0)
    obs = static_set([[0.6, 0.05], [1.8, 1.5]], [0.2, 0.25], max_obstacles=2,
                     dtype=jnp.float32)
    jp = _stack([
        problem_with_obstacles(jcfg, jnp.asarray(s, jnp.float32), jnp.asarray(g, jnp.float32),
                               obs, inflation_radius=0.25, dtype=jnp.float32)
        for s, g in [((0.0, 0.0, 0.0), (1.2, 0.1, 0.0)),
                     ((0.0, -0.4, 0.5), (1.5, 0.9, 0.0)),
                     ((0.3, 0.2, -1.0), (-0.5, 0.4, 1.0))]
    ])
    got = solution_to_numpy(solve_batch_fused(tcfg, _port(jp))).diagnostics
    ref = _jnp_solve(jcfg, jp).diagnostics
    np.testing.assert_array_equal(got.converged, np.asarray(ref.converged))
    for name in ("kkt_stationarity", "kkt_feasibility", "kkt_complementarity",
                 "final_cost", "final_mu"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(ref, name)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)


def test_nonfinite_direction_freezes_not_detonates():
    """A goal at 1e19 overflows the f32 merit: every candidate is
    non-finite, so the lane freezes instead of taking a NaN step."""
    kw = dict(horizon=8, time_step=0.1)
    jp = _stack([default_problem(JConfig(**kw), [0.0, 0.0, 0.0], [1e19, 0.0, 0.0],
                                 dtype=jnp.float32)])
    sol = solve_batch_fused(TConfig(**kw), _port(jp))
    assert bool(torch.isfinite(sol.states).all())
    assert not bool(sol.diagnostics.converged[0])


STAGES = ((0.5, 16, 0.2), (0.25, 24, 0.7))


def test_solve_batch_default_backend_matches_jax():
    """The slice as a whole: `solve_batch` with the default backend and two
    refine stages on the CPU, against the JAX `solve_batch` on the CPU (its
    jnp path), within the reference's fused-against-jnp budget on the
    scenarios converged on both."""
    jcfg, tcfg = _configs(3, iterations=8, refine_stages=STAGES, mu_sigma_max=0.7)
    assert tcfg.solver.solve_backend == "fused"
    jp = j_obstacle_problems(jcfg, 8, seed=3, dtype=jnp.float32)
    ref = solution_to_numpy_jax(j_make_batch_solver(jcfg)(jp))
    got = solution_to_numpy(solve_batch(tcfg, _port(jp), device="cpu"))
    both = got.diagnostics.converged & ref.diagnostics.converged
    assert both.sum() >= 6
    assert np.sum(got.diagnostics.converged != ref.diagnostics.converged) <= 1
    diff = np.abs(got.controls - ref.controls).max(axis=(1, 2))
    assert np.all(diff[both] <= 2e-3), diff
    assert np.isfinite(got.states).all()


def test_float64_takes_the_split_path():
    """float64 problems on the fused backend run the split path, as the
    reference sends f64 to its jnp path; the result matches JAX's f64
    `solve_batch` to the budget of tests/test_torch_api.py."""
    jcfg, tcfg = _configs(3, iterations=6, refine_stages=STAGES)
    jp = j_obstacle_problems(jcfg, 8, seed=4, dtype=jnp.float64)
    ref = solution_to_numpy_jax(j_make_batch_solver(jcfg)(jp))
    got = solution_to_numpy(solve_batch(tcfg, _port(jp), device="cpu"))
    assert got.controls.dtype == np.float64
    np.testing.assert_array_equal(got.diagnostics.converged, ref.diagnostics.converged)
    np.testing.assert_allclose(got.controls, ref.controls, atol=1e-6, rtol=0)


def test_plain_version_runs_in_float64():
    """The plain version is dtype-generic (the card check uses its f64 run
    as a measure of conditioning) and agrees with its f32 run."""
    jcfg, tcfg = _configs(2)
    tp = _port(_problems(jcfg, 2))
    f32 = solve_batch_fused_plain(tcfg, tp)
    f64 = solve_batch_fused_plain(tcfg, _port(_problems(jcfg, 2), dtype=torch.float64))
    assert f64.controls.dtype == torch.float64
    assert float((f32.controls.double() - f64.controls).abs().max()) <= 2e-3
    assert torch.equal(f32.diagnostics.converged, f64.diagnostics.converged)


def test_wrapper_refusals():
    jcfg, tcfg = _configs(2)
    tp = _port(_problems(jcfg, 2))
    with pytest.raises(TypeError):
        solve_batch_fused(tcfg, _port(_problems(jcfg, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        solve_batch_fused(tcfg, tp._replace(warm_states=tp.warm_states.transpose(0, 1)
                                            .contiguous().transpose(0, 1)))
    with pytest.raises(ValueError):
        solve_batch_fused(tcfg, tp._replace(obstacle_radii=tp.obstacle_radii[:, :1]))
    for mode in ("pc", "soc"):
        cfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver, mehrotra=mode))
        with pytest.raises(ValueError):
            solve_batch_fused(cfg, tp)


@pytest.mark.parametrize("trips", [0, 7, 31])
def test_probe_plain_version(trips):
    x = torch.tensor(np.random.default_rng(trips).normal(size=(8, 128)), dtype=torch.float32)
    iters = torch.tensor([trips], dtype=torch.int32)
    got = dynamic_trip(x, iters)
    expect = x.clone()
    for _ in range(trips):
        expect += 1.0
    assert torch.equal(got, expect)
    assert torch.equal(dynamic_trip_plain(x, iters), expect)
    with pytest.raises(ValueError):
        dynamic_trip(x[:4], iters)
    with pytest.raises(ValueError):
        dynamic_trip(x, iters.to(torch.int64))
