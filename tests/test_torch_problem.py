"""Port parity: scenario sampling, obstacles, problem builders and the bridge.

Numpy sampling must be bit-identical to the JAX package's for one seed;
every `Problem` leaf the port builds must match the JAX builders' (float64,
1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissmpc_tpu.scenarios as jscen
import kissmpc_tpu_torch.scenarios as tscen
from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.obstacles import obstacles as jobs
from kissmpc_tpu.solver import problem as jprob
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.obstacles import obstacles as tobs
from kissmpc_tpu_torch.solver import problem as tprob
from kissmpc_tpu_torch.solver.problem import Diagnostics, Solution

TOL = 1e-9
N, DT = 12, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_problem_close(tp, jp, tol=TOL):
    for name in jp._fields:
        j = np.asarray(getattr(jp, name))
        t = getattr(tp, name).cpu().numpy()
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=name)


def test_sampling_bit_identical():
    cfg = JConfig(horizon=N, time_step=DT)
    for mod in (jscen, tscen):
        rng = np.random.default_rng(7)
        s, g = mod.sample_endpoints(cfg, 16, rng)
        field = mod.sample_obstacle_field(s, g, 4, rng, n_dynamic=2)
        if mod is jscen:
            ref = (s, g) + tuple(field)
        else:
            got = (s, g) + tuple(field)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _obstacle_world(B, Ko, seed):
    rng = np.random.default_rng(seed)
    return dict(
        position=rng.uniform(-1.0, 2.0, (B, Ko, 2)),
        radius=rng.uniform(0.1, 0.3, (B, Ko)),
        orientation=rng.uniform(-np.pi, np.pi, (B, Ko)),
        linear_velocity=rng.uniform(0.0, 0.8, (B, Ko)) * (np.arange(Ko) < 2),
        angular_velocity=rng.uniform(-0.3, 0.3, (B, Ko)),
        active=(rng.uniform(size=(B, Ko)) < 0.85).astype(np.float64),
    )


def test_obstacle_functions_match():
    world = _obstacle_world(6, 5, 0)
    point = np.random.default_rng(1).uniform(-1.0, 2.0, (6, 3))
    jo = jobs.ObstacleSet(**{k: jnp.asarray(v) for k, v in world.items()})
    to = tobs.ObstacleSet(**{k: torch.tensor(v) for k, v in world.items()})
    tp, jpt = torch.tensor(point), jnp.asarray(point)
    np.testing.assert_allclose(
        tobs.distance_to_point(to, tp).numpy(),
        np.asarray(jax.vmap(jobs.distance_to_point)(jo, jpt)), atol=TOL,
    )
    np.testing.assert_allclose(
        tobs.clearance_to_point(to, tp, 0.3).numpy(),
        np.asarray(jax.vmap(lambda o, p: jobs.clearance_to_point(o, p, 0.3))(jo, jpt)),
        atol=TOL,
    )
    np.testing.assert_allclose(
        tobs.predict_tracks(to, N, DT).numpy(),
        np.asarray(jax.vmap(lambda o: jobs.predict_tracks(o, N, DT))(jo)), atol=TOL,
    )
    tsel = tobs.select_nearest(to, tp, 1.5, 3)
    jsel = jax.vmap(lambda o, p: jobs.select_nearest(o, p, 1.5, 3))(jo, jpt)
    for name in jsel._fields:
        np.testing.assert_allclose(
            getattr(tsel, name).numpy(), np.asarray(getattr(jsel, name)),
            atol=TOL, err_msg=name,
        )


def test_static_and_dynamic_sets_match():
    ts = tobs.static_set([[0.5, 0.1], [1.0, 1.0]], [0.2, 0.3], max_obstacles=4,
                         dtype=torch.float64, device="cpu")
    js = jobs.static_set([[0.5, 0.1], [1.0, 1.0]], [0.2, 0.3], max_obstacles=4,
                         dtype=jnp.float64)
    td = tobs.dynamic_set([[0.5, 0.1]], 0.3, 0.8, max_obstacles=3,
                          dtype=torch.float64, device="cpu")
    jd = jobs.dynamic_set([[0.5, 0.1]], 0.3, 0.8, max_obstacles=3, dtype=jnp.float64)
    for t, j in ((ts, js), (td, jd)):
        for name in j._fields:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


def _endpoints(B, seed):
    rng = np.random.default_rng(seed)
    starts = np.concatenate([rng.uniform(-0.3, 0.3, (B, 2)),
                             rng.uniform(-0.5, 0.5, (B, 1))], axis=1)
    goals = np.concatenate([rng.uniform(1.0, 2.0, (B, 2)),
                            rng.uniform(-0.5, 0.5, (B, 1))], axis=1)
    return starts, goals


def test_default_problem_matches():
    cfg_kw = dict(horizon=N, time_step=DT, max_obstacles=2, bound_y=False)
    starts, goals = _endpoints(4, 3)
    rng = np.random.default_rng(4)
    centers = rng.uniform(0, 1, (4, 2, 2))
    warm = rng.normal(size=(4, N + 1, 3))
    kw = dict(obstacle_radii=np.full((4, 2), 0.2), inflation_radius=0.3)
    jp = jax.vmap(
        lambda s, g, c, w: jprob.default_problem(
            JConfig(**cfg_kw), s, g, obstacle_centers=c, warm_states=w,
            dtype=jnp.float64, obstacle_radii=jnp.full((2,), 0.2),
            inflation_radius=0.3,
        )
    )(jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(centers), jnp.asarray(warm))
    tp = tprob.default_problem(
        TConfig(**cfg_kw), starts, goals, obstacle_centers=centers,
        warm_states=warm, dtype=torch.float64, device="cpu", **kw,
    )
    _assert_problem_close(tp, jp)


@pytest.mark.parametrize("K", [2, 3, 4])
@pytest.mark.parametrize("mode", ["repair_complete", "repair_only", "complete_only"])
def test_problem_with_obstacles_matches(K, mode):
    """Sensor top-K, dynamic tracks, warm-start repair and completion (the
    warm start is tiled from the start, so completion runs wherever the
    repair moved it)."""
    B = 6
    starts, goals = _endpoints(B, K)
    world = _obstacle_world(B, K + 1, K)
    world["position"] = world["position"] * 0.5 + 0.4
    flags = dict(
        repair_warm_start_states=mode != "complete_only",
        complete_warm_start_states=mode != "repair_only",
    )
    jo = jobs.ObstacleSet(**{k: jnp.asarray(v) for k, v in world.items()})
    to = tobs.ObstacleSet(**{k: torch.tensor(v) for k, v in world.items()})
    jp = jax.vmap(
        lambda s, g, o: jprob.problem_with_obstacles(
            JConfig(horizon=N, time_step=DT, max_obstacles=K), s, g, o,
            prediction_dt=DT, inflation_radius=0.3, dtype=jnp.float64, **flags,
        )
    )(jnp.asarray(starts), jnp.asarray(goals), jo)
    tp = tprob.problem_with_obstacles(
        TConfig(horizon=N, time_step=DT, max_obstacles=K), starts, goals, to,
        prediction_dt=DT, inflation_radius=0.3, dtype=torch.float64,
        device="cpu", **flags,
    )
    _assert_problem_close(tp, jp)


def test_repair_and_complete_warm_start_match():
    """Both builders called directly on a warm start that cuts through the
    obstacles (a straight line to the goal)."""
    B, K = 5, 3
    starts, goals = _endpoints(B, 9)
    frac = np.linspace(0.0, 1.0, N + 1)[None, :, None]
    warm = starts[:, None, :] + frac * (goals - starts)[:, None, :]
    rng = np.random.default_rng(10)
    mid = 0.5 * (starts[:, :2] + goals[:, :2])
    centers = np.repeat(
        (mid[:, None, :] + rng.normal(scale=0.15, size=(B, K, 2)))[:, :, None, :],
        N, axis=2,
    )
    radii = rng.uniform(0.1, 0.25, (B, K))
    mask = np.ones((B, K))
    infl = np.full((B,), 0.3)
    lo = np.tile([-0.2, -0.5], (B, 1))
    hi = np.tile([0.5, 0.5], (B, 1))
    J = lambda *xs: tuple(jnp.asarray(x) for x in xs)
    T = lambda *xs: tuple(torch.tensor(x) for x in xs)
    j_rep = jax.vmap(jprob.repair_warm_start)(*J(warm, centers, radii, mask, infl))
    t_rep = tprob.repair_warm_start(*T(warm, centers, radii, mask, infl))
    np.testing.assert_allclose(t_rep.numpy(), np.asarray(j_rep), atol=TOL)
    j_cs, j_cu = jax.vmap(
        lambda w, x0, a, b, c, r, m, i: jprob.complete_warm_start(w, x0, a, b, c, r, m, i, DT)
    )(*J(np.asarray(j_rep), starts, lo, hi, centers, radii, mask, infl))
    t_cs, t_cu = tprob.complete_warm_start(
        *T(t_rep.numpy(), starts, lo, hi, centers, radii, mask, infl), DT
    )
    np.testing.assert_allclose(t_cs.numpy(), np.asarray(j_cs), atol=TOL)
    np.testing.assert_allclose(t_cu.numpy(), np.asarray(j_cu), atol=TOL)


@pytest.mark.parametrize("K", [0, 4])
def test_scenario_pools_match(K):
    cfg_kw = dict(horizon=N, time_step=DT, max_obstacles=K)
    if K:
        jp = jscen.obstacle_problems(JConfig(**cfg_kw), 8, seed=5, dtype=jnp.float64)
        tp = tscen.obstacle_problems(TConfig(**cfg_kw), 8, seed=5,
                                     dtype=torch.float64, device="cpu")
    else:
        jp = jscen.free_problems(JConfig(**cfg_kw), 8, seed=5, dtype=jnp.float64)
        tp = tscen.free_problems(TConfig(**cfg_kw), 8, seed=5,
                                 dtype=torch.float64, device="cpu")
    _assert_problem_close(tp, jp)


def test_bridge_round_trip():
    jp = jscen.obstacle_problems(
        JConfig(horizon=N, time_step=DT, max_obstacles=2), 3, seed=1
    )
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    tp = problem_from_numpy(arrays, device="cpu")
    for name, arr in arrays.items():
        got = getattr(tp, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), arr)
    tp64 = problem_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert tp64.warm_states.dtype == torch.float64
    with pytest.raises(KeyError):
        problem_from_numpy({"initial_state": arrays["initial_state"]}, device="cpu")

    sol = Solution(
        states=tp.warm_states,
        controls=tp.warm_controls,
        diagnostics=Diagnostics(*(torch.arange(3) for _ in Diagnostics._fields)),
    )
    out = solution_to_numpy(sol)
    assert isinstance(out.states, np.ndarray)
    np.testing.assert_array_equal(out.controls, arrays["warm_controls"])
    np.testing.assert_array_equal(out.diagnostics.final_mu, np.arange(3))
