"""Port parity of the batched grid planner and the world builders that use it.

`kissmpc_tpu_torch.planner` (plain PyTorch, here on the CPU) against
`kissmpc_tpu.planner` (JAX on the CPU), on inputs made from a numpy seed:
`plan_waypoint_chain` and `bottleneck_clearance` at B=16, G=32 and 48,
W=2-3, K=8 with some circles dynamic; the reference's four routing cases
run through the port; `episode_worlds(router="grid", return_info=True)`
and `lab_worlds` (on a synthetic PGM that both packages read from one
path, written by `chip_smoke.write_synthetic_map` at a small size)
against the JAX functions.

Tolerances: leg reachability exactly equal; route points within 1e-4 m
(one argmin decided otherwise would move a point by a grid cell, ~0.1 m;
the port follows the reference's float32 arithmetic, so the routes come out
equal); headings within 1e-4 rad away from the +-pi cut; clearances within
1e-5 m (a distance may differ by an ulp, and the max-min iteration only
selects values); world states and obstacles to float32 round-off (1e-6).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import planner as j_planner
from kissmpc_tpu.scenarios import episode_worlds as j_episode_worlds
from kissmpc_tpu.scenarios import lab_worlds as j_lab_worlds
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import planner as t_planner
from kissmpc_tpu_torch.scenarios import episode_worlds as t_episode_worlds
from kissmpc_tpu_torch.scenarios import lab_worlds as t_lab_worlds

INFL = 0.4
CPU = "cpu"
POINT_TOL = 1e-4
CLEAR_TOL = 1e-5
LAB_PGM_PX = (160, 240)  # a small synthetic map (rows, columns) for the CPU


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run beside others in parallel
    workers, where many threads per worker only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _world(B, W, K, seed):
    """Start poses, waypoint chains and K circles (a quarter of them
    dynamic, which the planner ignores), every endpoint cleared."""
    rng = np.random.default_rng(seed)
    starts = np.concatenate([rng.uniform(-1, 1, (B, 2)), np.zeros((B, 1))], axis=1)
    wps = np.cumsum(np.concatenate([rng.uniform(0.5, 1.5, (B, W, 2)),
                                    rng.uniform(-3, 3, (B, W, 1))], axis=2), axis=1)
    wps[..., :2] += starts[:, None, :2]
    centers = rng.uniform(-1, 4, (B, K, 2))
    radii = rng.uniform(0.1, 0.4, (B, K))
    for p in [starts[:, :2]] + [wps[:, w, :2] for w in range(W)]:
        for _ in range(4):
            d = centers - p[:, None, :]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            push = np.maximum(radii + INFL + 0.15 - dist, 0.0)
            centers += d / dist[..., None] * push[..., None]
    static = rng.random((B, K)) > 0.25
    return (starts.astype(np.float32), wps.astype(np.float32), centers.astype(np.float32),
            radii.astype(np.float32), static)


def _assert_chain_close(got, ref):
    out_t, reach_t = got
    out_j, reach_j = ref
    assert out_t.shape == out_j.shape
    np.testing.assert_array_equal(reach_t, np.asarray(reach_j))
    np.testing.assert_allclose(out_t[..., :2], out_j[..., :2], rtol=0, atol=POINT_TOL)
    dth = np.angle(np.exp(1j * (out_t[..., 2].astype(np.float64) - out_j[..., 2])))
    assert np.abs(dth).max() <= POINT_TOL


@pytest.mark.parametrize("G", [32, 48])
@pytest.mark.parametrize("W", [2, 3])
def test_plan_waypoint_chain_matches_jax(G, W):
    a = _world(16, W, 8, seed=10 * G + W)
    ref = j_planner.plan_waypoint_chain(*a, INFL, points_per_leg=3, grid=G)
    got = t_planner.plan_waypoint_chain(*a, INFL, points_per_leg=3, grid=G, device=CPU)
    _assert_chain_close(got, ref)


@pytest.mark.parametrize("G", [32, 48])
def test_bottleneck_clearance_matches_jax(G):
    starts, wps, centers, radii, static = _world(16, 2, 8, seed=G)
    ref = j_planner.bottleneck_clearance(starts, wps[:, -1], centers, radii, static, INFL,
                                         grid=G)
    got = t_planner.bottleneck_clearance(starts, wps[:, -1], centers, radii, static, INFL,
                                         grid=G, device=CPU)
    assert got.shape == (16,)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=CLEAR_TOL)


# The reference's four routing cases (tests/test_planner.py), through the port.

def _chain(starts, wps, centers, radii, **kw):
    B, K = np.asarray(starts).shape[0], np.asarray(centers).shape[1]
    return t_planner.plan_waypoint_chain(
        np.asarray(starts, np.float32), np.asarray(wps, np.float32),
        np.asarray(centers, np.float32), np.asarray(radii, np.float32),
        np.ones((B, K), bool), INFL, device=CPU, **kw)


def test_routes_around_wall_with_gap():
    start = np.array([[0.0, 0.0, 0.0]])
    wps = np.array([[[4.0, 0.0, 0.0]]])
    centers = np.array([[[2.0, -0.9], [2.0, 0.0], [2.0, 0.9]]])
    radii = np.full((1, 3), 0.35)
    out, reach = _chain(start, wps, centers, radii, points_per_leg=4)
    assert bool(reach.all())
    assert out.shape == (1, 5, 3)
    d = np.linalg.norm(out[0, :, None, :2] - centers[0][None], axis=-1) - (radii[0][None] + INFL)
    assert d.min() > 0.0
    np.testing.assert_allclose(out[0, -1], wps[0, 0], atol=1e-6)
    assert np.abs(out[0, :4, 1]).max() > 0.9


def test_unreachable_target_flagged():
    start = np.array([[0.0, 0.0, 0.0]])
    wps = np.array([[[3.0, 0.0, 0.0]]])
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    centers = np.stack([3.0 + 0.9 * np.cos(ang), 0.9 * np.sin(ang)], axis=-1)[None]
    radii = np.full((1, 8), 0.3)
    out, reach = _chain(start, wps, centers, radii)
    assert not bool(reach[0, 0])
    assert np.isfinite(out).all()
    assert np.abs(out[0, :3, 1]).max() < 1e-5


def test_multi_leg_chain_and_headings():
    rng = np.random.default_rng(3)
    B, W, K, P = 16, 3, 6, 3
    starts = np.concatenate([rng.uniform(-1, 1, (B, 2)), np.zeros((B, 1))], axis=1)
    wps = np.cumsum(np.concatenate([rng.uniform(0.5, 1.5, (B, W, 2)),
                                    rng.uniform(-3, 3, (B, W, 1))], axis=2), axis=1)
    wps[..., :2] += starts[:, None, :2]
    centers = rng.uniform(-1, 4, (B, K, 2))
    radii = rng.uniform(0.1, 0.3, (B, K))
    for p in [starts[:, :2]] + [wps[:, w, :2] for w in range(W)]:
        for _ in range(4):
            d = centers - p[:, None, :]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            push = np.maximum(radii + INFL + 0.15 - dist, 0.0)
            centers += d / dist[..., None] * push[..., None]
    out, reach = _chain(starts, wps, centers, radii, points_per_leg=P)
    assert out.shape == (B, W * (P + 1), 3)
    for w in range(W):
        np.testing.assert_allclose(out[:, w * (P + 1) + P], wps[:, w], atol=1e-6)
    clear = np.linalg.norm(out[:, :, None, :2] - centers[:, None], axis=-1) - (
        radii[:, None, :] + INFL)
    leg_ok = np.repeat(reach, P + 1, axis=1)
    route_rows = np.tile(np.arange(W * (P + 1)) % (P + 1) != P, (B, 1))
    assert not ((clear.min(axis=2) < -1e-3) & leg_ok & route_rows).any()
    d = out[:, 1, :2] - out[:, 0, :2]
    nz = np.linalg.norm(d, axis=1) > 1e-6
    np.testing.assert_allclose(out[nz, 0, 2], np.arctan2(d[nz, 1], d[nz, 0]), atol=1e-5)


def test_bottleneck_clearance_signs():
    starts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    goals = np.array([[3.0, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    ring = np.stack([3.0 + 0.9 * np.cos(ang), 0.9 * np.sin(ang)], axis=-1)
    far = np.tile(np.array([[20.0, 20.0]], np.float32), (8, 1))
    centers = np.stack([far, ring]).astype(np.float32)
    radii = np.full((2, 8), 0.3, np.float32)
    w = t_planner.bottleneck_clearance(starts, goals, centers, radii, np.ones((2, 8), bool),
                                       INFL, device=CPU)
    assert w[0] > 0.5, w
    assert w[1] < 0.05, w


def _assert_worlds_close(t_env, t_obs, j_env, j_obs):
    np.testing.assert_allclose(t_env.waypoints.numpy(), np.asarray(j_env.waypoints),
                               rtol=0, atol=POINT_TOL)
    np.testing.assert_allclose(t_env.agent.states_matrix.numpy(),
                               np.asarray(j_env.agent.states_matrix), rtol=0, atol=1e-6)
    for name in t_obs._fields:
        np.testing.assert_allclose(getattr(t_obs, name).numpy(), np.asarray(getattr(j_obs, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_episode_worlds_grid_matches_jax():
    kw = dict(horizon=15, time_step=0.1, max_obstacles=4)
    wkw = dict(n_waypoints=3, seed=3, n_dynamic=1, route_around_obstacles=True, router="grid",
               points_per_leg=3, planner_grid=32, return_info=True)
    je, jo, jinfo = j_episode_worlds(JConfig(**kw), 16, **wkw)
    te, to, tinfo = t_episode_worlds(TConfig(**kw), 16, device=CPU, **wkw)
    assert te.waypoints.shape == (16, 12, 3)
    reach = tinfo["leg_reachable"]
    assert reach.shape == (16, 3) and reach.dtype == bool
    np.testing.assert_array_equal(reach, np.asarray(jinfo["leg_reachable"]))
    _assert_worlds_close(te, to, je, jo)


def test_episode_worlds_return_info_shapes():
    """Two elements by default; all legs reachable off the grid router and
    at K = 0, with the reference's shapes."""
    cfg = TConfig(horizon=15, time_step=0.1, max_obstacles=4)
    out = t_episode_worlds(cfg, 4, n_waypoints=2, seed=0, route_around_obstacles=True,
                           router="grid", planner_grid=32, device=CPU)
    assert len(out) == 2
    _, _, info = t_episode_worlds(cfg, 4, n_waypoints=2, seed=0, route_around_obstacles=True,
                                  router="detour", return_info=True, device=CPU)
    assert info["leg_reachable"].shape == (4, 4) and info["leg_reachable"].all()
    _, _, info0 = t_episode_worlds(TConfig(horizon=15, time_step=0.1, max_obstacles=0), 4,
                                   n_waypoints=3, seed=0, return_info=True, device=CPU)
    assert info0["leg_reachable"].shape == (4, 3) and info0["leg_reachable"].dtype == bool
    assert info0["leg_reachable"].all()


@pytest.mark.parametrize("n_dynamic", [0, 2])
def test_lab_worlds_matches_jax(tmp_path, n_dynamic):
    path = tmp_path / "lab.pgm"
    chip_smoke.write_synthetic_map(path, shape=LAB_PGM_PX)
    kw = dict(horizon=12, time_step=0.1, max_obstacles=4)
    wkw = dict(map_path=str(path), seed=1, circles_per_episode=8, max_circles=60,
               planner_grid=32, n_dynamic=n_dynamic)
    je, jo, jinfo = j_lab_worlds(JConfig(**kw), 8, **wkw)
    te, to, tinfo = t_lab_worlds(TConfig(**kw), 8, device=CPU, **wkw)
    assert to.position.shape == (8, 8 + n_dynamic, 2)
    assert tinfo["n_circles"] == jinfo["n_circles"]
    np.testing.assert_allclose(tinfo["extent"], jinfo["extent"])
    np.testing.assert_array_equal(tinfo["leg_reachable"], np.asarray(jinfo["leg_reachable"]))
    _assert_worlds_close(te, to, je, jo)


def test_lab_worlds_needs_a_map_path():
    with pytest.raises(TypeError):
        t_lab_worlds(TConfig(horizon=12, time_step=0.1, max_obstacles=4), 2, device=CPU)
