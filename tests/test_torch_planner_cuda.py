"""The batched grid planner on the card against the same code on the CPU.

Marked ``cuda``: it skips without an NVIDIA GPU.  It imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_planner_cuda.py

At B=64 fleet episodes (N=50, K=8 with 2 dynamic circles, 3 waypoints, a
96-cell grid, 3 route points per leg): leg reachability equal, route points
within 1e-4 m and clearances within 1e-5 m on at least 63 of the 64
episodes (the planner uses exact operations and the reference's float32
arithmetic, so the two devices agree unless a correctly rounded sqrt or
division differs), and the grid router's episode worlds equal.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu_torch.planner import bottleneck_clearance, plan_waypoint_chain
from kissmpc_tpu_torch.scenarios import episode_worlds

B = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _agree(a, b, tol):
    diff = np.abs(a - b).reshape(len(a), -1).max(axis=1)
    return int((diff <= tol).sum())


@pytest.mark.cuda
def test_planner_card_matches_cpu(cuda):
    cfg, params = chip_smoke.fleet_config()
    inputs = chip_smoke.planner_inputs(cfg, B, seed=4)
    kw = dict(points_per_leg=3, grid=96)
    out_g, reach_g = plan_waypoint_chain(*inputs, params.inflation_radius, device="cuda", **kw)
    out_c, reach_c = plan_waypoint_chain(*inputs, params.inflation_radius, device="cpu", **kw)
    np.testing.assert_array_equal(reach_g, reach_c)
    assert _agree(out_g[..., :2], out_c[..., :2], 1e-4) >= B - 1
    starts, wps, centers, radii, static = inputs
    w_g, w_c = (bottleneck_clearance(starts, wps[:, -1], centers, radii, static,
                                     params.inflation_radius, device=dev)
                for dev in ("cuda", "cpu"))
    assert _agree(w_g, w_c, 1e-5) >= B - 1


@pytest.mark.cuda
def test_grid_episode_worlds_card_matches_cpu(cuda):
    cfg, _ = chip_smoke.fleet_config()
    (env_g, obs_g, info_g), (env_c, obs_c, info_c) = (
        episode_worlds(cfg, B, n_waypoints=3, seed=2, n_dynamic=2, route_around_obstacles=True,
                       router="grid", planner_grid=96, return_info=True, device=dev)
        for dev in ("cuda", "cpu"))
    np.testing.assert_array_equal(info_g["leg_reachable"], info_c["leg_reachable"])
    assert _agree(env_g.waypoints.cpu().numpy(), env_c.waypoints.numpy(), 1e-4) >= B - 1
    for a, b in zip(obs_g, obs_c):
        assert torch.equal(a.cpu(), b)
