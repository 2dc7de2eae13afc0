"""The captured batched path (`kissmpc_tpu_torch/solver/graph.py`) on the
card: `make_batch_solver` with either backend, the fleet tick, the
data-parallel fleet on a one-rank NCCL group and the planner's grid fields,
every replay bitwise equal to the eager path it captured, and the refine
stages' counts moved alike by both.

Marked ``cuda``: it skips without an NVIDIA GPU (a CUDA graph has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_capture_batch_cuda.py
"""

import contextlib
import dataclasses
import datetime

import numpy as np
import pytest
import torch

from chip_smoke import bitwise_equal, fleet_tick
from kissmpc_tpu_torch import MPCConfig, environment, make_batch_solver
from kissmpc_tpu_torch._tree import leaves, unflatten
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.obstacles import advance
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
from kissmpc_tpu_torch.planner import bottleneck_clearance, plan_waypoint_chain
from kissmpc_tpu_torch.scenarios import episode_worlds, obstacle_problems
from kissmpc_tpu_torch.solver import graph
from kissmpc_tpu_torch.solver.api import refine_counts

STAGES = ((0.25, 8, 0.2), (0.125, 12, 0.7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")


@pytest.fixture
def nccl_rank(cuda):
    """A one-rank NCCL group (an in-process store, no port), and its mesh."""
    import torch.distributed as dist

    from kissmpc_tpu_torch.parallel import fleet

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield fleet.make_mesh()
    finally:
        dist.destroy_process_group()


def _same(x, y) -> bool:
    return all(bitwise_equal(a, b) for a, b in zip(leaves(x), leaves(y), strict=True))


def _cfg(backend):
    """k8_dyn2 at N=50 with fewer iterations: 8 + 8 + 12 over three solves."""
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, solve_backend=backend, iterations=8, refine_stages=STAGES,
        mu_sigma_max=0.7, fused_affine_tracks=True))


def _fleet(B=64):
    cfg = _cfg("fused")
    params = AgentParams(complete_warm_starts=False, prediction_dt=cfg.time_step,
                         stall_skip_ticks=50)
    env, obstacles = episode_worlds(cfg, B, n_waypoints=3, seed=1)
    return cfg, params, env, obstacles


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "split"])
def test_captured_make_batch_solver_is_bitwise_eager(cuda, backend):
    """The first call (the warm-up's result) and two replays equal the eager
    `solve_batch` bit for bit, on a batch whose stages gather; one graph
    for the three calls, and a second call on other inputs neither
    recaptures nor changes the first call's result."""
    cfg = _cfg(backend)
    p1, p2 = (obstacle_problems(cfg, 64, seed=s, n_dynamic=2) for s in (1, 2))
    solve = make_batch_solver(cfg)
    before = graph.captured()
    with graph.eager():
        ref = solve(p1)
    assert not bool(ref.diagnostics.converged.all())
    first = solve(p1)
    kept = [x.clone() for x in leaves(first)]
    for _ in range(2):
        assert _same(solve(p1), ref)
    assert _same(first, ref) and graph.captured() == before + 1
    second = make_batch_solver(cfg)(p2)
    assert graph.captured() == before + 1
    assert all(bitwise_equal(a, b) for a, b in zip(leaves(first), kept))
    with graph.eager():
        assert _same(second, solve(p2))


@pytest.mark.cuda
def test_launch_counters_move_by_the_captured_count(cuda):
    """Fused: one launch per solve, split: one Riccati launch per
    iteration, on the first call and on every replay."""
    for backend in ("fused", "split"):
        cfg = _cfg(backend)
        p = obstacle_problems(cfg, 64, seed=3, n_dynamic=2)
        solve = make_batch_solver(cfg)
        for _ in range(3):
            fused, riccati = solve_batch_fused.launches, solve_lqr_cuda.launches
            solve(p)
            moved = (solve_batch_fused.launches - fused, solve_lqr_cuda.launches - riccati)
            assert moved == ((3, 0) if backend == "fused" else (0, 8 + 8 + 12)), backend


@pytest.mark.cuda
def test_refine_counts_move_alike_on_replays(cuda):
    """The refine stages' counts on the device: the eager call, the first
    captured call and each replay add the same rows (re-solved, entered
    unconverged, rescued), the replays with no Python of their own."""
    cfg = _cfg("fused")
    p = obstacle_problems(cfg, 48, seed=5, n_dynamic=2)
    solve = make_batch_solver(cfg)
    moved = []
    for eager in (True, False, False, False):
        before = refine_counts()
        with graph.eager() if eager else contextlib.nullcontext():
            solve(p)
        after = refine_counts()
        before += [[0, 0, 0]] * (len(after) - len(before))
        moved.append([[a - b for a, b in zip(x, y)] for x, y in zip(after, before)])
    assert [row[0] for row in moved[0]] == [12, 6]
    assert all(row[1] <= row[0] and row[2] <= row[1] for row in moved[0])
    assert moved[1:] == [moved[0]] * 3


@pytest.mark.cuda
def test_fleet_ticks_match_eager_ticks_bitwise(cuda):
    """Four ticks of 64 episodes, captured and eager from the same state:
    equal states, obstacles and step infos, bit for bit; 3 fused launches
    per replayed tick."""
    cfg, params, env, obstacles = _fleet()
    captured = eager = (env, obstacles)
    for tick in range(4):
        before = solve_batch_fused.launches
        env_c, obs_c, info_c = fleet_tick(cfg, params, *captured, "cuda")
        assert solve_batch_fused.launches - before == 3
        with graph.eager():
            env_e, obs_e, info_e = fleet_tick(cfg, params, *eager, "cuda")
        assert _same((env_c, obs_c, info_c), (env_e, obs_e, info_e)), tick
        captured, eager = (env_c, obs_c), (env_e, obs_e)


@pytest.mark.cuda
def test_a_host_read_in_the_fleet_tick_raises_at_capture(cuda):
    """A tick that reads a value back to the host cannot be captured: the
    capture raises (after the warm-up), and nothing is cached; the tests
    after it capture again into the same pool."""
    cfg, params, env, obstacles = _fleet(B=16)
    like = (env, obstacles)

    def reads(*tensors):
        e, o = unflatten(like, tensors)
        new_env, info = environment.fleet_step(cfg, params, e, o)
        if bool(info.diagnostics.converged.any()):
            new_env = new_env._replace(stall_ticks=new_env.stall_ticks + 1)
        return new_env, advance(o, cfg.time_step), info

    count = graph.captured()
    with pytest.raises(RuntimeError):
        graph.run(("test.fleet_tick_reads", cfg, params), reads, "cuda", *leaves(like))
    assert graph.captured() == count
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_planner_fields_replay_bitwise(cuda):
    """`plan_waypoint_chain` and `bottleneck_clearance` at B=32, G=48: the
    first call and a replay equal the eager fields' routes and margins bit
    for bit, one graph per field."""
    rng = np.random.default_rng(0)
    B, K, W = 32, 6, 2
    starts = np.concatenate([rng.uniform(-1, 1, (B, 2)), np.zeros((B, 1))], 1)
    wps = np.concatenate([rng.uniform(2, 5, (B, W, 2)), np.zeros((B, W, 1))], 2)
    centers, radii = rng.uniform(0, 4, (B, K, 2)), rng.uniform(0.1, 0.4, (B, K))
    static = rng.random((B, K)) < 0.8
    plan = lambda: plan_waypoint_chain(starts, wps, centers, radii, static, 0.4,  # noqa: E731
                                       grid=48)
    clear = lambda: bottleneck_clearance(starts, wps[:, -1], centers, radii,  # noqa: E731
                                         static, 0.4, grid=48)
    with graph.eager():
        ref = (*plan(), clear())
    before = graph.captured()
    for _ in range(2):
        got = (*plan(), clear())
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert graph.captured() == before + 2


@pytest.mark.cuda
def test_data_parallel_replays_bitwise_and_count_collectives(nccl_rank):
    """The fleet solver and stepper on one NCCL rank: replays equal the
    eager calls bit for bit, and each replay moves the collectives counter
    by its 2 `all_reduce`s and the fused counter by its 3 launches."""
    from kissmpc_tpu_torch.parallel import fleet

    cfg, params, env, obstacles = _fleet()
    p = obstacle_problems(cfg, 64, seed=4, n_dynamic=2)
    solver = fleet.make_fleet_solver(cfg, nccl_rank)
    stepper = fleet.make_fleet_env_stepper(cfg, params, nccl_rank)
    for call, args in ((solver, (p,)), (stepper, (env, obstacles))):
        with graph.eager():
            ref = call(*args)
        for _ in range(3):
            before = (fleet.fleet_metrics.collectives, solve_batch_fused.launches)
            got = call(*args)
            assert (fleet.fleet_metrics.collectives - before[0],
                    solve_batch_fused.launches - before[1]) == (2, 3)
            assert _same(got, ref)
