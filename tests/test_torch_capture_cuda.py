"""The captured single-robot path (`kissmpc_tpu_torch/solver/graph.py`) on
the card: every replay bitwise equal to the eager path it captured.

Marked ``cuda``: it skips without an NVIDIA GPU (a CUDA graph has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_capture_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import bitwise_equal
from kissmpc_tpu_torch import MPCConfig, make_solver
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.io import Model
from kissmpc_tpu_torch.obstacles import dynamic_set
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
from kissmpc_tpu_torch.scenarios import obstacle_problems
from kissmpc_tpu_torch.solver import graph, ipm
from kissmpc_tpu_torch.solver.problem import default_problem


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")


def _same(x, y) -> bool:
    return all(bitwise_equal(a, b) for a, b in zip(leaves(x), leaves(y), strict=True))


def _node_cfg_problem(seed):
    rng = np.random.default_rng(seed)
    cfg = MPCConfig(horizon=7, time_step=0.8)
    start = rng.normal(size=(1, 3)) * 0.2
    return cfg, default_problem(cfg, start, [[1.5, 0.4, 0.0]])


def _k8_cfg_problem(seed):
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    return cfg, obstacle_problems(cfg, 64, seed=seed, n_dynamic=2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B=1 N=7", "B=64 N=50 K=8"])
def test_captured_make_solver_is_bitwise_eager(cuda, case):
    """The first call (the warm-up's result) and two replays equal the eager
    `ipm.solve` bit for bit; one graph for the three calls."""
    make = _node_cfg_problem if case == "B=1 N=7" else _k8_cfg_problem
    cfg, problem = make(0)
    solve = make_solver(cfg)
    before = graph.captured()
    ref = ipm.solve(cfg, problem)
    for _ in range(3):
        assert _same(solve(problem), ref)
    assert graph.captured() == before + 1


@pytest.mark.cuda
def test_second_call_neither_recaptures_nor_aliases(cuda):
    """A second call on other inputs replays the same graph (from a new
    `make_solver` too, as `agent.step` makes one every tick), and the first
    call's result, kept by the caller, is left as it was."""
    cfg, p1 = _k8_cfg_problem(1)
    _, p2 = _k8_cfg_problem(2)
    first = make_solver(cfg)(p1)
    kept = [x.clone() for x in leaves(first)]
    count = graph.captured()
    second = make_solver(cfg)(p2)
    assert graph.captured() == count
    assert all(bitwise_equal(a, b) for a, b in zip(leaves(first), kept))
    assert _same(second, ipm.solve(cfg, p2))
    assert not _same(first, second)


@pytest.mark.cuda
def test_model_ticks_match_eager_ticks_bitwise(cuda):
    """Ten node ticks (N=7, 40 iterations, 4 obstacle slots, two walkers),
    captured and eager on the card from the same odometry: equal plans and
    commands, bit for bit."""
    walkers = dynamic_set([[1.0, 0.3], [2.5, -0.4]], [2.8, 1.6], [0.3, 0.2], radius=0.3,
                          max_obstacles=4)
    plan = [[1.5, 0.4, 0.0], [3.0, 0.0, 0.0]]
    captured, eager = (Model(max_obstacles=4, waypoints=plan) for _ in range(2))
    for model in (captured, eager):
        model.set_obstacles(walkers)
    for tick in range(10):
        captured.step()
        with graph.eager():
            eager.step()
        assert np.array_equal(captured.states_matrix, eager.states_matrix), tick
        assert (captured.linear_velocity, captured.angular_velocity) == (
            eager.linear_velocity, eager.angular_velocity), tick


@pytest.mark.cuda
def test_launch_counters_move_by_the_captured_count(cuda):
    """The Riccati counter moves by the iterations on the first call (the
    warm-up; the capture itself counts nothing) and on every replay."""
    cfg, problem = _node_cfg_problem(3)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, iterations=9))
    solve = make_solver(cfg)
    for _ in range(3):
        before = solve_lqr_cuda.launches
        solve(problem)
        assert solve_lqr_cuda.launches - before == 9


@pytest.mark.cuda
def test_a_host_read_in_the_region_raises_at_capture(cuda):
    """A function that reads a value back to the host cannot be captured:
    the capture raises (the warm-up before it runs), and nothing is cached."""
    count = graph.captured()
    x = torch.ones(3, device="cuda")
    with pytest.raises(RuntimeError):
        graph.run(("test.item",), lambda t: t * t.sum().item(), "cuda", x)
    assert graph.captured() == count
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 6.0  # the card works on after the failed capture
