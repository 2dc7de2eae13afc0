"""The last two `jax.jit` sites of the reference captured on the card: the
perception tick (`chip_smoke.py::perception_tick`, both variants) and the
pool builder (`scenarios.obstacle_problems`), every replay bitwise equal to
the eager path; and configs given lists sharing their tuple twins' graphs.

Marked ``cuda``: it skips without an NVIDIA GPU (a CUDA graph has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_capture_perception_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import FRAMES_DT, bitwise_equal, fleet_tick, perception_tick
from kissmpc_tpu_torch import MPCConfig, agent, make_batch_solver, make_solver
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.bridge import geometry_from_numpy
from kissmpc_tpu_torch.io.frames import FrameReplayer, record_synthetic_walk
from kissmpc_tpu_torch.obstacles import dynamic_set
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused
from kissmpc_tpu_torch.perception import pipeline, tracker
from kissmpc_tpu_torch.scenarios import episode_worlds, obstacle_problems
from kissmpc_tpu_torch.solver import graph

STAGES = ((0.25, 8, 0.2), (0.125, 12, 0.7))
BOUNDS = ((-0.2, 0.5), (-0.5, 0.5))
B, CAP = 64, 4
FRAMES = (0, 4, 1, 6, 2, 5)  # the first call captures at frame 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")


def _same(x, y) -> bool:
    return all(bitwise_equal(a, b) for a, b in zip(leaves(x), leaves(y), strict=True))


def _cfg(stages=STAGES):
    """The perception bench's configuration (N=50, K=8) with fewer
    iterations: 8 + 8 + 12 over three solves."""
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=8, refine_stages=stages, mu_sigma_max=0.7))


def _params(bounds=BOUNDS):
    return AgentParams(prediction_dt=0.041, complete_warm_starts=False, stall_skip_ticks=50,
                       control_bounds=bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["solver_only", "with_perception"])
def test_perception_replays_match_eager_at_distinct_frames(cuda, tmp_path, variant):
    """Six ticks at six distinct frames, captured and eager from the same
    state: env, perception state, step info and tracked set equal bit for
    bit (a frame index baked into the graph would re-perceive frame 0), and
    3 fused launches per tick."""
    path = str(tmp_path / "walk.npz")
    record_synthetic_walk(path, n_frames=8, dt=FRAMES_DT)
    frames = list(FrameReplayer(path).synced())
    stack = tuple(torch.as_tensor(np.stack([getattr(f, n) for f in frames]), device="cuda")
                  for n in ("points", "point_mask", "instance_masks", "instance_valid"))
    geom = geometry_from_numpy(frames[0].geometry, device="cuda")
    cfg, params = _cfg(), _params()
    env, static = episode_worlds(cfg, B, n_waypoints=2, seed=0, n_dynamic=0,
                                 route_around_obstacles=True)
    offsets = env.agent.states_matrix[:, 0, :2] + torch.tensor([1.2, 0.0], device="cuda")
    pstate = pipeline.init_perception(CAP, batch=B)

    def tick(state, f):
        frame = torch.full((1,), f, dtype=torch.int64, device="cuda")
        return perception_tick(variant, cfg, params, tracker.TrackerConfig(), geom, stack,
                               offsets, static, *state, frame, "cuda")

    captured = eager = (env, pstate)
    for f in FRAMES:
        before = solve_batch_fused.launches
        out = tick(captured, f)
        assert solve_batch_fused.launches - before == 3
        with graph.eager():
            ref = tick(eager, f)
        assert _same(out, ref), f
        captured, eager = out[:2], ref[:2]


def _pool(cfg, seed, B=64):
    return obstacle_problems(cfg, B, seed=seed, n_dynamic=2)


def _agent_step(cfg, params):
    a = agent.init_agent(cfg, [[0.0, 0.0, 0.0], [0.3, 0.1, 0.2]], [2.0, 0.0, 0.0])
    walkers = dynamic_set([[1.0, 0.3], [2.5, -0.4]], [2.8, 1.6], [0.3, 0.2], radius=0.3,
                          max_obstacles=cfg.max_obstacles)
    return agent.step(cfg, params, a, walkers)


def _fleet_tick(cfg, params):
    env, obstacles = episode_worlds(cfg, B, n_waypoints=2, seed=1, n_dynamic=2)
    return fleet_tick(cfg, params, env, obstacles, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["make_batch_solver", "make_solver", "agent.step",
                                   "fleet_tick"])
def test_list_and_tuple_configs_share_one_graph(cuda, entry):
    """A config with a list-valued `refine_stages` and `AgentParams` with
    list-valued `control_bounds` run on the card (their keys are hashed
    frozen), and their tuple-valued twins replay the same graph, bit for
    bit."""
    listed = (_cfg([list(s) for s in STAGES]), _params([list(b) for b in BOUNDS]))
    tupled = (_cfg(), _params())
    problems = _pool(tupled[0], 3)
    run = {"make_batch_solver": lambda c, p: make_batch_solver(c)(problems),
           "make_solver": lambda c, p: make_solver(c)(problems),
           "agent.step": _agent_step,
           "fleet_tick": _fleet_tick}[entry]
    first = run(*listed)
    count = graph.captured()
    assert _same(run(*tupled), first)
    assert graph.captured() == count


@pytest.mark.cuda
def test_pool_builder_replay_is_bitwise_eager(cuda):
    """A second pool of the same shape replays the builder's graph: equal to
    the eager build bit for bit, and not the first pool."""
    cfg = _cfg()
    first = _pool(cfg, 1, B=256)
    count = graph.captured()
    second = _pool(cfg, 2, B=256)
    assert graph.captured() == count
    with graph.eager():
        ref = _pool(cfg, 2, B=256)
    assert _same(second, ref)
    assert not bitwise_equal(first.initial_state, second.initial_state)
