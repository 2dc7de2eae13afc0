"""The last two `jax.jit` sites of the reference as `graph.run` programs,
and graph keys, on the CPU at a small size (N=12, B <= 16, the port's
48x64, P=128 synthetic walk).

- Graph keys: `graph.run` freezes its key (lists and tuples become tuples,
  inside the configs' dataclasses too) and hashes it on every path, so a
  config with a list-valued `refine_stages` or an `AgentParams` with
  list-valued `control_bounds` runs through `make_batch_solver`,
  `make_solver`, `agent.step` and the fleet tick on the CPU as on the card, bit
  for bit as its tuple-valued twin, and a key unhashable after freezing
  raises on the CPU too.
- The perception tick (`chip_smoke.py::perception_tick`, both variants)
  and the pool builder (`scenarios.obstacle_problems`) issue none of the
  host round-trips a CUDA graph cannot capture (`_SyncOps`, as in
  tests/test_torch_capture.py), and through `graph.run` each is bit for
  bit the eager composition it stands for.
- Parity with the JAX package: the perception tick against a jitted JAX
  tick composed as scripts/bench_perception_tick.py:88-104 composes it,
  over 3 ticks (track tables and tracked obstacles bitwise equal, as
  tests/test_torch_perception.py's pipeline parity allows; the solve split
  in float64: controls within 1e-6, tests/test_torch_capture_batch.py's
  budget, and converged flags equal); the pool builder against the JAX
  `obstacle_problems` within 1e-9 (tests/test_torch_problem.py's).

The card's side (replays bitwise equal to eager at distinct frames) is
tests/test_torch_capture_perception_cuda.py.
"""

import ast
import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import environment as j_env
from kissmpc_tpu.agent import AgentParams as JParams
from kissmpc_tpu.io.frames import FrameReplayer as JReplayer
from kissmpc_tpu.perception import pipeline as jp
from kissmpc_tpu.perception import tracker as jt
from kissmpc_tpu.scenarios import episode_worlds as j_episode_worlds
from kissmpc_tpu.scenarios import obstacle_problems as j_obstacle_problems
from kissmpc_tpu_torch import MPCConfig, agent, environment, make_batch_solver, make_solver
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.bridge import env_from_numpy, geometry_from_numpy, obstacles_from_numpy
from kissmpc_tpu_torch.io.frames import FrameReplayer, record_synthetic_walk
from kissmpc_tpu_torch.obstacles import ObstacleSet, dynamic_set
from kissmpc_tpu_torch.perception import pipeline, tracker
from kissmpc_tpu_torch.scenarios import episode_worlds, obstacle_problems
from kissmpc_tpu_torch.solver import graph
from chip_smoke import FRAMES_DT, fleet_tick, perception_tick
from tests.test_torch_capture import _same
from tests.test_torch_capture_batch import (_never_synced, card_launch,  # noqa: F401
                                            regions)
from tests.test_torch_problem import _assert_problem_close

CPU = "cpu"
B, CAP, K = 6, 4, 4  # episodes, tracker slots, static circles (the solver's K)
STAGES = ((0.5, 8, 0.2),)
TOL = 1e-6  # controls, split in float64 (tests/test_torch_capture_batch.py)
VARIANTS = ("solver_only", "with_perception")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small operations, beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(backend="split", stages=STAGES, **solver):
    cfg = MPCConfig(horizon=12, time_step=0.041, max_obstacles=K)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, solve_backend=backend, iterations=6, refine_stages=stages,
        mu_sigma_max=0.7, **solver))


def _params(**kw):
    return AgentParams(prediction_dt=0.041, complete_warm_starts=False, stall_skip_ticks=50,
                       **kw)


def _listed(stages):
    return [list(stage) for stage in stages]


# --- graph keys ---------------------------------------------------------------


def test_list_and_tuple_keys_freeze_and_hash_equal():
    """A key with a list-valued `refine_stages` or `control_bounds`, and
    its tuple-valued twin, freeze equal and hash equal."""
    bounds = ((-0.2, 0.5), (-0.5, 0.5))
    pairs = [(("make_batch_solver", _cfg(stages=_listed(STAGES))),
              ("make_batch_solver", _cfg())),
             (("agent.step", _cfg(), _params(control_bounds=[list(b) for b in bounds]), 2),
              ("agent.step", _cfg(), _params(control_bounds=bounds), 2)),
             (("planner.x", ("grid", [1, [2, 3]])), ("planner.x", ("grid", (1, (2, 3)))))]
    for listed, tupled in pairs:
        with pytest.raises(TypeError):
            hash(listed)
        assert graph.freeze(listed) == graph.freeze(tupled)
        assert hash(graph.freeze(listed)) == hash(graph.freeze(tupled))
    assert graph.freeze(_cfg(stages=((0.5, 8, 0.2),))) != graph.freeze(
        _cfg(stages=((0.5, 8, 0.3),)))
    # A config keeps what it was given.
    assert isinstance(_cfg(stages=_listed(STAGES)).solver.refine_stages, list)


@pytest.mark.parametrize("eager", [False, True])
def test_unhashable_key_raises_on_the_cpu(eager):
    """A key that stays unhashable after freezing raises on the CPU (and
    inside `graph.eager()`) as it would on the card, before ``fn`` runs."""
    ran = []
    with graph.eager() if eager else contextlib.nullcontext():
        with pytest.raises(TypeError):
            graph.run(("test.unhashable", np.zeros(3)), lambda x: ran.append(x) or x, CPU,
                      torch.ones(2))
    assert not ran


def _batch_entry(cfg):
    p = obstacle_problems(cfg, 8, seed=4, dtype=torch.float64, device=CPU)
    return make_batch_solver(cfg, device=CPU)(p)


def _make_solver_entry(cfg):
    p = obstacle_problems(cfg, 4, seed=2, dtype=torch.float64, device=CPU)
    return make_solver(cfg, device=CPU)(p)


def _fleet_entry(cfg, params):
    env, obstacles = episode_worlds(cfg, 4, n_waypoints=2, seed=3, n_dynamic=1,
                                    dtype=torch.float64, device=CPU)
    return fleet_tick(cfg, params, env, obstacles, CPU)


def _agent_entry(cfg, params):
    a = agent.init_agent(cfg, [[0.0, 0.0, 0.0], [0.3, 0.1, 0.2]], [2.0, 0.0, 0.0],
                         dtype=torch.float64, device=CPU)
    walkers = dynamic_set([[1.0, 0.3], [2.5, -0.4]], [2.8, 1.6], [0.3, 0.2], radius=0.3,
                          max_obstacles=K, dtype=torch.float64, device=CPU)
    return agent.step(cfg, params, a, walkers, device=CPU)


@pytest.mark.parametrize("entry", ["make_batch_solver", "make_solver", "fleet_tick stages",
                                   "fleet_tick bounds", "agent.step"])
def test_list_valued_configs_run_through_every_key(regions, entry):
    """A config with a list-valued `refine_stages`, or `AgentParams` with
    list-valued `control_bounds`, runs through the entry point's
    `graph.run` (whose key holds it) and is bitwise equal to its
    tuple-valued twin."""
    bounds = ((-0.2, 0.5), (-0.5, 0.5))
    tupled, listed = _cfg(), _cfg(stages=_listed(STAGES))
    params, lparams = _params(control_bounds=bounds), _params(
        control_bounds=[list(b) for b in bounds])
    run = {"make_batch_solver": lambda c, p: _batch_entry(c),
           "make_solver": lambda c, p: _make_solver_entry(c),
           "fleet_tick stages": lambda c, p: _fleet_entry(c, params),
           "fleet_tick bounds": lambda c, p: _fleet_entry(tupled, p),
           "agent.step": lambda c, p: _agent_entry(tupled, p)}[entry]
    got, ref = run(listed, lparams), run(tupled, params)
    assert all(_same(a, b) for a, b in zip(leaves(got), leaves(ref), strict=True))
    ran = [key for key, _ in regions if key != "scenarios.obstacle_problems"]
    assert ran == [entry.split(" ")[0]] * 2


# --- the perception tick ------------------------------------------------------


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """The port's synthetic walk (48x64 image, P=128, M=1), 8 frames, read
    back time-synced: (path, frames)."""
    path = str(tmp_path_factory.mktemp("walk") / "walk.npz")
    record_synthetic_walk(path, n_frames=8, dt=FRAMES_DT)
    return path, list(FrameReplayer(path).synced())


def _stack(frames):
    return tuple(torch.as_tensor(np.stack([getattr(f, name) for f in frames]))
                 for name in ("points", "point_mask", "instance_masks", "instance_valid"))


def _world(cfg, frames, dtype):
    """Episode worlds (detour router), the offsets of scripts/
    bench_perception_tick.py:72-74, the walk's geometry and stacked frames,
    and empty track tables."""
    env, static = episode_worlds(cfg, B, n_waypoints=2, seed=0, n_dynamic=0,
                                 route_around_obstacles=True, dtype=dtype, device=CPU)
    offsets = env.agent.states_matrix[:, 0, :2] + torch.tensor([1.2, 0.0], dtype=dtype)
    geom = geometry_from_numpy(frames[0].geometry, device=CPU)
    pstate = pipeline.init_perception(CAP, batch=B, device=CPU)
    return env, static, offsets, geom, _stack(frames), pstate


def _tick(variant, cfg, world, env, pstate, f):
    _, static, offsets, geom, stack, _ = world
    frame = torch.full((1,), f, dtype=torch.int64)
    return perception_tick(variant, cfg, _params(), tracker.TrackerConfig(), geom, stack,
                           offsets, static, env, pstate, frame, CPU)


def _eager_tick(variant, cfg, world, env, pstate, f):
    """The tick composed by hand from the bench's steps, frame ``f`` taken
    with a Python index."""
    _, static, offsets, geom, stack, _ = world
    if variant == "solver_only":
        env, info = environment.fleet_step(cfg, _params(), env, static, device=CPU)
        return env, pstate, info, None
    pstate, tracked = pipeline.step(tracker.TrackerConfig(), pstate, geom,
                                    *(x[f] for x in stack), FRAMES_DT, device=CPU)
    tracked = tracked._replace(position=tracked.position + offsets[:, None, :])
    obstacles = ObstacleSet(*(torch.cat([a, b], dim=1) for a, b in zip(static, tracked)))
    env, info = environment.fleet_step(cfg, _params(), env, obstacles, device=CPU)
    return env, pstate, info, tracked


@pytest.mark.parametrize("variant", VARIANTS)
def test_perception_tick_never_syncs(regions, card_launch, walk, variant):
    """Each variant's region, at B=6, K=4 plus 4 tracker slots, the solve on
    the fused wrapper's card path, over two ticks at frames 3 and 6: the
    frame selected on the device, the pipelines, the join and
    `fleet_step`, with no host round-trip."""
    cfg = _cfg(backend="fused")
    world = _world(cfg, walk[1], torch.float32)
    env, pstate = world[0], world[5]
    for f in (3, 6):
        env, pstate, _, _ = _tick(variant, cfg, world, env, pstate, f)
    _never_synced(regions, ["perception_tick"] * 2)
    assert card_launch.trips == [6, 8] * 2


def test_perception_tick_is_the_eager_composition(walk):
    """Both variants through `graph.run` are bitwise the bench's steps
    composed by hand, over 4 ticks at frames 0, 5, 2, 7 (the frame index a
    tensor in one, a Python int in the other), float32 on the default
    fused backend (its plain version on the CPU)."""
    cfg = _cfg(backend="fused")
    world = _world(cfg, walk[1], torch.float32)
    for variant in VARIANTS:
        got = ref = (world[0], world[5])
        for f in (0, 5, 2, 7):
            out = _tick(variant, cfg, world, *got, f)
            want = _eager_tick(variant, cfg, world, *ref, f)
            assert all(_same(a, b) for a, b in zip(leaves(out), leaves(want), strict=True)), f
            got, ref = out[:2], want[:2]
        if variant == "with_perception":  # the walker is tracked in every pipeline
            assert bool((out[3].active.sum(-1) >= 1).all())


def test_perception_tick_matches_jax(walk):
    """The port's perception tick (split, float64 worlds) against a jitted
    JAX tick composed as scripts/bench_perception_tick.py:88-104 composes
    it, on the same walk and worlds, over 3 ticks at frames 0-2: track
    tables and tracked obstacles bitwise equal, controls within 1e-6,
    converged flags equal."""
    path, frames = walk
    jframes = list(JReplayer(path).synced())
    jgeom = jframes[0].geometry
    pts, pm, im, iv = (jnp.asarray(np.stack([getattr(f, n) for f in jframes]))
                       for n in ("points", "point_mask", "instance_masks", "instance_valid"))
    kw = dict(horizon=12, time_step=0.041, max_obstacles=K)
    skw = dict(iterations=6, refine_stages=STAGES, mu_sigma_max=0.7)
    jcfg = JConfig(**kw)
    jcfg = jcfg.replace(solver=dataclasses.replace(jcfg.solver, **skw))
    cfg = _cfg()
    pkw = dict(prediction_dt=0.041, complete_warm_starts=False, stall_skip_ticks=50)
    je, jstatic = j_episode_worlds(jcfg, B, n_waypoints=2, seed=0, n_dynamic=0,
                                   route_around_obstacles=True, dtype=jnp.float64)
    start_xy = np.asarray(je.agent.states_matrix[:, 0, :2])
    joffsets = jnp.asarray(start_xy + np.array([1.2, 0.0]))
    jtcfg = jt.TrackerConfig()
    jps = jax.vmap(lambda _: jp.init_perception(capacity=CAP, dtype=jnp.float32))(
        jnp.arange(B))

    @jax.jit
    def jtick(env, pstate, fidx):
        frame = (pts[fidx], pm[fidx], im[fidx], iv[fidx])

        def one(ps, off):
            ps2, obs = jp.step(jtcfg, ps, jgeom, *frame, dt=0.1)
            return ps2, obs._replace(position=obs.position + off[None, :])

        pstate2, tracked = jax.vmap(one)(pstate, joffsets)
        obstacles = jax.vmap(lambda a, b: jax.tree.map(
            lambda x, y: jnp.concatenate([x, y], axis=0), a, b))(jstatic, tracked)
        new_env, info = j_env.fleet_step(jcfg, JParams(**pkw), env, obstacles)
        return new_env, pstate2, info, tracked

    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    env = env_from_numpy(np_tree(je), device=CPU)
    static = obstacles_from_numpy(np_tree(jstatic), device=CPU)
    geom = geometry_from_numpy(frames[0].geometry, device=CPU)
    offsets = torch.tensor(np.asarray(joffsets))
    pstate = pipeline.init_perception(CAP, batch=B, device=CPU)
    stack = _stack(frames)
    for f in range(3):
        je, jps, jinfo, jtracked = jtick(je, jps, f)
        env, pstate, info, tracked = perception_tick(
            "with_perception", cfg, _params(), tracker.TrackerConfig(), geom, stack, offsets,
            static, env, pstate, torch.full((1,), f, dtype=torch.int64), CPU)
        for name in tracker.TrackTable._fields:
            np.testing.assert_array_equal(getattr(pstate.tracks, name).numpy(),
                                          np.asarray(getattr(jps.tracks, name)),
                                          err_msg=f"{name}, frame {f}")
        for name in ObstacleSet._fields:
            np.testing.assert_array_equal(getattr(tracked, name).numpy(),
                                          np.asarray(getattr(jtracked, name)),
                                          err_msg=f"{name}, frame {f}")
        np.testing.assert_array_equal(info.diagnostics.converged.numpy(),
                                      np.asarray(jinfo.diagnostics.converged))
        np.testing.assert_allclose(env.agent.controls_matrix.numpy(),
                                   np.asarray(je.agent.controls_matrix), rtol=0, atol=TOL)
    assert float(tracked.active.sum()) == B  # confirmed from the second tick on


# --- the pool builder ---------------------------------------------------------


def test_pool_builder_never_syncs(regions):
    """`obstacle_problems` (K=8, 2 moving, B=16): the build from the
    sampled starts, goals and obstacles in one region."""
    cfg = MPCConfig(horizon=12, time_step=0.041, max_obstacles=8)
    obstacle_problems(cfg, 16, seed=1, n_dynamic=2, device=CPU)
    _never_synced(regions, ["scenarios.obstacle_problems"], min_ops=200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pool_builder_is_the_eager_build(dtype):
    """Through `graph.run` the pool is bitwise `problem_with_obstacles` on
    the same samples, called directly."""
    from kissmpc_tpu_torch.scenarios import (DEFAULT_INFLATION, sample_endpoints,
                                             sample_obstacle_field)
    from kissmpc_tpu_torch.solver.problem import problem_with_obstacles

    cfg = MPCConfig(horizon=12, time_step=0.041, max_obstacles=8)
    got = obstacle_problems(cfg, 16, seed=7, n_dynamic=2, dtype=dtype, device=CPU)
    rng = np.random.default_rng(7)
    starts, goals = sample_endpoints(cfg, 16, rng)
    centers, radii, orientation, v = sample_obstacle_field(
        starts, goals, 8, rng, n_dynamic=2, inflation=DEFAULT_INFLATION)
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    obs = ObstacleSet(t(centers), t(radii), t(orientation), t(v),
                      torch.zeros((16, 8), dtype=dtype), torch.ones((16, 8), dtype=dtype))
    ref = problem_with_obstacles(cfg, t(starts), t(goals), obs, sensor_radius=5.0,
                                 prediction_dt=cfg.time_step,
                                 inflation_radius=DEFAULT_INFLATION, dtype=dtype, device=CPU)
    assert all(_same(a, b) for a, b in zip(leaves(got), leaves(ref), strict=True))


def test_pool_builder_matches_jax():
    """The pool builder against the JAX package's jitted one (K=8, 2
    moving, B=16, N=12, float64), within tests/test_torch_problem.py's
    1e-9."""
    kw = dict(horizon=12, time_step=0.041, max_obstacles=8)
    jpool = j_obstacle_problems(JConfig(**kw), 16, seed=3, n_dynamic=2, dtype=jnp.float64)
    tpool = obstacle_problems(MPCConfig(**kw), 16, seed=3, n_dynamic=2, dtype=torch.float64,
                              device=CPU)
    _assert_problem_close(tpool, jpool)


# --- what is left to port ------------------------------------------------------


def _public_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


# Public names the port leaves out on purpose: the host-clock phase timer
# and the best-of-5 timer, which nothing of the port read; the port's spans
# are the profiler's (`utils/profiling.py::annotate`).
DROPPED = {"utils/metrics.py": {"PhaseTimer"}, "utils/profiling.py": {"measure"}}


def test_every_public_name_of_the_reference_is_ported():
    """Every module of `kissmpc_tpu/` has its counterpart in the port, with
    every public top-level name (the Pallas kernels apart: their ports are
    CUDA sources behind `ops/riccati.py` and `ops/ipm_fused.py`; the names
    of `DROPPED` apart, which the port must not have)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    missing = {}
    for ref in sorted((root / "kissmpc_tpu").rglob("*.py")):
        rel = ref.relative_to(root / "kissmpc_tpu")
        if rel.parts[:2] == ("ops", "pallas"):
            continue
        port = root / "kissmpc_tpu_torch" / rel
        names = _public_names(port) if port.exists() else set()
        dropped = DROPPED.get(str(rel), set())
        assert dropped <= _public_names(ref) and not dropped & names, rel
        lost = _public_names(ref) - names - dropped
        if lost or not port.exists():
            missing[str(rel)] = sorted(lost) or "module"
    assert not missing, missing
