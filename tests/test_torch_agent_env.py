"""Port parity of the closed loop: `agent`, `environment` (`step`,
`fleet_step`, `run_episode`), `obstacles.advance` and the episode worlds.

The port is batch-major where the JAX package vmaps a single agent, so a
single JAX episode is a port batch of one.  Worlds are built by the JAX
package (or by both from one numpy seed) and carried across with the numpy
bridge.  Tolerances: float64 closed loops agree to 1e-8 in the states over
every tick (the split IPM agrees to round-off per solve, and the loop feeds
each plan into the next warm start, so round-off grows a little per tick);
geometry (`advance`, `episode_worlds`) to float32 round-off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import agent as j_agent
from kissmpc_tpu import environment as j_env
from kissmpc_tpu.agent import AgentParams as JParams
from kissmpc_tpu.obstacles import static_set as j_static_set
from kissmpc_tpu.obstacles.obstacles import advance as j_advance
from kissmpc_tpu.scenarios import episode_worlds as j_episode_worlds
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import agent as t_agent
from kissmpc_tpu_torch import environment as t_env
from kissmpc_tpu_torch.agent import AgentParams as TParams
from kissmpc_tpu_torch.bridge import env_from_numpy, obstacles_from_numpy
from kissmpc_tpu_torch.obstacles import advance as t_advance
from kissmpc_tpu_torch.obstacles import static_set as t_static_set
from kissmpc_tpu_torch.scenarios import episode_worlds as t_episode_worlds

CPU = "cpu"


def _cfgs(**kw):
    base = dict(horizon=12, time_step=0.1)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_agent_step_semantics():
    _, cfg = _cfgs()
    params = TParams()
    agent = t_agent.init_agent(cfg, [0.0, 0.0, 0.0], [1.0, 0.5, 0.0], dtype=torch.float64,
                               device=CPU)
    new, diag = t_agent.step(cfg, params, agent, device=CPU)
    assert bool(diag.converged.all())
    # commanded velocities latch U[:, 0] (`mpc/agent.py:154-155`)
    assert torch.equal(new.linear_velocity, new.controls_matrix[:, 0, 0])
    assert torch.equal(new.angular_velocity, new.controls_matrix[:, 0, 1])
    # `state` is column 1 of the plan (`mpc/agent.py:70-72`)
    assert torch.equal(t_agent.current_state(new), new.states_matrix[:, 1])
    # and the step matches the JAX agent's
    jcfg, _ = _cfgs()
    ja = j_agent.init_agent(jcfg, jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.5, 0.0]),
                            dtype=jnp.float64)
    jnew, _ = jax.jit(lambda a: j_agent.step(jcfg, JParams(), a))(ja)
    np.testing.assert_allclose(new.states_matrix[0].numpy(), np.asarray(jnew.states_matrix),
                               rtol=0, atol=1e-9)


def test_agent_reset_semantics():
    _, cfg = _cfgs()
    agent = t_agent.init_agent(cfg, [0.5, -0.5, 1.0], [1.0, 0.5, 0.0], dtype=torch.float64,
                               device=CPU)
    agent, _ = t_agent.step(cfg, TParams(), agent, device=CPU)
    r = t_agent.reset(cfg, agent, matrices_only=True)
    np.testing.assert_allclose(r.states_matrix[0].numpy(),
                               np.tile(agent.initial_state[0].numpy(), (cfg.horizon + 1, 1)))
    assert float(r.controls_matrix.abs().max()) == 0.0
    assert torch.equal(r.linear_velocity, agent.linear_velocity)
    r2 = t_agent.reset(cfg, agent, matrices_only=False)
    assert float(r2.linear_velocity[0]) == 0.0
    r3 = t_agent.reset(cfg, agent, to_initial_state=False)
    assert torch.equal(r3.states_matrix[:, 5], t_agent.current_state(agent))


def test_agent_step_checks_the_config_as_make_solver_does():
    """agent.step solves through make_solver, so it refuses what make_solver
    refuses: an lqr_backend other than "auto"."""
    _, cfg = _cfgs()
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, lqr_backend="xla"))
    agent = t_agent.init_agent(cfg, [0.0, 0.0, 0.0], [1.0, 0.5, 0.0], dtype=torch.float64,
                               device=CPU)
    with pytest.raises(ValueError, match="lqr_backend"):
        t_agent.step(cfg, TParams(), agent, device=CPU)


def test_failed_solve_falls_back_to_shifted_plan():
    """A start pinned inside an obstacle's inflation is infeasible: the agent
    keeps the previous plan shifted by one step; a healthy agent in the same
    batch takes its own solve."""
    _, cfg = _cfgs(max_obstacles=1)
    params = TParams(radius=0.2, fallback_feasibility=1e-2)
    agent = t_agent.init_agent(cfg, [[0.0, 0.0, 0.0]] * 2, [2.0, 0.0, 0.0],
                               dtype=torch.float64, device=CPU)
    agent, diag = t_agent.step(cfg, params, agent, device=CPU)
    assert bool(diag.converged.all())
    good_states, good_controls = agent.states_matrix.clone(), agent.controls_matrix.clone()
    p = good_states[0, 1, :2].tolist()
    obs = t_static_set([p], [0.3], dtype=torch.float64, device=CPU)
    far = t_static_set([[9.0, 9.0]], [0.3], dtype=torch.float64, device=CPU)
    batched = type(obs)(*(torch.stack([a, b]) for a, b in zip(obs, far)))
    agent2, diag2 = t_agent.step(cfg, params, agent, batched, device=CPU)
    assert float(diag2.kkt_feasibility[0]) > 1e-2
    assert float(diag2.kkt_feasibility[1]) <= 1e-2
    np.testing.assert_allclose(agent2.states_matrix[0, :-1].numpy(), good_states[0, 1:].numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(agent2.controls_matrix[0, :-1].numpy(),
                               good_controls[0, 1:].numpy(), atol=1e-9)
    assert float(agent2.controls_matrix[0, -1].abs().max()) == 0.0
    assert float(agent2.linear_velocity[0]) == pytest.approx(float(good_controls[0, 1, 0]))
    assert not torch.equal(agent2.states_matrix[1, :-1], good_states[1, 1:])


def test_nan_feasibility_takes_the_fallback():
    from kissmpc_tpu_torch.solver.problem import Diagnostics, Solution

    _, cfg = _cfgs()
    agent = t_agent.init_agent(cfg, [[0.0, 0.0, 0.0]] * 2, dtype=torch.float64, device=CPU)
    agent = agent._replace(controls_matrix=torch.ones_like(agent.controls_matrix))
    nan = torch.tensor([float("nan"), 0.0], dtype=torch.float64)
    sol = Solution(agent.states_matrix + 1.0, agent.controls_matrix * 2.0,
                   Diagnostics(*([nan] * 6)))
    new, _ = t_agent.apply_solution(TParams(), agent, sol)
    assert float(new.linear_velocity[0]) == 1.0  # shifted plan, not the NaN solve
    assert float(new.linear_velocity[1]) == 2.0


def test_waypoint_skip_ahead_and_stall_skip():
    """Mirror of tests/test_environment.py's skip-ahead / stall-skip case,
    on a batch of two episodes advanced together."""
    cfg = TConfig(horizon=6, time_step=0.1)
    params = TParams(stall_skip_ticks=3)
    wps = [[5.0, 5.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0]]
    env = t_env.init_env(cfg, [[0.0, 0.0, 0.0]] * 2, [wps, wps], device=CPU)
    # episode 0 sits on waypoint 1 while its index is 0; episode 1 is far
    on_wp1 = t_agent.init_agent(cfg, [[1.0, 0.0, 0.0], [9.0, -9.0, 0.0]], device=CPU)
    env2, info = t_env._advance_waypoint(params, env, on_wp1, None)
    assert env2.waypoint_index.tolist() == [2, 0]  # skipped past wp 0 AND wp 1
    assert info.final_goal_reached.tolist() == [False, False]
    assert torch.equal(env2.agent.goal_state[0], env.waypoints[0, 2])

    far = t_agent.init_agent(cfg, [[9.0, -9.0, 0.0]] * 2, device=CPU)
    env_s = t_env.init_env(cfg, [[0.0, 0.0, 0.0]] * 2, [wps, wps], device=CPU)
    for _ in range(3):
        assert env_s.waypoint_index.tolist() == [0, 0]
        env_s, _ = t_env._advance_waypoint(params, env_s, far, None)
    assert env_s.waypoint_index.tolist() == [1, 1]
    for _ in range(10):
        env_s, info = t_env._advance_waypoint(params, env_s, far, None)
    assert env_s.waypoint_index.tolist() == [2, 2]  # never past the final one
    assert not bool(info.final_goal_reached.any())
    at_final = t_agent.init_agent(cfg, [[2.0, 0.0, 0.0]] * 2, device=CPU)
    _, info = t_env._advance_waypoint(params, env_s, at_final, None)
    assert bool(info.final_goal_reached.all())
    assert t_env.current_waypoint(env_s).tolist() == [wps[2], wps[2]]


def test_run_episode_matches_jax():
    """A two-waypoint episode with a static obstacle, in float64: waypoint
    indices equal and states within 1e-8 on every tick."""
    jcfg, tcfg = _cfgs(max_obstacles=2)
    params = dict(radius=0.15)
    wps = np.array([[0.8, 0.3, 0.0], [1.4, -0.2, 0.0]])
    jo = j_static_set([[1.0, 0.45], [5.0, 5.0]], [0.2, 0.25], max_obstacles=2,
                      dtype=jnp.float64)
    je = j_env.init_env(jcfg, jnp.zeros(3), jnp.asarray(wps), dtype=jnp.float64)
    ticks = 14
    jfin, jinfo = jax.jit(lambda e: j_env.run_episode(jcfg, JParams(**params), e, ticks, jo))(je)
    te = t_env.init_env(tcfg, [0.0, 0.0, 0.0], wps, dtype=torch.float64, device=CPU)
    to = obstacles_from_numpy(_np(jo), device=CPU)
    tfin, tinfo = t_env.run_episode(tcfg, TParams(**params), te, ticks, to, device=CPU)
    assert tinfo.waypoint_index.shape == (ticks, 1)
    np.testing.assert_array_equal(tinfo.waypoint_index[:, 0].numpy(),
                                  np.asarray(jinfo.waypoint_index))
    assert int(tinfo.waypoint_index[-1, 0]) == 1  # the first waypoint was reached
    np.testing.assert_array_equal(tinfo.diagnostics.converged[:, 0].numpy(),
                                  np.asarray(jinfo.diagnostics.converged))
    np.testing.assert_allclose(tfin.agent.states_matrix[0].numpy(),
                               np.asarray(jfin.agent.states_matrix), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tinfo.final_goal_reached[:, 0].numpy(),
                                  np.asarray(jinfo.final_goal_reached))


STAGES = ((0.5, 16, 0.2),)


def test_fleet_step_matches_jax():
    """B=4 episodes with K=2 moving obstacles, 3 ticks of `fleet_step` plus
    `obstacles.advance`, on the split path in float64 against JAX's
    `fleet_step` (its jnp path on the CPU), worlds from JAX's
    `episode_worlds` through the bridge."""
    skw = dict(iterations=12, refine_stages=STAGES, mu_sigma_max=0.7)
    kw = dict(horizon=12, time_step=0.1, max_obstacles=2)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jcfg = jcfg.replace(solver=dataclasses.replace(jcfg.solver, **skw))
    tcfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver, solve_backend="split", **skw))
    pkw = dict(complete_warm_starts=False, prediction_dt=0.1, stall_skip_ticks=2)
    je, jo = j_episode_worlds(jcfg, 4, n_waypoints=2, seed=1, n_dynamic=1,
                              route_around_obstacles=True, dtype=jnp.float64)
    te, to = env_from_numpy(_np(je), device=CPU), obstacles_from_numpy(_np(jo), device=CPU)

    @jax.jit
    def jtick(e, o):
        e2, info = j_env.fleet_step(jcfg, JParams(**pkw), e, o)
        return e2, jax.vmap(lambda oo: j_advance(oo, 0.1))(o), info

    for _ in range(3):
        je, jo, jinfo = jtick(je, jo)
        te, tinfo = t_env.fleet_step(tcfg, TParams(**pkw), te, to, device=CPU)
        to = t_advance(to, 0.1)
        np.testing.assert_array_equal(tinfo.waypoint_index.numpy(),
                                      np.asarray(jinfo.waypoint_index))
        np.testing.assert_array_equal(te.stall_ticks.numpy(), np.asarray(je.stall_ticks))
        np.testing.assert_array_equal(tinfo.diagnostics.converged.numpy(),
                                      np.asarray(jinfo.diagnostics.converged))
        np.testing.assert_allclose(te.agent.states_matrix.numpy(),
                                   np.asarray(je.agent.states_matrix), rtol=0, atol=1e-8)
        np.testing.assert_allclose(te.agent.linear_velocity.numpy(),
                                   np.asarray(je.agent.linear_velocity), rtol=0, atol=1e-8)
        np.testing.assert_allclose(to.position.numpy(), np.asarray(jo.position),
                                   rtol=0, atol=1e-12)


def test_advance_matches_jax():
    rng = np.random.default_rng(7)
    K = 5
    arrays = dict(
        position=rng.normal(size=(3, K, 2)), radius=rng.uniform(0.1, 0.4, (3, K)),
        orientation=rng.uniform(-np.pi, np.pi, (3, K)),
        linear_velocity=rng.uniform(0.0, 1.0, (3, K)),
        angular_velocity=rng.normal(size=(3, K)),
        active=(rng.uniform(size=(3, K)) > 0.3).astype(np.float64),
    )
    from kissmpc_tpu.obstacles import ObstacleSet as JObs

    jo = JObs(**{k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()})
    to = obstacles_from_numpy(_np(jo), device=CPU)
    for _ in range(4):
        jo = jax.vmap(lambda o: j_advance(o, 0.041))(jo)
        to = t_advance(to, 0.041)
    for name in ("position", "orientation"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=0, atol=2e-6)
    inactive = arrays["active"] < 0.5
    np.testing.assert_array_equal(to.position.numpy()[inactive],
                                  arrays["position"].astype(np.float32)[inactive])


@pytest.mark.parametrize("K,route", [(3, False), (3, True), (0, False)],
                         ids=["K3", "K3_detour", "free"])
def test_episode_worlds_match_jax(K, route):
    jcfg, tcfg = _cfgs(max_obstacles=K)
    je, jo = j_episode_worlds(jcfg, 6, n_waypoints=3, seed=2, n_dynamic=1,
                              route_around_obstacles=route, dtype=jnp.float32)
    te, to = t_episode_worlds(tcfg, 6, n_waypoints=3, seed=2, n_dynamic=1,
                              route_around_obstacles=route, device=CPU)
    assert te.waypoints.shape == tuple(je.waypoints.shape)
    np.testing.assert_allclose(te.waypoints.numpy(), np.asarray(je.waypoints), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(te.agent.states_matrix.numpy(),
                                  np.asarray(je.agent.states_matrix))
    np.testing.assert_array_equal(te.agent.goal_state.numpy(), np.asarray(je.agent.goal_state))
    np.testing.assert_array_equal(te.waypoint_index.numpy(), np.asarray(je.waypoint_index))
    assert to.position.shape == tuple(jo.position.shape)
    for name in type(to)._fields:
        np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)))


def test_grid_router_is_not_ported():
    _, tcfg = _cfgs(max_obstacles=2)
    with pytest.raises(NotImplementedError, match="planner"):
        t_episode_worlds(tcfg, 2, route_around_obstacles=True, router="grid", device=CPU)
