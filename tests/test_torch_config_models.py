"""Port parity: config dataclasses, unicycle model and costs (torch vs JAX).

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in `kissmpc_tpu_torch`, in float64, to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissmpc_tpu.config as jcfg
import kissmpc_tpu_torch.config as tcfg
from kissmpc_tpu.models import costs as jcosts
from kissmpc_tpu.models import unicycle as juni
from kissmpc_tpu_torch.models import costs as tcosts
from kissmpc_tpu_torch.models import unicycle as tuni

TOL = 1e-12
N, B, DT = 9, 5, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if default is dataclasses.MISSING:
            default = f.default_factory()
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["CostConfig", "SolverConfig", "MPCConfig"])
def test_config_fields_and_defaults_match(name):
    jt, tt = _fields(getattr(jcfg, name)), _fields(getattr(tcfg, name))
    assert [n for n, _ in tt] == [n for n, _ in jt]
    for (n, jd), (_, td) in zip(jt, tt):
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(td) == dataclasses.asdict(jd), n
        else:
            assert td == jd, n


@pytest.mark.parametrize("preset", ["ROS_DEPLOYMENT", "RESEARCH"])
def test_config_presets_match(preset):
    assert dataclasses.asdict(getattr(tcfg, preset)) == dataclasses.asdict(
        getattr(jcfg, preset)
    )


def _trajectory(seed):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, N + 1, 3))
    controls = rng.normal(scale=0.4, size=(B, N, 2))
    goal = rng.normal(size=(B, 3))
    return states, controls, goal


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_unicycle_step_rollout_defects_linearize():
    states, controls, _ = _trajectory(0)
    ts, tc = torch.tensor(states), torch.tensor(controls)
    js, jc = jnp.asarray(states), jnp.asarray(controls)
    _close(tuni.step(ts[:, :-1], tc, DT), juni.step(js[:, :-1], jc, DT))
    _close(
        tuni.rollout(ts[:, 0], tc, DT),
        jax.vmap(lambda s, c: juni.rollout(s, c, DT))(js[:, 0], jc),
    )
    _close(
        tuni.defects(ts, tc, DT),
        jax.vmap(lambda s, c: juni.defects(s, c, DT))(js, jc),
    )
    tA, tB = tuni.linearize(ts, tc, DT)
    jA, jB = jax.vmap(lambda s, c: juni.linearize(s, c, DT))(js, jc)
    _close(tA, jA)
    _close(tB, jB)


@pytest.mark.parametrize("goal_mode", ["full", "exclude_terminal"])
@pytest.mark.parametrize("reverse_mode", ["squared", "linear"])
def test_costs_match(goal_mode, reverse_mode):
    states, controls, goal = _trajectory(1)
    kw = dict(
        goal_cost_mode=goal_mode,
        reverse_penalty_mode=reverse_mode,
        positive_velocity_weight=3.0,
    )
    jc_, tc_ = jcfg.CostConfig(**kw), tcfg.CostConfig(**kw)
    ts, tu, tg = (torch.tensor(x) for x in (states, controls, goal))
    js, ju, jg = (jnp.asarray(x) for x in (states, controls, goal))
    _close(
        tcosts.total_cost(tc_, ts, tu, tg),
        jax.vmap(lambda s, u, g: jcosts.total_cost(jc_, s, u, g))(js, ju, jg),
    )
    tgx, tgu = tcosts.stage_gradients(tc_, ts, tu, tg)
    jgx, jgu = jax.vmap(lambda s, u, g: jcosts.stage_gradients(jc_, s, u, g))(js, ju, jg)
    _close(tgx, jgx)
    _close(tgu, jgu)
    tHx, tHu = tcosts.stage_hessians(tc_, ts, tu)
    jHx, jHu = jax.vmap(lambda s, u: jcosts.stage_hessians(jc_, s, u))(js, ju)
    _close(tHx, jHx)
    _close(tHu, jHu)
