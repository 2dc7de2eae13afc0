"""The port's utils (`kissmpc_tpu_torch/utils/`): metrics aggregation
against the JAX package's aggregator on the same diagnostics,
`block_until_ready`, checkpoint round trips of a fleet state carried
across from JAX, profiler traces and the program's spans."""

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu import environment as j_env
from kissmpc_tpu.utils.metrics import MetricsAggregator as JAggregator
from kissmpc_tpu_torch import MPCConfig, bridge, default_problem, environment, make_solver
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.utils.checkpoint import CheckpointManager, FleetCheckpoint
from kissmpc_tpu_torch.utils.metrics import MetricsAggregator
from kissmpc_tpu_torch.utils.profiling import annotate, block_until_ready, trace


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_metrics_aggregation_matches_jax():
    """Port solves recorded by the port's aggregator, and the same
    diagnostics as numpy by the JAX package's: the summaries agree key for
    key (the latency fed to both), and the JSONL lines carry the same keys."""
    cfg = MPCConfig(horizon=10, time_step=0.1)
    solver = make_solver(cfg, device="cpu")
    agg, ref = MetricsAggregator(), JAggregator()
    for i in range(3):
        t0 = time.perf_counter()
        sol = solver(default_problem(cfg, [0.0, 0.0, 0.0], [1.0, 0.1 * i, 0.0],
                                     dtype=torch.float64, device="cpu"))
        latency = time.perf_counter() - t0
        agg.record_tick(latency, sol.diagnostics, batch=1)
        ref.record_tick(latency, bridge.solution_to_numpy(sol).diagnostics, batch=1)
    s, r = agg.summary(), ref.summary()
    assert s == r
    assert s["ticks"] == 3
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] > 0
    assert s["converged_fraction_mean"] == 1.0
    lines = agg.to_jsonl().splitlines()
    assert len(lines) == 3
    got, want = json.loads(lines[0]), json.loads(ref.to_jsonl().splitlines()[0])
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "t"} == {
        k: v for k, v in want.items() if k != "t"}


def test_metrics_without_diagnostics():
    agg = MetricsAggregator(capacity=2)
    for i in range(3):
        agg.record_tick(0.001 * (i + 1), converged_fraction=0.5)
    s = agg.summary()
    assert s["ticks"] == 2 and s["converged_fraction_mean"] == 0.5
    assert np.isnan(s["kkt_stationarity_worst"])


def test_block_until_ready_returns_its_argument():
    x = torch.ones((64, 64), dtype=torch.float64)
    out = {"sum": (x @ x).sum(), "parts": ((x + 1,), [x * 2])}
    assert block_until_ready(out) is out


def _env():
    """A JAX EnvState of one episode carried across to the port."""
    cfg = JConfig(horizon=6, time_step=0.1)
    env = j_env.init_env(cfg, jnp.array([0.1, 0.2, 0.3]),
                         waypoints=jnp.array([[1.0, 0.0, 0.0]]), dtype=jnp.float32)
    return bridge.env_from_numpy(jax.tree.map(lambda x: x[None], env), device="cpu")


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = MPCConfig(horizon=6, time_step=0.1)
    params = AgentParams()
    env = _env()
    gen = torch.Generator().manual_seed(7)
    state = FleetCheckpoint(env_state=env, rng_key=gen.get_state(),
                            scenario_cursor=torch.tensor(42), tick=torch.tensor(1337))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(5, state)
    assert mgr.latest_step() == 5
    restored = mgr.restore(5, state)
    mgr.close()
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(restored.env_state.agent.initial_state[0].numpy(),
                               [0.1, 0.2, 0.3], atol=1e-7)
    assert int(restored.scenario_cursor) == 42 and int(restored.tick) == 1337
    # The restored generator continues the same stream.
    resumed = torch.Generator()
    resumed.set_state(restored.rng_key)
    assert torch.equal(torch.rand(4, generator=resumed), torch.rand(4, generator=gen))
    # One tick from the restored state is the tick without the checkpoint.
    want, _ = environment.step(cfg, params, env, device="cpu")
    got, _ = environment.step(cfg, params, restored.env_state, device="cpu")
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(1, 6):
        mgr.save(step, {"x": torch.full((2,), float(step)), "n": step})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_4.pt", "ckpt_5.pt"]
    # A save cut off before its rename leaves only a temporary file behind.
    (tmp_path / "ckpt_6.pt.123.tmp").write_bytes(b"partial")
    assert mgr.latest_step() == 5
    back = mgr.restore(5, {"x": torch.zeros(2), "n": 0})
    assert torch.equal(back["x"], torch.full((2,), 5.0)) and back["n"] == 5
    # numpy leaves of ``like`` come back as numpy, as orbax restores them.
    back = mgr.restore(4, {"x": np.zeros(2, np.float32), "n": 0})
    assert isinstance(back["x"], np.ndarray) and back["x"].tolist() == [4.0, 4.0]
    with pytest.raises(ValueError):
        mgr.restore(5, {"x": torch.zeros(3), "n": 0})
    with pytest.raises(ValueError):
        mgr.restore(5, {"x": torch.zeros(2), "n": 0, "extra": 1})


def test_trace_names_the_span(tmp_path):
    x = torch.ones(32, 32)
    with trace(str(tmp_path)):
        with annotate("fleet_tick"):
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    assert "fleet_tick" in open(files[0]).read()


def test_annotate_is_one_shared_null_context_while_no_profiler_records():
    """No profiler: every span is the same null context, entered at no
    cost beyond the check, whatever its name."""
    assert not torch.autograd._profiler_enabled()
    first, second = annotate("node.tick"), annotate("graph.replay")
    assert first is second
    with first as entered:
        assert entered is None


def test_annotate_records_nested_host_spans_under_a_profiler():
    """Under a profiler each span is a host event of its own, under the
    span around it, and holds the work run inside it."""
    x = torch.ones(16, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outer = annotate("test.outer")
        assert outer is not annotate("test.other")
        with outer:
            with annotate("test.inner"):
                (x @ x).sum()
    events = {e.name: e for e in prof.events()}
    inner = events["test.inner"]
    assert events["test.outer"].device_type.name == inner.device_type.name == "CPU"
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "test.outer"
    assert {c.name for c in inner.cpu_children} == {"aten::matmul", "aten::sum"}
