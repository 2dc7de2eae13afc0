"""The single-robot path made capturable (`kissmpc_tpu_torch/solver/graph.py`),
on the CPU at the node's size (N=7, B <= 2).

On the card `make_solver`, `io.Model.step` and `agent.step` each run one
CUDA graph per shape; a capture fails on any host synchronisation inside
its region.  Here nothing is captured (the CPU path is the eager one), so
these tests hold the region itself to that: under a `TorchDispatchMode`,
the function each entry point hands `graph.run` issues no
`_local_scalar_dense` (a read of one value to the host), `lift_fresh` (a
host value made a tensor, copied to the card there), `nonzero` or
`is_nonzero`.  The repairs that made it so are held bitwise to the
expressions they replaced, and `make_solver` through `graph.run` to the JAX
package's jitted `make_solver`: controls within 1e-4 (float32; the budget
of tests/test_torch_io.py's `Model` commands, which hold the node tick) and
equal converged flags.  The card's side (a replay bitwise equal to the
eager path) is tests/test_torch_capture_cuda.py.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.solver.api import make_solver as j_make_solver
from kissmpc_tpu.solver.problem import default_problem as j_default_problem
from kissmpc_tpu_torch import MPCConfig, agent, make_solver
from kissmpc_tpu_torch._device import constant
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.config import CostConfig
from kissmpc_tpu_torch.io import Model
from kissmpc_tpu_torch.models import costs
from kissmpc_tpu_torch.obstacles import dynamic_set, static_set
from kissmpc_tpu_torch.solver import graph, ipm
from kissmpc_tpu_torch.solver.problem import _batch_of, _one_hot, default_problem

CPU = "cpu"
SYNC_OPS = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero", "aten.is_nonzero")
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small operations, beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(x: torch.Tensor) -> np.ndarray:
    """The tensor's bytes, so that NaN and -0.0 compare as bits."""
    return x.contiguous().numpy().view(np.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(_bits(a), _bits(b)))


class _SyncOps(TorchDispatchMode):
    """Counts the dispatcher's host round-trips, by op."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func.overloadpacket)
        if name in SYNC_OPS:
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def regions(monkeypatch):
    """Every function an entry point hands `graph.run` runs under a
    `_SyncOps`; yields the list of (key, counts) it fills."""
    real = graph.run
    found = []

    def spy(key, fn, device, *inputs):
        def counted(*args):
            with _SyncOps() as mode:
                out = fn(*args)
            found.append((key[0], mode))
            return out

        return real(key, counted, device, *inputs)

    monkeypatch.setattr(graph, "run", spy)
    yield found


def _walkers():
    return dynamic_set([[1.0, 0.3], [2.5, -0.4]], [2.8, 1.6], [0.3, 0.2], radius=0.3,
                       max_obstacles=6, dtype=torch.float32, device=CPU)


def _node_tick():
    model = Model(max_obstacles=4, waypoints=[[1.5, 0.4, 0.0], [3.0, 0.0, 0.0]], device=CPU)
    model.set_obstacles(_walkers())
    model.step()


def _make_solver_call():
    cfg = MPCConfig(horizon=7, time_step=0.8, max_obstacles=4)
    p = default_problem(cfg, [[0.0, 0.0, 0.0], [0.2, -0.1, 0.3]], [[1.5, 0.4, 0.0]],
                        obstacle_centers=torch.tensor([[[0.8, 0.1]] * 4] * 2),
                        obstacle_radii=[[0.3, 0.2, 0.2, 0.2]] * 2,
                        obstacle_mask=[[1.0, 0.0, 0.0, 0.0]] * 2, device=CPU)
    make_solver(cfg, device=CPU)(p)


def _agent_step(override):
    cfg = MPCConfig(horizon=7, time_step=0.8, max_obstacles=4)
    a = agent.init_agent(cfg, [[0.0, 0.0, 0.0], [0.3, 0.1, 0.2]], [2.0, 0.0, 0.0], device=CPU)
    if override == "tensor":
        override = torch.tensor([True, False])
    agent.step(cfg, AgentParams(), a, _walkers(), override, device=CPU)


@pytest.mark.parametrize("entry", ["io.Model", "make_solver", "agent.step",
                                   "agent.step override", "agent.step tensor override"])
def test_captured_regions_never_sync(regions, entry):
    """The node tick (N=7, 40 iterations, 4 obstacle slots, two walkers),
    `make_solver` at B=2 and `agent.step` at B=2 (a bool and a [B] tensor
    state override) each go through `graph.run` once, and its region issues
    none of the host round-trips that a CUDA graph cannot capture."""
    {"io.Model": _node_tick,
     "make_solver": _make_solver_call,
     "agent.step": lambda: _agent_step(False),
     "agent.step override": lambda: _agent_step(True),
     "agent.step tensor override": lambda: _agent_step("tensor")}[entry]()
    assert [key for key, _ in regions] == [entry.split(" ")[0]]
    mode = regions[0][1]
    assert mode.ops > 10_000  # the whole solve ran inside the region
    assert not mode.seen, dict(mode.seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("weights", [(100.0, 100.0, 50.0), (0.1, 1.0 / 3.0, 1e-40)])
def test_goal_weights_bitwise(dtype, weights):
    """The cached goal weights equal `torch.tensor(cfg.goal_weights)`, bit
    for bit (1e-40 is subnormal in float32), and are made once."""
    cfg = CostConfig(goal_weights=weights)
    like = torch.zeros(2, dtype=dtype)
    w = costs._weights(cfg, like)
    assert _same(w, torch.tensor(weights, dtype=dtype))
    assert costs._weights(cfg, like) is w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_constant_bitwise(dtype):
    values = (1.0, 0.0, -0.0, float("inf"), -float("inf"), float("nan"), 0.1, 3, True, 1e-40,
              3.4028234663852886e38)
    assert _same(constant(values, dtype, CPU), torch.tensor(values, dtype=dtype))
    assert _same(constant((), dtype, CPU), torch.tensor((), dtype=dtype))


@pytest.mark.parametrize("K", [1, 4, 9])
def test_one_hot_bitwise(K):
    """The comparison one-hot equals `one_hot(index, K).to(dtype)` on the
    argmax of pushes with ties (`argmax` breaks them as before)."""
    rng = np.random.default_rng(K)
    push = torch.as_tensor(rng.integers(0, 3, size=(2, 7, K)).astype(np.float32))
    idx = torch.argmax(push, dim=-1)
    for dtype in (torch.float32, torch.float64):
        assert _same(_one_hot(idx, K, dtype),
                     torch.nn.functional.one_hot(idx, K).to(dtype))


@pytest.mark.parametrize("x,shape", [
    (0.3, (2,)), (2, (2,)), (True, (2,)), (-float("inf"), (2, 3)),
    ((0.5, -0.2), (2, 2)), ([-20.0, -float("inf"), 0.1], (2, 3)),
    ((1, 2.5), (2, 2)), (np.array([0.1, 0.2, 0.7]), (2, 3)),
    (torch.tensor([[0.3], [0.4]], dtype=torch.float64), (2, 3)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_of_bitwise(x, shape, dtype):
    """`_batch_of` equals the expression it replaced on every kind of
    input the builders pass: numbers, rows of numbers, arrays, tensors."""
    got = _batch_of(x, shape, dtype, CPU)
    want = torch.as_tensor(x, dtype=dtype, device=CPU).broadcast_to(shape).contiguous()
    assert _same(got, want)


def test_run_on_the_cpu_is_the_eager_call():
    """On the CPU `graph.run` calls the function on the inputs, captures
    nothing, and `eager()` nests and restores."""
    before = graph.captured()
    x = torch.arange(3.0)
    out = graph.run(("test.square",), lambda t: {"sq": t * t}, CPU, x)
    assert torch.equal(out["sq"], x * x) and graph.captured() == before
    with graph.eager():
        with graph.eager():
            pass
        assert graph._EAGER
    assert not graph._EAGER


def test_make_solver_is_ipm_solve_and_matches_jax():
    """`make_solver` through `graph.run` is `ipm.solve` bit for bit on the
    CPU, and matches the JAX package's jitted `make_solver` per scenario."""
    starts = np.array([[0.0, 0.0, 0.0], [0.2, -0.3, 1.0]], np.float32)
    goal = np.array([1.5, 0.4, 0.0], np.float32)
    cfg = MPCConfig(horizon=7, time_step=0.8)
    p = default_problem(cfg, starts, goal, device=CPU)
    sol = make_solver(cfg, device=CPU)(p)
    ref = ipm.solve(cfg, p)
    for a, b in zip((sol.states, sol.controls, *sol.diagnostics),
                    (ref.states, ref.controls, *ref.diagnostics)):
        assert _same(a, b)
    jcfg = JConfig(horizon=7, time_step=0.8)
    jsolve = j_make_solver(jcfg)
    for i, s in enumerate(starts):
        j = jsolve(j_default_problem(jcfg, jnp.asarray(s), jnp.asarray(goal)))
        np.testing.assert_allclose(sol.controls[i].numpy(), np.asarray(j.controls),
                                   atol=TOL, rtol=0)
        assert bool(sol.diagnostics.converged[i]) == bool(j.diagnostics.converged)


def test_set_obstacles_copies_into_the_model_buffer():
    """`set_obstacles` copies into the model's buffer (the caller's tensors
    are never aliased), takes a new buffer when K changes, and None clears
    it to ``max_obstacles`` empty slots."""
    model = Model(max_obstacles=4, device=CPU)
    empty = model._obstacles
    assert empty.position.shape == (4, 2) and float(empty.active.abs().sum()) == 0.0
    assert len({x.data_ptr() for x in empty}) == len(empty)  # no leaf aliases another
    first = static_set([[1.0, 0.0]], [0.3], max_obstacles=4, device=CPU)
    model.set_obstacles(first)
    assert all(h.data_ptr() == e.data_ptr() for h, e in zip(model._obstacles, empty))
    second = static_set([[2.0, 1.0]], [0.2], max_obstacles=4, device=CPU)
    model.set_obstacles(second)
    assert torch.equal(model._obstacles.position, second.position)
    assert torch.equal(first.position[0], torch.tensor([1.0, 0.0]))  # untouched
    model.set_obstacles(_walkers())
    assert model._obstacles.position.shape == (6, 2)
    model.set_obstacles(None)
    assert model._obstacles.position.shape == (4, 2)
    assert float(model._obstacles.active.abs().sum()) == 0.0
