"""The port's spans and counters: the node tick's spans under a profiler,
nested as the layers call each other, and the refine stages' counts on
the device, held against the same counts taken by hand from the stages'
own inputs.  CPU only; the counts under graph replays are checked on the
card (`tests/test_torch_capture_batch_cuda.py`)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kissmpc_tpu_torch import MPCConfig, solve_batch
from kissmpc_tpu_torch.io import ControlLoop, LatestValue, Model
from kissmpc_tpu_torch.scenarios import obstacle_problems
from kissmpc_tpu_torch.solver import api

NODE_SPANS = {"node.tick": None, "node.fold": "node.tick", "model.step": "node.tick",
              "model.inputs": "model.step", "graph.run": "model.step",
              "model.read": "model.step", "model.advance": "model.step",
              "node.emit": "node.tick"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loop():
    model = Model(horizon=6, planning_time_step=0.2, max_obstacles=2, device="cpu")
    odom, plan, commands = LatestValue(), LatestValue(), []
    loop = ControlLoop(model, odometry=odom, plan=plan,
                       on_command=lambda v, w: commands.append((v, w)))
    return loop, odom, plan, commands


def _spans(prof) -> dict:
    """name -> [(start, end, parent's name)] of the program's spans."""
    spans = {}
    for e in prof.events():
        if "." in e.name and not e.name.startswith(("aten::", "profiler")):
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end, parent))
    return spans


def test_a_tick_nests_its_spans_by_layer():
    """One tick over a CPU `io.Model`: each span once, under the span of
    the layer that called it, in the order the tick runs them; the card's
    steps of `graph.run` (capture, copies, replay) are not on this path."""
    loop, odom, plan, commands = _loop()
    plan.publish(np.array([[1.0, 0.2, 0.0], [2.0, 0.5, 0.0]]))
    odom.publish(np.zeros(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert loop.tick()
    spans = _spans(prof)
    assert set(spans) == set(NODE_SPANS)
    for name, parent in NODE_SPANS.items():
        assert len(spans[name]) == 1 and spans[name][0][2] == parent, (name, spans[name])
    start = {name: spans[name][0][0] for name in spans}
    for order in (("node.fold", "model.step", "node.emit"),
                  ("model.inputs", "graph.run", "model.read", "model.advance")):
        assert sorted(order, key=start.get) == list(order)
    assert len(commands) == 1


def test_a_tick_without_a_plan_folds_and_stops():
    """No waypoints: the tick folds its inputs and returns before the
    model steps, so its spans are the tick's and the fold's alone."""
    loop, odom, _, commands = _loop()
    odom.publish(np.zeros(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not loop.tick()
    spans = _spans(prof)
    assert {k: [p for *_, p in v] for k, v in spans.items()} == {
        "node.tick": [None], "node.fold": ["node.tick"]}
    assert commands == []


def _cfg(iterations, stages):
    cfg = MPCConfig(horizon=12, time_step=0.1, max_obstacles=3)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, solve_backend="split", iterations=iterations, refine_stages=stages))


def _rows(before, after):
    before = before + [[0, 0, 0]] * (len(after) - len(before))
    return [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]


def _record(solves, sol):
    solves.append(sol.diagnostics.converged.numpy().copy())
    return sol


@pytest.mark.parametrize("iterations,stages", [
    (16, ((0.75, 12, 0.2), (0.5, 24, 0.7))),  # converged scenarios re-solved; a stage rescues none
    (14, ((0.75, 10, 0.2), (0.5, 30, 0.5))),  # every stage rescues some
])
def test_refine_counts_are_the_stages_own(monkeypatch, iterations, stages):
    """Two stages on 16 scenarios: each stage's row moves by the scenarios
    it re-solved, those of them that entered unconverged and those it
    rescued, as worked out here from the converged flags of the base solve
    and of each stage's re-solve, by the selection rule (unconverged first,
    ties in batch order)."""
    cfg = _cfg(iterations, stages)
    problems = obstacle_problems(cfg, 16, seed=4, dtype=torch.float64, device="cpu")
    solves = []
    dispatch = api._dispatch
    monkeypatch.setattr(api, "_dispatch", lambda *a, **k: _record(solves, dispatch(*a, **k)))
    before = api.refine_counts("cpu")
    sol = solve_batch(cfg, problems, device="cpu")
    got = _rows(before, api.refine_counts("cpu"))

    conv, want = solves[0].copy(), []
    for (frac, _, _), resolved in zip(stages, solves[1:], strict=True):
        n = min(16, max(1, int(round(16 * frac))))
        idx = np.argsort(conv.astype(np.int8), kind="stable")[:n]
        unconverged = ~conv[idx]
        rescued = resolved & unconverged
        conv[idx] |= rescued
        want.append([n, int(unconverged.sum()), int(rescued.sum())])
    assert got == want
    np.testing.assert_array_equal(sol.diagnostics.converged.numpy(), conv)
    assert sum(row[2] for row in want) > 0


def test_a_solve_without_stages_counts_nothing():
    """No refine stage, no row: the counts stay as they were."""
    cfg = _cfg(6, ())
    problems = obstacle_problems(cfg, 4, seed=1, dtype=torch.float64, device="cpu")
    before = api.refine_counts("cpu")
    solve_batch(cfg, problems, device="cpu")
    assert api.refine_counts("cpu") == before
