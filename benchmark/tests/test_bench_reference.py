"""Each traffic kind at a tiny size on the CPU, through the port's CPU path
(its kernels' plain versions): sound runs agree with the plain reference
within every limit of the cell's file; runs with a fault planted under the
timed path, and the control (the reference one precision below the
configuration's in the program's place), come out not correct.

These drive everything a run does but the look for a card; a cell's own
readings on the card come from `benchmark/control.py`.  Minutes on one
CPU thread: run them with `python -m pytest benchmark/tests`.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.traffic.common import Context

SEED = 2 ** 40 + 17
# Tiny sizes of each kind's cell: the configuration's solver as stated.
SMALL = {
    "solve.fleet_n50_k8.b8192": {"batch": 8, "pool": 16, "batches": 2},
    "node.node_n7.b1": {"sample": 16},
}


def _rows(n):
    """Row indices that give the first half's rows to the second half too."""
    h = n // 2
    return torch.cat([torch.arange(h), torch.arange(n - h)])


def _solver_fault(kind):
    """`make_batch_solver` with a fault under it."""
    import kissmpc_tpu_torch

    real = kissmpc_tpu_torch.make_batch_solver

    def make(cfg, **kwargs):
        solver = real(cfg, **kwargs)

        def faulty(batch):
            sol = solver(batch)
            if kind == "unchanged":  # each answer is the scenario's warm start
                return sol._replace(states=batch.warm_states.clone(),
                                    controls=batch.warm_controls.clone())
            if kind == "half":  # the first half's answers for the second half too
                rows = _rows(sol.states.shape[0])
                return type(sol)(sol.states[rows], sol.controls[rows],
                                 type(sol.diagnostics)(*(x[rows] for x in sol.diagnostics)))
            states = sol.states.clone()  # "altered": one converged answer's next position
            states[torch.argmax(sol.diagnostics.converged.to(torch.int8)), 1, 0] += 0.05
            return sol._replace(states=states)

        return faulty

    return [(kissmpc_tpu_torch, "make_batch_solver", make)]


def _node_fault(kind):
    """`io.Model.step` with a fault under it: "unchanged" returns the warm
    start (the pinned pose held, zero controls) and reports it honestly
    (not converged, its own violation recomputed), "altered" changes every
    command by 0.05 where the tick produces it."""
    from kissmpc_tpu_torch.io.model import Model

    from benchmark import compare
    from benchmark.reference import config as ref_config
    from benchmark.reference.problem import Problem
    from benchmark.traffic.common import mpc_config

    real = Model.step
    _, config = harness.load_cell("node.node_n7.b1")
    cfg = mpc_config(ref_config, config)

    def step(self, *args, **kwargs):
        real(self, *args, **kwargs)
        if kind == "unchanged":
            pose = self.last_problem.initial_state[0].cpu().double().numpy()
            self._states = np.tile(pose, (self.cfg.horizon + 1, 1))
            self._controls = np.zeros((self.cfg.horizon, 2))
            problem = Problem(*(x.cpu() for x in self.last_problem))
            feas = compare.violation(cfg, problem, torch.as_tensor(self._states)[None],
                                     torch.as_tensor(self._controls)[None])
            self.last_diagnostics = self.last_diagnostics._replace(
                converged=np.array(False), kkt_feasibility=np.array(float(feas[0]), np.float32))
        else:
            self._controls = self._controls.copy()
            self._controls[0, 0] += 0.05
        self.linear_velocity = float(self._controls[0, 0])
        self.angular_velocity = float(self._controls[0, 1])

    return [(Model, "step", step)]


FAULTS = {
    "solve.fleet_n50_k8.b8192": (_solver_fault, ("unchanged", "half", "altered")),
    "node.node_n7.b1": (_node_fault, ("unchanged", "altered")),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name):
    cell, config = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["params"].update(SMALL[name])
    return cell, config


def correct(numbers):
    return all(v == v and v <= limit for _, v, limit in numbers)


def run(name, seconds=1.0):
    cell, config = small(name)
    numbers, calls = control.program_numbers(cell, config, SEED, seconds, device="cpu",
                                             log=lambda m: None)
    assert calls >= 1
    return numbers


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_agrees_with_the_reference(name):
    numbers = run(name)
    assert correct(numbers), numbers
    by = {n: v for n, v, _ in numbers}
    assert all(v == 0.0 for n, v in by.items() if n.endswith(("share", "mismatches")))
    assert by["claim_gap"] < 1e-5


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n][1]])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    for holder, attr, faulty in FAULTS[name][0](fault):
        monkeypatch.setattr(holder, attr, faulty)
    assert not correct(run(name)), fault


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    cell, config = small(name)
    numbers = control.control_numbers(cell, config, SEED + 1, device="cpu", log=lambda m: None)
    assert not correct(numbers), numbers
