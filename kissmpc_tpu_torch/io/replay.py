"""Scenario recording / replay, the rosbag analogue, as arrays.  A port of
`kissmpc_tpu/io/replay.py`.

The reference's de-facto integration harness is rosbag replay
(`obstacle_handling/human_tracking.py:46-111`: a `BagReader` republishing a
recorded sensor session with wall-clock pacing).  This records per-tick
*arrays* (the solver's exact inputs, a `Problem`, and outputs, a
`Solution`) into one compressed npz, which replays deterministically:
re-solving a recorded Problem on the same device reproduces the recorded
controls.  Tensors are copied to numpy when recorded (a helper walks the
named tuples, where the reference maps `jax.tree`); a replayed tick holds
numpy arrays, which `bridge.problem_from_numpy` turns back into a Problem.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..solver.problem import Diagnostics, Problem, Solution


class TickRecord(NamedTuple):
    problem: Problem  # numpy leaves
    solution: Solution  # numpy leaves


def _to_numpy(x):
    """Every tensor or array leaf of a (nested) named tuple as numpy."""
    if isinstance(x, tuple):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stack(records):
    """Named tuples of arrays -> one of the same type, leaves stacked."""
    first = records[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(col)) for col in zip(*records)))
    return np.stack(records)


def _take(tree, i):
    if isinstance(tree, tuple):
        return type(tree)(*(_take(v, i) for v in tree))
    return tree[i]


class ScenarioRecorder:
    """Accumulates per-tick (Problem, Solution) pairs; saves one npz."""

    def __init__(self):
        self._ticks: List[TickRecord] = []

    def record(self, problem: Problem, solution: Solution) -> None:
        self._ticks.append(TickRecord(_to_numpy(problem), _to_numpy(solution)))

    def __len__(self) -> int:
        return len(self._ticks)

    def save(self, path: str) -> None:
        if not self._ticks:
            raise ValueError("nothing recorded")
        # Stack along a leading tick axis; flat key naming field.index.
        stacked_p = _stack([t.problem for t in self._ticks])
        stacked_s = _stack([t.solution for t in self._ticks])
        payload = {}
        for name, val in stacked_p._asdict().items():
            payload[f"problem.{name}"] = val
        payload["solution.states"] = stacked_s.states
        payload["solution.controls"] = stacked_s.controls
        for name, val in stacked_s.diagnostics._asdict().items():
            payload[f"diagnostics.{name}"] = val
        np.savez_compressed(path, **payload)


class ScenarioReplayer:
    """Loads a recording; iterates ticks; verifies determinism on demand."""

    def __init__(self, path: str):
        data = np.load(path)
        p_fields = {
            k.split(".", 1)[1]: data[k]
            for k in data.files
            if k.startswith("problem.")
        }
        d_fields = {
            k.split(".", 1)[1]: data[k]
            for k in data.files
            if k.startswith("diagnostics.")
        }
        self._problems = Problem(**p_fields)
        self._solutions = Solution(
            states=data["solution.states"],
            controls=data["solution.controls"],
            diagnostics=Diagnostics(**d_fields),
        )
        self.num_ticks = self._problems.initial_state.shape[0]

    def tick(self, i: int) -> TickRecord:
        return TickRecord(_take(self._problems, i), _take(self._solutions, i))

    def __iter__(self) -> Iterator[TickRecord]:
        for i in range(self.num_ticks):
            yield self.tick(i)

    def verify(self, solver, atol: float = 0.0, ticks: Optional[int] = None):
        """Re-solve every recorded Problem and compare controls.

        ``solver`` (`make_solver`'s closure, say) is handed each recorded
        Problem as CPU tensors and moves them where it solves.  Returns the
        max |u - u_recorded| over the verified ticks; on the same device
        and configuration it is exactly 0.
        """
        worst = 0.0
        n = self.num_ticks if ticks is None else min(ticks, self.num_ticks)
        for i in range(n):
            rec = self.tick(i)
            sol = solver(Problem(*(torch.from_numpy(x) for x in rec.problem)))
            err = float(np.max(np.abs(_to_numpy(sol.controls) - rec.solution.controls)))
            worst = max(worst, err)
            if err > atol:
                raise AssertionError(
                    f"tick {i}: replay mismatch {err:.3e} > {atol:.3e}"
                )
        return worst
