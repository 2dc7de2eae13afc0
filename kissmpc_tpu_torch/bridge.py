"""The state carried across the two packages, as numpy arrays.

The MPC has no weights: a `Problem` batch is the state both packages must be
handed identically.  `problem_from_numpy` takes a mapping of `Problem` field
names to numpy arrays (what ``{k: np.asarray(v) for k, v in
jax_problem._asdict().items()}`` gives for a batched JAX Problem);
`solution_to_numpy` turns a port `Solution` back into numpy arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .solver.problem import Diagnostics, Problem, Solution


def problem_from_numpy(arrays: Mapping[str, np.ndarray], *, device=None,
                       dtype=None) -> Problem:
    """Problem of tensors from numpy arrays; ``dtype=None`` keeps theirs."""
    missing = set(Problem._fields) - set(arrays)
    if missing:
        raise KeyError(f"Problem fields missing: {sorted(missing)}")
    dev = resolve_device(device)
    return Problem(
        **{
            name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)
            for name in Problem._fields
        }
    )


def solution_to_numpy(sol: Solution) -> Solution:
    """The same Solution with every tensor copied to a numpy array."""
    cpu = lambda x: x.detach().cpu().numpy()
    return Solution(
        states=cpu(sol.states),
        controls=cpu(sol.controls),
        diagnostics=Diagnostics(*(cpu(x) for x in sol.diagnostics)),
    )
