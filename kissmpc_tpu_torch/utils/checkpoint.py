"""Checkpoint / resume for batch-scenario runs (`torch.save`-backed).  Port
of `kissmpc_tpu/utils/checkpoint.py`.

Saves and restores a tree of tensors, typically a `FleetCheckpoint` of the
fleet's `EnvState`, its generator state, and the scenario cursor and tick.
A step is written as a flat dict of tensors (leaf index -> tensor), which
`torch.load(weights_only=True)` reads back; the tree is rebuilt from the
structure of an example (``like``), as orbax's ``StandardRestore(like)``
does.  Each rank of a data-parallel fleet saves its own shard in a
directory of its own.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from .._tree import leaves, unflatten

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class FleetCheckpoint(NamedTuple):
    """Everything needed to resume a batched receding-horizon run."""

    env_state: Any  # batched EnvState tree
    rng_key: torch.Tensor  # a torch.Generator's get_state()
    scenario_cursor: torch.Tensor  # int: next scenario index to dispatch
    tick: torch.Tensor  # int: global tick counter


def _restore_leaf(saved: torch.Tensor, like):
    """``saved`` in the form of ``like``'s leaf: a tensor on its device, a
    numpy array, or a Python number."""
    shape = tuple(np.shape(like))
    if tuple(saved.shape) != shape:
        raise ValueError(f"checkpoint leaf of shape {tuple(saved.shape)} restored into {shape}")
    if isinstance(like, torch.Tensor):
        if saved.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf of {saved.dtype} restored into {like.dtype}")
        return saved.to(like.device)
    if isinstance(like, np.ndarray):
        return saved.numpy()
    return saved.item()


class CheckpointManager:
    """Numbered steps in ``directory``, at most ``max_to_keep`` of them (the
    oldest go first).  A step is written to a temporary file and renamed
    into place, so a crash while saving leaves the earlier steps readable."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any) -> None:
        flat = {
            str(i): torch.as_tensor(x).detach().to("cpu", copy=True)
            for i, x in enumerate(leaves(state))
        }
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(flat, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self._steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a tree of the saved
        state's shape): each tensor goes to the device of ``like``'s tensor
        in its place; numpy and number leaves come back as such."""
        flat = torch.load(self._path(step), map_location="cpu", weights_only=True)
        like_leaves = leaves(like)
        if len(flat) != len(like_leaves):
            raise ValueError(
                f"step {step} holds {len(flat)} leaves, ``like`` has {len(like_leaves)}")
        return unflatten(like, [_restore_leaf(flat[str(i)], x)
                                for i, x in enumerate(like_leaves)])

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's
        interface."""
