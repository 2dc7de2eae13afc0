"""The state carried across the two packages, as numpy arrays.

The MPC has no weights: a `Problem` batch, an episode `EnvState` and an
`ObstacleSet` are the state both packages must be handed identically.
`problem_from_numpy` takes a mapping of `Problem` field names to numpy
arrays (what ``{k: np.asarray(v) for k, v in
jax_problem._asdict().items()}`` gives for a batched JAX Problem);
`env_from_numpy` and `obstacles_from_numpy` take a batched JAX `EnvState` /
`ObstacleSet`, or the same named tuple with numpy leaves, by field name; `solution_to_numpy` turns a port `Solution` back into numpy
arrays.

Perception carries state too: `geometry_from_numpy` takes a
`FrameGeometry` (camera intrinsics and the two rigid transforms),
`perception_state_from_numpy` a `PerceptionState` or `TrackTable` with
array leaves (batched or not), and `segnet_from_numpy` a `TinySegNet`
``state_dict`` as numpy arrays, so that both packages get the same tracks
and the same network weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .agent import AgentState
from .environment import EnvState
from .obstacles import ObstacleSet
from .perception.pipeline import FrameGeometry, PerceptionState
from .perception.projection import SE3, Intrinsics
from .perception.segnet import TinySegNet
from .perception.tracker import TrackTable
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


def obstacles_from_numpy(obstacles, *, device=None, dtype=None) -> ObstacleSet:
    """ObstacleSet of tensors from one with array leaves ([B, K] batched or
    [K]); ``dtype=None`` keeps theirs."""
    dev = resolve_device(device)
    return ObstacleSet(**{
        name: torch.tensor(np.asarray(getattr(obstacles, name)), dtype=dtype, device=dev)
        for name in ObstacleSet._fields
    })


def env_from_numpy(env, *, device=None, dtype=None) -> EnvState:
    """Batched EnvState of tensors from one with array leaves (its ``agent``
    an AgentState of arrays); float leaves take ``dtype`` (None keeps
    theirs), the waypoint index and stall counter become int64."""
    dev = resolve_device(device)
    flt = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=dev)
    idx = lambda x: torch.tensor(np.asarray(x), dtype=torch.int64, device=dev)
    return EnvState(
        agent=AgentState(**{name: flt(getattr(env.agent, name)) for name in AgentState._fields}),
        waypoint_index=idx(env.waypoint_index),
        waypoints=flt(env.waypoints),
        stall_ticks=idx(env.stall_ticks),
    )


def solution_to_numpy(sol: Solution) -> Solution:
    """The same Solution with every tensor copied to a numpy array."""
    cpu = lambda x: x.detach().cpu().numpy()
    return Solution(
        states=cpu(sol.states),
        controls=cpu(sol.controls),
        diagnostics=Diagnostics(*(cpu(x) for x in sol.diagnostics)),
    )


def geometry_from_numpy(geom, *, device=None) -> FrameGeometry:
    """FrameGeometry of tensors from one with array (or scalar) leaves; every
    leaf keeps its dtype (a recorded session's intrinsics are float64)."""
    dev = resolve_device(device)
    t = lambda x: torch.tensor(np.asarray(x), device=dev)  # noqa: E731
    return FrameGeometry(
        intrinsics=Intrinsics(*(t(x) for x in geom.intrinsics)),
        lidar_to_camera=SE3(*(t(x) for x in geom.lidar_to_camera)),
        lidar_to_map=SE3(*(t(x) for x in geom.lidar_to_map)),
        image_width=int(geom.image_width),
        image_height=int(geom.image_height),
    )


def perception_state_from_numpy(state, *, device=None) -> PerceptionState:
    """PerceptionState of tensors from a PerceptionState or a TrackTable with
    array leaves, batched ([B]-leading) or not; positions and velocities
    keep their dtype, the counters become int32 and ``active`` bool."""
    dev = resolve_device(device)
    tracks = getattr(state, "tracks", state)
    ints = ("age", "misses", "hits", "next_id", "track_id")
    leaf = lambda name: torch.tensor(  # noqa: E731
        np.asarray(getattr(tracks, name)),
        dtype=torch.int32 if name in ints else torch.bool if name == "active" else None,
        device=dev)
    return PerceptionState(tracks=TrackTable(**{name: leaf(name) for name in TrackTable._fields}))


def segnet_from_numpy(state_dict: Mapping[str, np.ndarray], *, device=None,
                      **kwargs) -> TinySegNet:
    """The port's TinySegNet (constructed with ``kwargs``) holding the given
    weights, on ``device``."""
    dev = resolve_device(device)
    net = TinySegNet(**kwargs)
    net.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()})
    return net.to(dev)
