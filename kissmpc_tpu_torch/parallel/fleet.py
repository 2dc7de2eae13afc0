"""Fleet-scale batched planning, data-parallel over `torch.distributed`.
Port of `kissmpc_tpu/parallel/fleet.py`.

The reference shards the scenario batch over a JAX mesh with `shard_map`.
Here each rank of a process group holds its own shard of the batch, a plain
`Problem` on its device, and runs the port's `solve_batch` (or
`fleet_step`) on it unchanged: scenarios are independent, so the only
traffic between ranks is the metric reduction, two `all_reduce`s per call
(one SUM of the two means, one MAX of the two maxima).  Every collective a
fleet call issues is counted in ``fleet_metrics.collectives``.

On the card each rank's fleet call, the shard's solve or tick and the two
`all_reduce`s, is one CUDA graph per input signature (`solver/graph.py`),
as the reference jits its `shard_map`: ProcessGroupNCCL's collectives are
captured into the graph with the work around them, and every replay moves
``fleet_metrics.collectives`` by the 2 it captured.  With gloo on the CPU,
where the tests run it in one process and in two, the call is eager.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import environment as env_mod
from .._device import resolve_device
from .._tree import leaves, tree_map, unflatten
from ..config import MPCConfig
from ..solver import graph
from ..solver.api import solve_batch
from ..solver.problem import Diagnostics, Problem

AxisName = Union[str, Sequence[str]]


class FleetMetrics(NamedTuple):
    """Replicated (group-wide) summary statistics, reduced across ranks."""

    converged_fraction: torch.Tensor  # scalar float32 in [0, 1]
    max_kkt_stationarity: torch.Tensor
    max_kkt_feasibility: torch.Tensor
    mean_cost: torch.Tensor


def require_group() -> None:
    """Raise unless a default process group is initialized (the mesh
    constructors would otherwise start one from the environment)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group (or "
            "parallel.multihost.initialize_distributed) first")


def make_mesh(device_type=None, axis_name: str = "data") -> DeviceMesh:
    """1-D mesh over every rank of the initialized group.  ``device_type``
    None means "cuda" (raising without CUDA); "cpu" for gloo on the CPU."""
    require_group()
    dev = resolve_device(device_type)
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def mesh_group(mesh: DeviceMesh, axis_name: AxisName = "data"):
    """The process group of this rank along ``axis_name``: one of the
    mesh's dimension names, or a tuple of all of them, reduced over as one
    flattened group (as JAX reduces over ``("host", "chip")``); the meshes
    of `make_mesh` and `multihost.make_pod_mesh` span every rank, so that
    group is the world's."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    dims = mesh.mesh_dim_names or ()
    if len(names) == 1 and names[0] in dims:
        return mesh.get_group(names[0])
    if sorted(names) == sorted(dims) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError(f"axis {axis_name!r} is neither one of the mesh's dimensions {dims} "
                     "nor all of them over every rank")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return resolve_device(torch.device("cuda", torch.cuda.current_device()))
    return torch.device(mesh.device_type)


def fleet_metrics(diagnostics: Diagnostics, group=None) -> FleetMetrics:
    """This rank's diagnostics reduced over ``group``: the two means are
    summed in one all_reduce and divided by the group size (what `pmean`
    of equal shards gives), the two maxima taken in another."""
    d = diagnostics
    conv = d.converged.to(torch.float32).mean()
    cost = d.final_cost.mean()
    wide = torch.promote_types(conv.dtype, cost.dtype)  # exact for both
    means = torch.stack([conv.to(wide), cost.to(wide)])
    maxima = torch.stack([d.kkt_stationarity.amax(), d.kkt_feasibility.amax()])
    dist.all_reduce(means, op=dist.ReduceOp.SUM, group=group)
    fleet_metrics.collectives += 1
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    fleet_metrics.collectives += 1
    means = means / dist.get_world_size(group)
    return FleetMetrics(
        converged_fraction=means[0].to(torch.float32),
        max_kkt_stationarity=maxima[0],
        max_kkt_feasibility=maxima[1],
        mean_cost=means[1].to(cost.dtype),
    )


graph.counter(fleet_metrics, "collectives")


def make_fleet_solver(cfg: MPCConfig, mesh: DeviceMesh, axis_name: AxisName = "data"):
    """Data-parallel solver: this rank's Problem[b, ...] -> (its
    Solution[b, ...], FleetMetrics replicated over the ``axis_name`` group).

    The global batch is the ranks' shards in rank order (`shard_problems`);
    every rank calls the solver once per step, as every device runs the
    reference's `shard_map` body.
    """
    group = mesh_group(mesh, axis_name)
    device = mesh_device(mesh)

    def program(*tensors):
        sol = solve_batch(cfg, Problem(*tensors), device=device)
        return sol, fleet_metrics(sol.diagnostics, group)

    def fleet(problems: Problem):
        return graph.run(("make_fleet_solver", cfg, group), program, device, *problems)

    return fleet


def make_fleet_env_stepper(cfg: MPCConfig, params, mesh: DeviceMesh,
                           axis_name: AxisName = "data"):
    """Data-parallel episode tick: this rank's (EnvState[b],
    ObstacleSet[b]) -> (EnvState[b], StepInfo[b], FleetMetrics).

    Each rank runs `environment.fleet_step` on its own episodes; the
    metrics are reduced over the ``axis_name`` group.
    """
    group = mesh_group(mesh, axis_name)
    device = mesh_device(mesh)

    def step(env, obstacles=None):
        like = (env, obstacles)

        def program(*tensors):
            new_env, info = env_mod.fleet_step(cfg, params, *unflatten(like, tensors),
                                               device=device)
            return new_env, info, fleet_metrics(info.diagnostics, group)

        key = ("make_fleet_env_stepper", cfg, params, group, obstacles is None)
        return graph.run(key, program, device, *leaves(like))

    return step


def shard_problems(problems, mesh: DeviceMesh, axis_name: AxisName = "data"):
    """This rank's slice of a global batch (any tree of tensors with the
    batch leading, such as a Problem), moved to its device.  The slices go
    to the ranks of the ``axis_name`` group in rank order; the batch must
    divide by the group's size."""
    group = mesh_group(mesh, axis_name)
    size, index = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    device = mesh_device(mesh)

    def local(x):
        B = x.shape[0]
        if B % size:
            raise ValueError(f"batch {B} does not divide over {size} ranks")
        b = B // size
        return x[index * b:(index + 1) * b].to(device)

    return tree_map(local, problems)
