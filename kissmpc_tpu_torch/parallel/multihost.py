"""Multi-host support: process-group init, 2-D meshes, local batches,
failure detection.  Port of `kissmpc_tpu/parallel/multihost.py`.

In torch a rank is one process driving one device (where a JAX process
drives all of its host's chips), so a pod of H hosts with C cards each is
H * C ranks:

 * mesh axes ("host", "chip"): ranks grouped by host, `LOCAL_WORLD_SIZE`
   (set by `torchrun`) ranks per host; the fleet's reductions run over both
   axes as one group (`fleet.mesh_group(mesh, ("host", "chip"))`);
 * scenario dispatch: each rank feeds only its own shard, so scenario IO
   never crosses ranks; the global batch is the shards in rank order;
 * failure detection: an all-reduce heartbeat with a timeout.

A single process degenerates cleanly: `initialize_distributed` does
nothing, and one rank's mesh is (1, 1).
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Shard

from .._device import resolve_device
from .._tree import leaves, tree_map
from .fleet import mesh_device, mesh_group, require_group

DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """`torch.distributed.init_process_group` for ``num_processes`` ranks
    (a no-op for one process).  ``coordinator_address`` is rank 0's
    "host:port" (any URL with "://", such as "file://...", is used as it
    is).  ``device`` None means the card: NCCL, raising without CUDA;
    "cpu" takes gloo.  A collective that waits longer than ``timeout_s``
    fails."""
    dev = resolve_device(device)
    if not (num_processes is not None and num_processes > 1 or coordinator_address is not None):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process group needs coordinator_address, num_processes "
                         "and process_id")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_pod_mesh(ranks_per_host: Optional[int] = None, device_type=None) -> DeviceMesh:
    """2-D ("host", "chip") mesh over every rank, ``ranks_per_host`` ranks
    per host (default: `LOCAL_WORLD_SIZE`, else all ranks on one host).
    ``device_type`` None means "cuda"; "cpu" for gloo on the CPU."""
    require_group()
    dev = resolve_device(device_type)
    world = dist.get_world_size()
    per_host = ranks_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    return init_device_mesh(dev.type, (world // per_host, per_host),
                            mesh_dim_names=("host", "chip"))


def batch_sharding(mesh: DeviceMesh) -> list:
    """The DTensor placements of a scenario batch sharded over every mesh
    axis (its leading dimension): ``DTensor.from_local(shard, mesh,
    batch_sharding(mesh))`` views the ranks' shards as the global batch."""
    return [Shard(0)] * mesh.ndim


def distribute_local_batch(mesh: DeviceMesh, local):
    """This rank's own scenarios (a tree of tensors or arrays, batch
    leading) on its device, as its shard of the global batch: the shards of
    every rank of ``mesh`` in rank order.  One `all_gather` of the shard
    sizes first checks that they are equal, as the fleet's means assume."""
    device = mesh_device(mesh)
    group = mesh_group(mesh, tuple(mesh.mesh_dim_names))
    moved = tree_map(lambda x: torch.as_tensor(x).to(device), local)
    batches = {int(x.shape[0]) for x in leaves(moved)}
    if len(batches) != 1:
        raise ValueError(f"the shard's leaves differ in batch size: {sorted(batches)}")
    size = torch.tensor([batches.pop()], dtype=torch.int64, device=device)
    gathered = [torch.empty_like(size) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, size, group=group)
    counts = [int(x) for x in gathered]
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks' shards differ in size: {counts}")
    return moved


def health_check(mesh: DeviceMesh, timeout_s: float = 10.0) -> bool:
    """One all-reduce heartbeat over the full mesh; True iff every rank
    contributed its one within ``timeout_s``.

    A crashed or hung peer makes the collective *block* (NCCL, and gloo
    until its timeout) or *raise* (gloo, when the peer's connection drops),
    so the reduction runs on a daemon thread and the caller waits at most
    ``timeout_s``: timeout, exception, or a wrong total all report
    unhealthy.  (The orphaned thread stays parked on the dead collective;
    callers should treat False as fatal for this process group and recover
    by restarting from a checkpoint, see the fault drill in
    tests/test_torch_parallel.py.  Because each failed check leaks one
    parked daemon thread, do NOT poll this in a supervisor retry loop:
    bound retries to a handful, then escalate to a process-level restart;
    the orphaned threads die with the process.)
    """
    device = mesh_device(mesh)
    group = mesh_group(mesh, tuple(mesh.mesh_dim_names))
    ones = torch.ones(1, dtype=torch.float32, device=device)
    result = {}

    def _beat():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.all_reduce(ones, op=dist.ReduceOp.SUM, group=group)
            result["total"] = float(ones.item())
        except Exception as e:  # a dead peer may surface as an error
            result["error"] = e

    t = threading.Thread(target=_beat, daemon=True, name="health_check")
    t.start()
    t.join(timeout_s)
    if t.is_alive() or "error" in result or "total" not in result:
        return False
    return result["total"] == mesh.size()
