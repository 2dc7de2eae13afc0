"""What the traffic drivers share: the run's context and the build of an
`MPCConfig` from a configuration's file, for the port and the reference
alike (the reference's config module is a frozen copy of the port's)."""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

# A solve a robot cannot move on (PERF.md §2's usable test).
UNUSABLE_FEASIBILITY = 1e-2
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


class Context(NamedTuple):
    cell: dict
    config: dict
    seed: int
    device: str
    log: Callable[[str], None]


def mpc_config(config_module, config: dict):
    """The `MPCConfig` a configuration's file states, from ``config_module``
    (`kissmpc_tpu_torch.config` or `benchmark.reference.config`)."""
    cfg = config_module.MPCConfig(horizon=config["horizon"], time_step=config["time_step"],
                                  max_obstacles=config["max_obstacles"])
    solver = dict(config.get("solver", {}))
    if "refine_stages" in solver:
        solver["refine_stages"] = tuple(tuple(s) for s in solver["refine_stages"])
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **solver))


def torch_seed(seed: int) -> int:
    """A seed `torch.Generator.manual_seed` takes, from any whole number."""
    return seed % (2 ** 63)


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()
