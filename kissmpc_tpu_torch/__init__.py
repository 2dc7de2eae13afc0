"""kissmpc_tpu_torch — the PyTorch/CUDA port of the batched MPC engine.

A second package beside `kissmpc_tpu` (the JAX reference it is held
against), for an NVIDIA H100.  Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels under `csrc/`.  It imports
neither `jax` nor `kissmpc_tpu`.

Ported so far: config, models, obstacles (with `advance`), problem
builders, the plain and CUDA Riccati solves, the batched IPM (Mehrotra
"pc"/"soc" and elastic obstacles included), the fused IPM kernel (with its
elastic branch), the trip-count probe, `solve_batch` with both backends
("fused", the default, and "split"), `make_solver`, the receding-horizon
agent and the episode loop (`environment.step`, `fleet_step`,
`run_episode`), the benchmark scenario pools, the batched grid planner
(`planner.py`), the episode and lab-map worlds (`scenarios.episode_worlds`
with either router, `scenarios.lab_worlds`), the map tools
(`obstacles.mapping` and the g++-built `native` library), perception
(`perception/`), the ROS-facing I/O layer (`io/`), the data-parallel fleet
over `torch.distributed` (`parallel/`), `utils/` (metrics, profiling,
checkpoints), the command line (`cli.py`), the associative-scan LQR
(`ops/lqr_pt.py`), and the numpy bridge.  Every public entry point takes ``device=None``, which means
``"cuda"``; pass ``device="cpu"`` to run on the CPU.
"""

from . import agent, bridge, environment, scenarios
from .agent import AgentParams, AgentState
from .config import CostConfig, MPCConfig, SolverConfig
from .environment import EnvState, StepInfo
from .obstacles import ObstacleSet, dynamic_set, static_set
from .solver.api import make_batch_solver, make_solver, solve_batch
from .solver.problem import (
    Diagnostics,
    Problem,
    Solution,
    complete_warm_start,
    default_problem,
    problem_with_obstacles,
    repair_warm_start,
)

__version__ = "0.1.0"

__all__ = [
    "CostConfig",
    "MPCConfig",
    "SolverConfig",
    "ObstacleSet",
    "dynamic_set",
    "static_set",
    "Problem",
    "Solution",
    "Diagnostics",
    "default_problem",
    "problem_with_obstacles",
    "repair_warm_start",
    "complete_warm_start",
    "make_batch_solver",
    "make_solver",
    "solve_batch",
    "AgentParams",
    "AgentState",
    "EnvState",
    "StepInfo",
    "agent",
    "environment",
    "bridge",
    "scenarios",
]
