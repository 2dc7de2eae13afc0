"""The data-parallel fleet solver over a one-rank NCCL group on the card,
against `solve_batch` on the same batch.

Marked ``cuda``: it skips without an NVIDIA GPU.  It imports neither JAX
nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

One rank holds the whole batch, so the fleet's solution must be
`solve_batch`'s bit for bit, and its metrics those of the call's own
diagnostics (a SUM and a MAX over one rank change nothing).
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from kissmpc_tpu_torch import MPCConfig, solve_batch
from kissmpc_tpu_torch.parallel import fleet, multihost
from kissmpc_tpu_torch.scenarios import obstacle_problems


@pytest.fixture
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield fleet.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_fleet_solver_bitwise_equals_solve_batch(nccl_rank):
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    problems = obstacle_problems(cfg, 512, seed=0, n_dynamic=2)
    count = fleet.fleet_metrics.collectives
    sol, metrics = fleet.make_fleet_solver(cfg, nccl_rank)(problems)
    assert fleet.fleet_metrics.collectives - count == 2
    ref = solve_batch(cfg, problems)
    for a, b in zip((sol.states, sol.controls, *sol.diagnostics),
                    (ref.states, ref.controls, *ref.diagnostics)):
        assert torch.equal(a, b)
    d = ref.diagnostics
    assert torch.equal(metrics.converged_fraction, d.converged.float().mean())
    assert torch.equal(metrics.max_kkt_stationarity, d.kkt_stationarity.amax())
    assert torch.equal(metrics.max_kkt_feasibility, d.kkt_feasibility.amax())
    assert torch.equal(metrics.mean_cost, d.final_cost.mean())
    assert multihost.health_check(nccl_rank, timeout_s=60.0)
