"""The frozen operation counts equal `chip_smoke.py`'s at the shapes of
PERF.md §6 (N=50, B=8192 and the refine batches; free, K=8, elastic)."""

import dataclasses
import sys
from pathlib import Path

import pytest

from benchmark import counts

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from kissmpc_tpu_torch import MPCConfig  # noqa: E402


@pytest.mark.parametrize("k,elastic", [(0, False), (8, False), (8, True)])
def test_operations_per_iteration_and_once(k, elastic):
    for n in (7, 50, 805, 1036):
        assert counts.fused_ops_per_iteration(n, k, 2, elastic) == \
            chip_smoke.fused_ops_per_iteration(n, k, 2, elastic)
        assert counts.fused_ops_once(n, k, elastic) == chip_smoke.fused_ops_once(n, k, elastic)


@pytest.mark.parametrize("batch,iterations", [(8192, 32), (1024, 64), (410, 64), (328, 96),
                                              (164, 96), (164, 128), (4096, 32), (64, 3)])
@pytest.mark.parametrize("k,elastic", [(0, False), (8, False), (8, True)])
def test_bounds(batch, iterations, k, elastic):
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=k)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, elastic_obstacles=elastic))
    ours = counts.fused_bound(50, k, cfg.solver.ls_iters, batch, iterations, elastic)
    theirs = chip_smoke.fused_bound(cfg, batch, iterations)
    assert ours[1:] == theirs[1:]
    assert ours[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)


def test_recorded_counts():
    """PERF.md §6 row 2's operation counts at B=8192 x 32 iterations."""
    free = counts.fused_bound(50, 0, 2, 8192, 32)
    k8 = counts.fused_bound(50, 8, 2, 8192, 32)
    assert free[3] == 17_912_774_656 and k8[3] == 45_368_819_712
    assert free[1] == k8[1] == "operations"


def test_stage_shapes():
    assert counts.stage_shapes(8192, 32, ((0.125, 64, 0.2), (0.02, 96, 0.7))) == [
        (8192, 32, None), (1024, 64, 0.2), (164, 96, 0.7)]
