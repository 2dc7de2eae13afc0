"""The fused IPM kernel (hard and elastic obstacles) and the trip-count
probe against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (the kernels have no CPU
mode).  They import neither JAX nor the JAX package, so on a machine with a
card and no JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_ipm_fused_cuda.py

Tolerances are those of `chip_smoke.py`: at one iteration the kernel and
the plain version agree within 1e-4 of the solution's scale plus twice the
plain version's own f32-vs-f64 gap; over a full solve their converged flags
agree on all but 1% of the scenarios and 95% of the scenarios converged on
both agree within the f32 budget of tests/test_ipm_fused.py (controls 1e-3
without obstacles, 2e-3 with them).
"""

import dataclasses

import pytest
import torch

from kissmpc_tpu_torch import MPCConfig
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
from kissmpc_tpu_torch.ops.probe import dynamic_trip, dynamic_trip_plain
from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
from kissmpc_tpu_torch.solver.problem import Problem

B, N = 64, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _case(K, elastic=False):
    cfg = MPCConfig(horizon=N, time_step=0.1, max_obstacles=K)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, mu_sigma_max=0.7 if K else 0.0,
        fused_affine_tracks=K > 0, elastic_obstacles=elastic))
    if K:
        return cfg, obstacle_problems(cfg, B, seed=5, n_dynamic=1, device="cuda")
    return cfg, free_problems(cfg, B, seed=5, device="cuda")


def _gap(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in ((a.states, b.states), (a.controls, b.controls)))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 2])
def test_fused_kernel_matches_plain_one_iteration(cuda, K):
    cfg, pr = _case(K)
    before = solve_batch_fused.launches
    got = solve_batch_fused(cfg, pr, iterations=1)
    torch.cuda.synchronize()
    assert solve_batch_fused.launches == before + 1
    ref = solve_batch_fused_plain(cfg, pr, iterations=1)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)), iterations=1)
    scale = max(1.0, float(ref.states.abs().max()), float(ref.controls.abs().max()))
    assert _gap(got, ref) <= 1e-4 * scale + 2.0 * _gap(ref, ref64)


@pytest.mark.cuda
@pytest.mark.parametrize("K,tol", [(0, 1e-3), (2, 2e-3)])
def test_fused_kernel_matches_plain_full_solve(cuda, K, tol):
    cfg, pr = _case(K)
    got = solve_batch_fused(cfg, pr)
    ref = solve_batch_fused_plain(cfg, pr)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.states).all())
    c_k, c_p = got.diagnostics.converged, ref.diagnostics.converged
    assert int((c_k != c_p).sum()) <= max(1, B // 100)
    both = c_k & c_p
    assert int(both.sum()) >= B // 2
    diff = (got.controls - ref.controls).abs().flatten(1).amax(dim=1)
    assert float((diff[both] <= tol).float().mean()) >= 0.95


@pytest.mark.cuda
def test_fused_elastic_kernel_matches_plain_one_iteration(cuda):
    """The elastic branch (K=2 with elastic_obstacles), as above."""
    cfg, pr = _case(2, elastic=True)
    got = solve_batch_fused(cfg, pr, iterations=1)
    ref = solve_batch_fused_plain(cfg, pr, iterations=1)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)), iterations=1)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.states.abs().max()), float(ref.controls.abs().max()))
    assert _gap(got, ref) <= 1e-4 * scale + 2.0 * _gap(ref, ref64)


@pytest.mark.cuda
def test_fused_elastic_kernel_matches_plain_full_solve(cuda):
    cfg, pr = _case(2, elastic=True)
    got = solve_batch_fused(cfg, pr)
    ref = solve_batch_fused_plain(cfg, pr)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.states).all())
    c_k, c_p = got.diagnostics.converged, ref.diagnostics.converged
    assert int((c_k != c_p).sum()) <= max(1, B // 100)
    both = c_k & c_p
    assert int(both.sum()) >= B // 2
    diff = (got.controls - ref.controls).abs().flatten(1).amax(dim=1)
    assert float((diff[both] <= 2e-3).float().mean()) >= 0.95
    # The elastic branch changes the solve: it is not the hard kernel.
    hard_cfg, _ = _case(2)
    hard = solve_batch_fused(hard_cfg, pr)
    assert not torch.equal(hard.controls, got.controls)


@pytest.mark.cuda
def test_fused_kernel_rejects_what_it_does_not_take(cuda):
    cfg, pr = _case(2)
    with pytest.raises(TypeError):
        solve_batch_fused(cfg, Problem(*(x.double() for x in pr)))
    with pytest.raises(TypeError):
        solve_batch_fused(cfg, pr._replace(warm_controls=pr.warm_controls.cpu()))
    with pytest.raises(ValueError):
        solve_batch_fused(cfg, pr._replace(
            warm_states=pr.warm_states.transpose(0, 1).contiguous().transpose(0, 1)))


@pytest.mark.cuda
def test_probe_kernel_reads_its_trip_count(cuda):
    x = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    for trips in (7, 31):
        iters = torch.tensor([trips], dtype=torch.int32, device="cuda")
        before = dynamic_trip.launches
        got = dynamic_trip(x, iters)
        torch.cuda.synchronize()
        assert dynamic_trip.launches == before + 1
        assert torch.equal(got, torch.full_like(x, float(trips)))
        assert torch.equal(got, dynamic_trip_plain(x, iters))
    with pytest.raises(TypeError):
        dynamic_trip(x, iters.cpu())
