"""The fused IPM kernel (hard and elastic obstacles) and the trip-count
probe against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (the kernels have no CPU
mode).  They import neither JAX nor the JAX package, so on a machine with a
card and no JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_ipm_fused_cuda.py

The one-iteration cases cover N = 12 and 50, K = 0, 2 and 8, affine and
tabulated tracks, both branches, and batches that are ragged against the
kernel's warps per block (37, 164): the kernel and the plain version agree
within 1e-4 of the solution's scale plus twice the plain version's own
f32-vs-f64 gap.  The full solves run at N = 12: their converged flags
differ on at most 1% of the scenarios (at least one), and 95% of the
scenarios converged on both agree within the f32 budget of
tests/test_ipm_fused.py (controls 1e-3 without obstacles, 2e-3 with
them).  Full solves at N = 50 are `chip_smoke.py` phase 4's, at B = 8192
and at the refine stage's B = 164, with its flag noise floor: at a batch of
a few hundred, round-off alone changes a few flags (PERF.md).  At the
longest horizon (one warp per block) the kernel holds to the one-iteration
gate after 3 iterations, and one step more is refused before any launch.

Widths (warps per scenario): the batches above take 4 warps per scenario
on the card, where its resident one-scenario blocks hold the whole batch.
Batches solved alone at either width the card gives them (164, 512 and the
most its resident blocks hold: 4; 1,024: 1) return the bits they get inside
a batch of 8,192 at one warp per scenario, hard and elastic, and a
replayed fleet solve (8,192, then 1,024 and 164) moves the wide launches'
counter by one of its three launches.
"""

import dataclasses

import pytest
import torch

from kissmpc_tpu_torch import MPCConfig
from kissmpc_tpu_torch.ops import ipm_fused
from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused, solve_batch_fused_plain
from kissmpc_tpu_torch.ops.probe import dynamic_trip, dynamic_trip_plain
from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
from kissmpc_tpu_torch.solver.api import make_batch_solver
from kissmpc_tpu_torch.solver.problem import Problem, gather

B, N = 64, 12

# (N, K, affine tracks, batch) of the one-iteration cases, each run hard
# and, with obstacles, elastic.
ONE_ITERATION = [(n, 0, False, b) for n in (12, 50) for b in (37, 164)] + [
    (n, k, affine, b) for n in (12, 50) for k in (2, 8) for affine in (True, False)
    for b in (37, 164)
]
# (K, affine tracks, batch, elastic) of the full-solve cases, at N = 12.
FULL_SOLVE = [(0, False, B, False), (2, True, B, False), (8, False, 37, False),
              (2, True, B, True), (8, False, 37, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _case(K, elastic=False, n=N, batch=B, affine=None):
    cfg = MPCConfig(horizon=n, time_step=0.1 if n < 20 else 0.041, max_obstacles=K)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, mu_sigma_max=0.7 if K else 0.0,
        fused_affine_tracks=K > 0 if affine is None else affine, elastic_obstacles=elastic))
    if K:
        return cfg, obstacle_problems(cfg, batch, seed=5, n_dynamic=1, device="cuda")
    return cfg, free_problems(cfg, batch, seed=5, device="cuda")


def _gap(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in ((a.states, b.states), (a.controls, b.controls)))


def _check_one_iteration(cfg, pr, iterations=1):
    before = solve_batch_fused.launches
    got = solve_batch_fused(cfg, pr, iterations=iterations)
    torch.cuda.synchronize()
    assert solve_batch_fused.launches == before + 1
    ref = solve_batch_fused_plain(cfg, pr, iterations=iterations)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)),
                                    iterations=iterations)
    scale = max(1.0, float(ref.states.abs().max()), float(ref.controls.abs().max()))
    assert bool(torch.isfinite(got.states).all() and torch.isfinite(got.controls).all())
    assert _gap(got, ref) <= 1e-4 * scale + 2.0 * _gap(ref, ref64)


def _check_full_solve(cfg, pr, tol):
    got = solve_batch_fused(cfg, pr)
    ref = solve_batch_fused_plain(cfg, pr)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.states).all())
    c_k, c_p = got.diagnostics.converged, ref.diagnostics.converged
    batch = c_p.shape[0]
    assert int((c_k != c_p).sum()) <= max(1, batch // 100)
    both = c_k & c_p
    assert int(both.sum()) >= batch // 2
    diff = (got.controls - ref.controls).abs().flatten(1).amax(dim=1)
    assert float((diff[both] <= tol).float().mean()) >= 0.95
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,affine,batch", ONE_ITERATION)
def test_fused_kernel_matches_plain_one_iteration(cuda, n, K, affine, batch):
    _check_one_iteration(*_case(K, n=n, batch=batch, affine=affine))


@pytest.mark.cuda
@pytest.mark.parametrize("K,affine,batch,elastic", [c for c in FULL_SOLVE if not c[3]])
def test_fused_kernel_matches_plain_full_solve(cuda, K, affine, batch, elastic):
    cfg, pr = _case(K, batch=batch, affine=affine)
    _check_full_solve(cfg, pr, 2e-3 if K else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,affine,batch", [c for c in ONE_ITERATION if c[1]])
def test_fused_elastic_kernel_matches_plain_one_iteration(cuda, n, K, affine, batch):
    """The elastic branch (elastic_obstacles), as above."""
    _check_one_iteration(*_case(K, elastic=True, n=n, batch=batch, affine=affine))


@pytest.mark.cuda
@pytest.mark.parametrize("K,affine,batch,elastic", [c for c in FULL_SOLVE if c[3]])
def test_fused_elastic_kernel_matches_plain_full_solve(cuda, K, affine, batch, elastic):
    cfg, pr = _case(K, elastic=True, batch=batch, affine=affine)
    got = _check_full_solve(cfg, pr, 2e-3)
    # The elastic branch changes the solve: it is not the hard kernel.
    hard_cfg, _ = _case(K, batch=batch, affine=affine)
    hard = solve_batch_fused(hard_cfg, pr)
    assert not torch.equal(hard.controls, got.controls)


@pytest.mark.cuda
@pytest.mark.parametrize("K,elastic", [(0, False), (8, False), (8, True)])
def test_fused_kernel_same_scenario_in_every_slot(cuda, K, elastic):
    """One scenario in each of 1,101 slots at one warp per scenario (every
    lane, warp and block position, a ragged last block) and of 300 slots
    at 4 warps per scenario (every block of a batch the SMs hold at once):
    every output bitwise equal, and equal across the two widths."""
    cfg, pr = _case(K, elastic=elastic, n=50, batch=1)
    outputs = []
    for batch, width in ((1101, 1), (300, 4)):
        assert ipm_fused.occupancy(cfg, batch)["width"] == width
        many = Problem(*(x.expand(batch, *x.shape[1:]).contiguous() for x in pr))
        sol = solve_batch_fused(cfg, many)
        torch.cuda.synchronize()
        for x in (sol.states, sol.controls, *sol.diagnostics):
            assert torch.equal(x, x[:1].expand_as(x)), "output depends on the slot"
        outputs.append([x[:1] for x in (sol.states, sol.controls, *sol.diagnostics)])
    assert all(torch.equal(a, b) for a, b in zip(*outputs)), "output depends on the width"


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 8])
def test_fused_kernel_at_its_longest_horizon(cuda, K):
    """At ``max_horizon(cfg)`` (one warp per block) the kernel holds to the
    one-iteration gate after 3 iterations, B=64; one step more raises
    ValueError before any launch."""
    cfg, _ = _case(K, n=50)
    N = ipm_fused.max_horizon(cfg)
    cfg, pr = _case(K, n=N)
    occ = ipm_fused.occupancy(cfg, 64)
    assert (occ["width"], occ["warps_per_block"]) == (1, 1)
    _check_one_iteration(cfg, pr, iterations=3)
    cfg, pr = _case(K, n=N + 1, batch=2)
    before = solve_batch_fused.launches
    with pytest.raises(ValueError, match="split"):
        solve_batch_fused(cfg, pr, iterations=1)
    assert solve_batch_fused.launches == before


def _fleet(elastic=False):
    """The fleet solve's configuration (N=50, dt 0.041, K=8 with affine
    tracks; 32 iterations, then 12.5% of the batch for 64 at sigma 0.2 and
    2% for 96 at 0.7) and 8,192 of its scenarios, two obstacles moving."""
    cfg = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32, refine_stages=((0.125, 64, 0.2), (0.02, 96, 0.7)),
        mu_sigma_max=0.7, fused_affine_tracks=True, elastic_obstacles=elastic))
    return cfg, obstacle_problems(cfg, 8192, seed=7, n_dynamic=2, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,iterations,mu_sigma,width", [
    (164, 96, 0.7, 4), (512, 64, 0.2, 4), ("most", 64, 0.2, 4), (1024, 64, 0.2, 1)])
@pytest.mark.parametrize("elastic", [False, True], ids=["hard", "elastic"])
def test_fused_wide_instance_returns_the_bits_of_one_warp(cuda, elastic, batch, iterations,
                                                          mu_sigma, width):
    """A refine stage's scenarios solved alone (the solve's 1,024 and 164,
    the fleet tick's 512, and the most that the card's resident blocks of 4
    warps hold, its SMs times their blocks) and inside a batch of 8,192 (one
    warp per scenario), the stage's iterations and sigma: every output of
    every scenario bitwise equal; one scenario more than the most takes one
    warp per scenario."""
    cfg, pr = _fleet(elastic)
    if batch == "most":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        batch = sms * ipm_fused.occupancy(cfg, 1)["blocks_per_sm"]
        assert ipm_fused.occupancy(cfg, batch + 1)["width"] == 1
    assert ipm_fused.occupancy(cfg, 8192)["width"] == 1
    assert ipm_fused.occupancy(cfg, batch)["width"] == width
    before = (solve_batch_fused.launches, solve_batch_fused.launches_wide)
    whole = solve_batch_fused(cfg, pr, iterations=iterations, mu_sigma=mu_sigma)
    alone = solve_batch_fused(cfg, gather(pr, torch.arange(batch, device="cuda")),
                              iterations=iterations, mu_sigma=mu_sigma)
    torch.cuda.synchronize()
    moved = (solve_batch_fused.launches - before[0], solve_batch_fused.launches_wide - before[1])
    assert moved == (2, int(width == 4))
    for a, b in zip((alone.states, alone.controls, *alone.diagnostics),
                    (whole.states, whole.controls, *whole.diagnostics)):
        assert torch.equal(a, b[:batch])


@pytest.mark.cuda
def test_fused_replay_moves_each_width_counter(cuda):
    """A captured fleet solve at B=8,192: the base call and the stage of
    1,024 at one warp per scenario, the stage of 164 at 4; the first call
    and each replay move the launch counter by 3 and the wide launches' by
    1."""
    cfg, pr = _fleet()
    solve = make_batch_solver(cfg)
    for _ in range(3):
        before = (solve_batch_fused.launches, solve_batch_fused.launches_wide)
        solve(pr)
        moved = (solve_batch_fused.launches - before[0],
                 solve_batch_fused.launches_wide - before[1])
        assert moved == (3, 1)
    torch.cuda.synchronize()


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
