"""The split iteration's two CUDA kernels (`csrc/ipm_split.cu`) on the card.

Both kernels against their plain halves by chip_smoke.py's gates (each
LQRData field and each field of the new iterate of each scenario within
1e-4 of its scale plus twice the plain version's own f32-vs-f64 gap in
float32, 1e-9 of its scale in float64; the accepted line-search candidate
differs on at most max(1, twice the plain version's own f32-vs-f64 flips)
scenarios; the step's merits at every candidate and rho by the same
gate) at the node's N=7 B=1 and at N=50 B=1024 with K=8 obstacles, hard
and elastic, in the wrapper's layout and with each layout forced (one warp
per scenario; blocks of 2 and 4 warps); every split iteration as one
condensation, one Riccati and one step launch; and a replayed
`make_solver` bitwise equal to its eager run.

Marked ``cuda``: it skips without an NVIDIA GPU (a CUDA kernel has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_ipm_split_cuda.py
"""

import dataclasses

import pytest
import torch

from chip_smoke import bitwise_equal, describe_split_check, split_kernels_check
from kissmpc_tpu_torch import MPCConfig, make_solver
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.ops import ipm_split
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
from kissmpc_tpu_torch.scenarios import obstacle_problems
from kissmpc_tpu_torch.solver import graph, ipm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")


def _case(name, dtype=torch.float32, **solver):
    if name == "node":  # io.Model's defaults with 4 obstacle slots
        cfg, B = MPCConfig(horizon=7, time_step=0.8, max_obstacles=4), 1
    else:
        cfg, B = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8), 1024
        solver.setdefault("mu_sigma_max", 0.7)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, solve_backend="split", **solver))
    return cfg, obstacle_problems(cfg, B, seed=3, n_dynamic=2, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name,solver", [("node", {}), ("k8", {}),
                                         ("k8", {"elastic_obstacles": True}),
                                         ("k8", {"mehrotra": "pc"})],
                         ids=["node", "k8", "k8_elastic", "k8_pc"])
def test_kernels_match_plain_halves(cuda, name, solver, dtype):
    cfg, problems = _case(name, dtype, **solver)
    res = split_kernels_check(cfg, problems, 6, ipm_split._library(),
                              torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert res["ok"], describe_split_check(res)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("name,solver", [("node", {}), ("k8", {"elastic_obstacles": True})],
                         ids=["node", "k8_elastic"])
def test_each_layout_matches_plain_halves(cuda, name, solver, warps):
    """The step with its layout forced, float32 (the gates of
    `split_kernels_check`)."""
    cfg, problems = _case(name, torch.float32, **solver)
    res = split_kernels_check(cfg, problems, 6, ipm_split._library(),
                              torch.cuda.current_stream().cuda_stream, warps=warps)
    torch.cuda.synchronize()
    assert res["ok"], describe_split_check(res)


@pytest.mark.cuda
@pytest.mark.parametrize("mehrotra,per_iteration", [("off", (1, 1, 1)), ("pc", (2, 2, 1)),
                                                    ("soc", (2, 2, 1))])
def test_each_iteration_is_three_launches(cuda, mehrotra, per_iteration):
    """Condensation, Riccati and step launches per iteration: 1, 1, 1; with
    Mehrotra's predictor one more condensation and Riccati solve."""
    cfg, problems = _case("node", mehrotra=mehrotra, iterations=9)
    before = (ipm_split.condense_cuda.launches, solve_lqr_cuda.launches,
              ipm_split.step_cuda.launches)
    with graph.eager():
        ipm.solve(cfg, problems)
    moved = (ipm_split.condense_cuda.launches - before[0], solve_lqr_cuda.launches - before[1],
             ipm_split.step_cuda.launches - before[2])
    assert moved == tuple(9 * n for n in per_iteration)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node", "k8"])
def test_replayed_make_solver_is_bitwise_eager(cuda, name):
    """The first call and two replays equal the eager `ipm.solve` bit for
    bit, and every replay moves the three counters by the captured count."""
    cfg, problems = _case(name)
    solve = make_solver(cfg)
    ref = ipm.solve(cfg, problems)
    iters = cfg.solver.iterations
    for _ in range(3):
        counts = (ipm_split.condense_cuda.launches, ipm_split.step_cuda.launches)
        got = solve(problems)
        assert (ipm_split.condense_cuda.launches - counts[0],
                ipm_split.step_cuda.launches - counts[1]) == (iters, iters)
        assert all(bitwise_equal(a, b) for a, b in zip(leaves(got), leaves(ref), strict=True))
