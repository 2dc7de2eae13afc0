"""The problem build, init and diagnostics kernels on the card.

The build kernel (`csrc/problem_build.cu`) against `build_plain` by
chip_smoke.py's gate (every Problem field of each scenario within 1e-4 of
its scale plus twice the plain version's own f32-vs-f64 gap in float32,
1e-9 of its scale in float64; scenarios outside it, a discrete decision
taken the other way, at most `chip_smoke.allowed_flips`: twice the plain
version's own flips an ulp away (on the CPU, or with the start moved one
ulp), at least 1% and at most a quarter of the batch) at the node's N=7
and K=4 on NODE_BUILD_BATCH node-shaped scenarios and at N=50 K=8 B=1024,
repair and completion on and off, a shared stride-0 set, K_all > K; the
init and
diagnostics kernels (`csrc/ipm_split.cu`) against `ipm.init_plain` and
`ipm.diagnostics_plain` by the same gate (``converged`` flips counted as
the build's; the init at a refine stage's batch and where each thread
takes many entries, the diagnostics at a refine stage's batch and where
its stages take many chunks (N up to 2000, K=100), a second launch the
same bits for both; the
build past one warp's lanes, at K = 0, with tied sensor keys and tied
speed caps, and with its rows in global scratch); `problem_with_obstacles` as one build launch and a split
`ipm.solve` as 1 init + 3 per iteration + 1 diagnostics launches.

Marked ``cuda``: it skips without an NVIDIA GPU (a CUDA kernel has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_build_once_cuda.py
"""

import dataclasses

import pytest
import torch

from chip_smoke import (NODE_BUILD_BATCH, NODE_BUILD_K_ALL, REFINE_CHECK_BATCH, build_inputs,
                        build_kernel_check, describe_build_check, describe_once_check, init_gate,
                        once_kernels_check)
from kissmpc_tpu_torch import MPCConfig
from kissmpc_tpu_torch.ops import ipm_split, problem_build
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda
from kissmpc_tpu_torch.scenarios import obstacle_problems
from kissmpc_tpu_torch.solver import ipm
from kissmpc_tpu_torch.solver.problem import problem_with_obstacles


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")


def _config(name, **solver):
    if name == "node":  # io.Model's defaults with 4 obstacle slots, a batch of node problems
        cfg, B = MPCConfig(horizon=7, time_step=0.8, max_obstacles=4), NODE_BUILD_BATCH
    else:
        cfg, B = MPCConfig(horizon=50, time_step=0.041, max_obstacles=8), 1024
        solver.setdefault("mu_sigma_max", 0.7)
    return cfg.replace(solver=dataclasses.replace(cfg.solver, solve_backend="split",
                                                  **solver)), B


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name,k_all,shared,options", [
    ("node", NODE_BUILD_K_ALL, False, {}), ("node", NODE_BUILD_K_ALL, True, {}),
    ("k8", 8, False, {}),
    ("k8", 12, False, {}), ("k8", 10, True, {"repair_warm_start_states": False}),
    ("k8", 8, False, {"complete_warm_start_states": False}),
], ids=["node", "node_shared", "k8", "k8_kall12", "k8_shared_no_repair", "k8_no_completion"])
def test_build_kernel_matches_plain(cuda, name, k_all, shared, options, dtype):
    cfg, B = _config(name)
    inputs = build_inputs(cfg, B, 5, k_all=k_all, shared=shared, dtype=dtype)
    res = build_kernel_check(cfg, inputs, problem_build._library(),
                             torch.cuda.current_stream().cuda_stream, **options)
    torch.cuda.synchronize()
    assert res["ok"], describe_build_check(res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,K,k_all,B,tie,options", [
    (50, 8, 40, 1024, None, {}), (33, 8, 10, 1024, None, {}), (64, 8, 10, 1024, None, {}),
    (50, 0, 6, 1024, None, {}), (50, 8, 10, 1024, "keys", {}), (50, 8, 10, 1024, "caps", {}),
    (1500, 16, 16, 256, None, {"complete_warm_start_states": False}),
], ids=["kall40", "n33", "n64", "k0", "tied_keys", "tied_caps", "n1500_global"])
def test_build_kernel_layouts(cuda, n, K, k_all, B, tie, options, dtype):
    """The build's layouts past one warp's lanes (K_all > 32 keys, N = 33
    and 64 stages), K = 0, tied sensor keys and tied speed caps, and a
    horizon whose rows pass 227 KB per scenario in both dtypes and take the
    global scratch (K = 16, N = 1500); the others keep them in shared
    memory."""
    cfg = MPCConfig(horizon=n, time_step=0.041, max_obstacles=K)
    occ = problem_build.occupancy(cfg, k_all, B, dtype)
    assert occ["global_rows"] == (n == 1500), occ
    inputs = build_inputs(cfg, B, 9, k_all=k_all, tie=tie, dtype=dtype)
    res = build_kernel_check(cfg, inputs, problem_build._library(),
                             torch.cuda.current_stream().cuda_stream, **options)
    torch.cuda.synchronize()
    assert res["ok"], describe_build_check(res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,K,B,solver", [
    (50, 8, REFINE_CHECK_BATCH, {}), (50, 8, REFINE_CHECK_BATCH, {"elastic_obstacles": True}),
    (50, 8, REFINE_CHECK_BATCH, {"mehrotra": "pc"}), (400, 8, 64, {}), (12, 100, 64, {}),
], ids=["k8", "k8_elastic", "k8_pc", "n400", "k100"])
def test_init_kernel_refine_batch_and_long_rows(cuda, n, K, B, solver, dtype):
    """The init kernel at a refine stage's batch (hard, elastic, "pc"),
    and where each of its threads takes many entries of a family (N = 400;
    K = 100), within the gate; a second launch gives the same bits."""
    cfg, _ = _config("k8", **solver)
    cfg = cfg.replace(horizon=n, max_obstacles=K)
    problems = obstacle_problems(cfg, B, seed=4, n_dynamic=2, dtype=dtype)
    stream = torch.cuda.current_stream().cuda_stream
    gates = [init_gate(cfg, problems, ipm_split._library(), stream) for _ in range(2)]
    torch.cuda.synchronize()
    assert gates[0]["ok"], (gates[0]["worst"], gates[0]["fields"][gates[0]["worst"]])
    assert torch.equal(gates[0]["mu"], gates[1]["mu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,K,B,solver", [
    (50, 8, REFINE_CHECK_BATCH, {}), (50, 8, REFINE_CHECK_BATCH, {"elastic_obstacles": True}),
    (50, 8, REFINE_CHECK_BATCH, {"mehrotra": "pc"}), (400, 8, 64, {}), (12, 100, 64, {}),
    (2000, 8, 64, {}),
], ids=["k8", "k8_elastic", "k8_pc", "n400", "k100", "n2000"])
def test_diagnostics_kernel_refine_batch_and_long_rows(cuda, n, K, B, solver, dtype):
    """The diagnostics kernel at a refine stage's batch (hard, elastic,
    "pc"), and where its stages take many chunks (N = 400 and 2000: the
    suffix scans' carry across 7 and 32 chunks of 64 stages; K = 100:
    chunks of 4 stages), within the gate; a second launch gives the same
    bits."""
    cfg, _ = _config("k8", **solver)
    cfg = cfg.replace(horizon=n, max_obstacles=K)
    problems = obstacle_problems(cfg, B, seed=4, n_dynamic=2, dtype=dtype)
    lib, stream = ipm_split._library(), torch.cuda.current_stream().cuda_stream
    res = once_kernels_check(cfg, problems, 2, lib, stream)
    again = ipm_split._diagnostics(lib, stream, cfg, *res["launched"])
    torch.cuda.synchronize()
    assert res["ok"], describe_once_check(res)
    assert all(torch.equal(x, y) for x, y in zip(res["got"], again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name,solver", [("node", {}), ("k8", {}),
                                         ("k8", {"elastic_obstacles": True}),
                                         ("k8", {"mehrotra": "pc"})],
                         ids=["node", "k8", "k8_elastic", "k8_pc"])
def test_init_and_diagnostics_kernels_match_plain(cuda, name, solver, dtype):
    cfg, B = _config(name, **solver)
    problems = obstacle_problems(cfg, B, seed=3, n_dynamic=2, dtype=dtype)
    res = once_kernels_check(cfg, problems, 6, ipm_split._library(),
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert res["ok"], describe_once_check(res)


@pytest.mark.cuda
def test_build_and_solve_launch_counts(cuda):
    """One build launch per `problem_with_obstacles`; 1 init + 3 x
    iterations + 1 diagnostics launches per split solve."""
    cfg, _ = _config("node")
    start, goal, obstacles, kw = build_inputs(cfg, 1, 2)
    counters = (problem_build.build_cuda, ipm_split.init_cuda, ipm_split.condense_cuda,
                solve_lqr_cuda, ipm_split.step_cuda, ipm_split.diagnostics_cuda)
    before = [c.launches for c in counters]
    problem = problem_with_obstacles(cfg, start, goal, obstacles, **kw)
    sol = ipm.solve(cfg, problem)
    torch.cuda.synchronize()
    n = cfg.solver.iterations
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, n, n, n, 1]
    assert bool(torch.isfinite(sol.states).all())
