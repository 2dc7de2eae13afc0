"""The port's data-parallel fleet (`kissmpc_tpu_torch/parallel/`) over
`torch.distributed` with gloo on the CPU.

In one process: a one-rank group against the JAX package's
`make_fleet_solver` on the 8-device CPU mesh, NaN isolation, and the
collective count per call.  In two processes (this file run as
``python -m tests.test_torch_parallel worker|fault RANK WORLD PORT DIR``):
`initialize_distributed`, `make_pod_mesh`, `distribute_local_batch`,
`health_check` and the fleet solver against JAX on the same global batch,
and the fault drill of tests/test_multihost.py: rank 1 dies, rank 0 detects
it by `health_check` and resumes from its `CheckpointManager` step.
Every group has an explicit timeout and every subprocess a time limit.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.parallel.fleet import make_fleet_solver as j_make_fleet_solver
from kissmpc_tpu.parallel.fleet import make_mesh as j_make_mesh
from kissmpc_tpu.parallel.fleet import shard_problems as j_shard_problems
from kissmpc_tpu.scenarios import free_problems as j_free_problems
from kissmpc_tpu_torch import MPCConfig, bridge, solve_batch
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.parallel import fleet, multihost
from kissmpc_tpu_torch.scenarios import episode_worlds, free_problems
from kissmpc_tpu_torch.solver.problem import Problem
from kissmpc_tpu_torch.utils.checkpoint import CheckpointManager, FleetCheckpoint

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60.0
WORKER_TIMEOUT_S = 300
N, SHARD = 10, 8


def _configs(horizon=N):
    """The JAX and port configurations of one f64 split solve."""
    j, t = JConfig(horizon=horizon, time_step=0.1), MPCConfig(horizon=horizon, time_step=0.1)
    return (j.replace(solver=dataclasses.replace(j.solver, solve_backend="split")),
            t.replace(solver=dataclasses.replace(t.solver, solve_backend="split")))


def _stepper_setup(seed):
    """The JAX census test's fleet tick (tests/test_fleet.py:151-185), on
    the port: N=12, K=2, 6 iterations, 8 episode worlds."""
    cfg = MPCConfig(horizon=12, time_step=0.1, max_obstacles=2)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, iterations=6))
    env, obs = episode_worlds(cfg, 8, n_waypoints=2, seed=seed, n_dynamic=1, device="cpu")
    return cfg, AgentParams(complete_warm_starts=False), env, obs


def _per_call(fn):
    """(the result of ``fn()``, the collectives it issued)."""
    before = fleet.fleet_metrics.collectives
    out = fn()
    return out, fleet.fleet_metrics.collectives - before


# ----------------------------------------------------------------------------
# One rank in this process.


@pytest.fixture(scope="module")
def one_rank():
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        yield fleet.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _global_batch(jcfg, seeds=(0, 1)):
    """A JAX f64 batch of SHARD scenarios per seed, and the same as numpy."""
    parts = [j_free_problems(jcfg, SHARD, seed=s, dtype=jnp.float64) for s in seeds]
    glob = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
    return glob, {k: np.asarray(v) for k, v in glob._asdict().items()}


def test_fleet_solver_matches_jax(one_rank):
    jcfg, tcfg = _configs()
    jp, arrays = _global_batch(jcfg)
    mesh8 = j_make_mesh()
    jsol, jmetrics = j_make_fleet_solver(jcfg, mesh8)(j_shard_problems(jp, mesh8))
    problems = bridge.problem_from_numpy(arrays, device="cpu")
    sol, metrics = fleet.make_fleet_solver(tcfg, one_rank)(problems)
    np.testing.assert_allclose(sol.controls.numpy(), np.asarray(jsol.controls), atol=1e-10,
                               rtol=0)
    assert abs(float(metrics.converged_fraction) - float(jmetrics.converged_fraction)) < 1e-6
    assert float(metrics.converged_fraction) > 0.9
    np.testing.assert_allclose(float(metrics.mean_cost), float(jmetrics.mean_cost), rtol=1e-9)
    # One rank: the fleet's solution is solve_batch's, and its metrics are
    # those of the call's own diagnostics.
    ref = solve_batch(tcfg, problems, device="cpu")
    for a, b in zip(bridge.solution_to_numpy(sol).diagnostics + (sol.controls.numpy(),),
                    bridge.solution_to_numpy(ref).diagnostics + (ref.controls.numpy(),)):
        np.testing.assert_array_equal(a, b)
    d = sol.diagnostics
    assert metrics.converged_fraction.dtype == torch.float32
    assert torch.equal(metrics.converged_fraction, d.converged.float().mean())
    assert torch.equal(metrics.max_kkt_stationarity, d.kkt_stationarity.amax())
    assert torch.equal(metrics.max_kkt_feasibility, d.kkt_feasibility.amax())
    assert torch.equal(metrics.mean_cost, d.final_cost.mean())


def test_shard_problems_one_rank(one_rank):
    _, tcfg = _configs()
    problems = free_problems(tcfg, 4, seed=0, dtype=torch.float64, device="cpu")
    local = fleet.shard_problems(problems, one_rank)
    for a, b in zip(local, problems):
        assert torch.equal(a, b)


def test_nan_scenario_isolation(one_rank):
    """A poisoned scenario (NaN start) does not corrupt its neighbours in
    the fleet's batch (tests/test_fleet.py's case, through the port's fleet
    solver)."""
    _, tcfg = _configs()
    problems = free_problems(tcfg, 8, seed=0, dtype=torch.float64, device="cpu")
    start = problems.initial_state.clone()
    start[3, 0] = float("nan")
    poisoned = problems._replace(initial_state=start)
    solver = fleet.make_fleet_solver(tcfg, one_rank)
    clean, _ = solver(problems)
    bad, _ = solver(poisoned)
    ok = [i for i in range(8) if i != 3]
    np.testing.assert_allclose(bad.controls[ok].numpy(), clean.controls[ok].numpy(), atol=1e-12,
                               rtol=0)
    assert not bool(bad.diagnostics.converged[3])
    assert bool(bad.diagnostics.converged[ok].all())


def test_collectives_per_call_one_rank(one_rank):
    """Two all_reduces per fleet call, solver and stepper alike (the two-rank
    run below counts the same)."""
    _, tcfg = _configs()
    problems = free_problems(tcfg, 4, seed=0, dtype=torch.float64, device="cpu")
    _, count = _per_call(lambda: fleet.make_fleet_solver(tcfg, one_rank)(problems))
    assert count == 2
    cfg, params, env, obs = _stepper_setup(0)
    (new_env, info, metrics), count = _per_call(
        lambda: fleet.make_fleet_env_stepper(cfg, params, one_rank)(env, obs))
    assert count == 2
    assert new_env.agent.states_matrix.shape == env.agent.states_matrix.shape
    assert float(metrics.converged_fraction) == float(info.diagnostics.converged.float().mean())


def test_mesh_axis_names_checked(one_rank):
    with pytest.raises(ValueError):
        fleet.mesh_group(one_rank, ("data", "data"))
    with pytest.raises(ValueError):
        fleet.mesh_group(one_rank, "chip")
    pod = multihost.make_pod_mesh(device_type="cpu")
    assert pod.mesh_dim_names == ("host", "chip") and tuple(pod.mesh.shape) == (1, 1)
    assert multihost.health_check(pod, timeout_s=GROUP_TIMEOUT_S)
    assert multihost.health_check(one_rank, timeout_s=GROUP_TIMEOUT_S)


def test_needs_cuda_unless_cpu_is_asked(one_rank):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.make_pod_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize_distributed("127.0.0.1:1", 2, 0)
    multihost.initialize_distributed(device="cpu")  # one process: nothing to do


# ----------------------------------------------------------------------------
# Two ranks, as two processes running this file.


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, workdir, world=2):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_parallel", mode, str(rank), str(world),
         str(port), str(workdir)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    return procs


def _communicate(proc):
    try:
        return proc.communicate(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"worker timed out:\n{out}\n{err}")


def _worker_line(stdout, stderr):
    lines = [line for line in stdout.splitlines() if line.startswith("WORKER ")]
    assert lines, f"no WORKER line:\n{stdout}\n{stderr}"
    return json.loads(lines[-1][len("WORKER "):])


def test_two_rank_fleet_matches_jax(tmp_path):
    jcfg, _ = _configs()
    jp, arrays = _global_batch(jcfg)
    np.savez(tmp_path / "global.npz", **arrays)
    procs = _launch("worker", tmp_path)
    outs = []
    for p in procs:
        stdout, stderr = _communicate(p)
        assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
        outs.append(_worker_line(stdout, stderr))
    mesh8 = j_make_mesh()
    _, jm = j_make_fleet_solver(jcfg, mesh8)(j_shard_problems(jp, mesh8))
    for o in outs:
        assert o["health"] is True
        assert o["mesh_shape"] == [2, 1]
        assert o["global_batch"] == 2 * SHARD
        assert o["solver_collectives"] == 2 and o["stepper_collectives"] == 2
        # Replicated: every rank holds the same metrics.
        assert o["metrics"] == outs[0]["metrics"]
    m = outs[0]["metrics"]
    assert abs(m["converged_fraction"] - float(jm.converged_fraction)) < 1e-6
    np.testing.assert_allclose(m["mean_cost"], float(jm.mean_cost), rtol=1e-9)
    np.testing.assert_allclose(m["max_kkt_feasibility"], float(jm.max_kkt_feasibility),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(m["max_kkt_stationarity"], float(jm.max_kkt_stationarity),
                               rtol=1e-5, atol=1e-12)


def test_fault_drill_detects_and_resumes(tmp_path):
    jcfg, _ = _configs(horizon=8)
    _, arrays = _global_batch(jcfg)
    np.savez(tmp_path / "global.npz", **arrays)
    procs = _launch("fault", tmp_path)
    stdout1, stderr1 = _communicate(procs[1])
    assert procs[1].returncode == 13, f"{stdout1}\n{stderr1}"  # died as instructed
    stdout0, stderr0 = _communicate(procs[0])
    assert procs[0].returncode == 0, f"survivor failed:\n{stdout0}\n{stderr0}"
    out = _worker_line(stdout0, stderr0)
    assert out["healthy_before"] is True
    assert out["detected_failure"] is True
    assert out["resumed_step"] == 1 and out["resumed_tick"] == 1
    assert out["resumed_cursor"] == SHARD
    # Warm-started from the checkpointed solution, the resumed shard solves.
    assert out["recovered_converged_fraction"] >= 0.9
    assert out["recovered_cost_finite"] is True


def _join(rank, world, port, workdir, horizon):
    """Join the two-rank group; this rank's shard of the parent's global
    batch, as numpy arrays."""
    torch.set_num_threads(1)
    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                                     timeout_s=GROUP_TIMEOUT_S)
    mesh = multihost.make_pod_mesh(ranks_per_host=1, device_type="cpu")
    arrays = dict(np.load(Path(workdir) / "global.npz"))
    local = Problem(**{k: v[rank * SHARD:(rank + 1) * SHARD] for k, v in arrays.items()})
    _, tcfg = _configs(horizon)
    return mesh, arrays, local, tcfg


def _worker(rank, world, port, workdir):
    mesh, arrays, local, tcfg = _join(rank, world, port, workdir, N)
    problems = multihost.distribute_local_batch(mesh, local)
    # The shards are the global batch in rank order.
    sliced = fleet.shard_problems(bridge.problem_from_numpy(arrays, device="cpu"), mesh,
                                  ("host", "chip"))
    assert all(torch.equal(a, b) for a, b in zip(problems, sliced))
    view = DTensor.from_local(
        problems.initial_state, mesh, multihost.batch_sharding(mesh))
    solver = fleet.make_fleet_solver(tcfg, mesh, axis_name=("host", "chip"))
    (_, metrics), solver_count = _per_call(lambda: solver(problems))
    cfg, params, env, obs = _stepper_setup(rank)
    stepper = fleet.make_fleet_env_stepper(cfg, params, mesh, axis_name=("host", "chip"))
    _, stepper_count = _per_call(lambda: stepper(env, obs))
    out = {
        "rank": rank,
        "mesh_shape": list(mesh.mesh.shape),
        "global_batch": int(view.shape[0]),
        "metrics": {k: float(v) for k, v in metrics._asdict().items()},
        "solver_collectives": solver_count,
        "stepper_collectives": stepper_count,
        "health": multihost.health_check(mesh, timeout_s=GROUP_TIMEOUT_S),
    }
    print("WORKER " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _fault_worker(rank, world, port, workdir):
    """Both ranks solve and checkpoint their shard (warm-started from their
    solution); rank 1 then dies hard; rank 0 must detect it by
    `health_check` and resume its shard from its own checkpoint on its own
    device, with no collective."""
    mesh, _, local, tcfg = _join(rank, world, port, workdir, 8)
    problems = multihost.distribute_local_batch(mesh, local)
    solver = fleet.make_fleet_solver(tcfg, mesh, axis_name=("host", "chip"))
    sol, _ = solver(problems)
    healthy_before = multihost.health_check(mesh, timeout_s=30.0)
    resumable = problems._replace(warm_states=sol.states, warm_controls=sol.controls)
    ckpt = FleetCheckpoint(env_state=resumable,
                           rng_key=torch.Generator().manual_seed(rank).get_state(),
                           scenario_cursor=torch.tensor(SHARD), tick=torch.tensor(1))
    mgr = CheckpointManager(str(Path(workdir) / f"ckpt_rank{rank}"))
    mgr.save(1, ckpt)
    (Path(workdir) / f"saved_{rank}").touch()

    if rank == 1:
        # Simulated host crash: no cleanup, no goodbye.
        print("WORKER " + json.dumps({"rank": 1, "dying": True}), flush=True)
        os._exit(13)

    # Survivor: wait until the peer is gone (its marker outlives it).
    deadline = time.time() + 60.0
    while time.time() < deadline and not (Path(workdir) / "saved_1").exists():
        time.sleep(0.1)
    time.sleep(1.5)  # let rank 1's os._exit land
    detected = not multihost.health_check(mesh, timeout_s=6.0)

    step = mgr.latest_step()
    restored = mgr.restore(step, ckpt)
    sol2 = solve_batch(tcfg, restored.env_state, device="cpu")
    cost = float(sol2.diagnostics.final_cost.mean())
    out = {
        "rank": 0,
        "healthy_before": bool(healthy_before),
        "detected_failure": bool(detected),
        "resumed_step": step,
        "resumed_tick": int(restored.tick),
        "resumed_cursor": int(restored.scenario_cursor),
        "recovered_converged_fraction": float(sol2.diagnostics.converged.float().mean()),
        "recovered_cost_finite": bool(np.isfinite(cost)),
    }
    print("WORKER " + json.dumps(out), flush=True)
    # Skip teardown: destroying the group and the interpreter's exit can
    # block on the dead peer.  A real survivor starts a fresh group.
    os._exit(0)


if __name__ == "__main__":
    mode, args = sys.argv[1], (int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    {"worker": _worker, "fault": _fault_worker}[mode](*args)
