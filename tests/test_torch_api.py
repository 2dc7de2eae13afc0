"""Port parity and contract: `solve_batch` with staged refinement, the
refusals (only the ValueErrors remain: elastic obstacles and Mehrotra
"pc"/"soc" run now), the device convention and the import boundary."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import kissmpc_tpu_torch
from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.scenarios import obstacle_problems as j_obstacle_problems
from kissmpc_tpu.solver.api import solve_batch as j_solve_batch
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch import bridge
from kissmpc_tpu_torch import make_batch_solver, solve_batch
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.solver.api import _dispatch

PACKAGE = Path(kissmpc_tpu_torch.__file__).parent
STAGES = ((0.5, 16, 0.2), (0.25, 24, 0.7))


def _configs(**solver):
    kw = dict(horizon=12, time_step=0.1, max_obstacles=3)
    skw = dict(iterations=6, refine_stages=STAGES, **solver)
    j, t = JConfig(**kw), TConfig(**kw)
    return (
        j.replace(solver=dataclasses.replace(j.solver, solve_backend="split", **skw)),
        t.replace(solver=dataclasses.replace(t.solver, solve_backend="split", **skw)),
    )


@pytest.fixture(scope="module")
def batch():
    jcfg, _ = _configs()
    jp = j_obstacle_problems(jcfg, 8, seed=4, dtype=jax.numpy.float64)
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, arrays


def test_solve_batch_with_refinement_matches_jax(batch):
    """A 6-iteration base solve leaves most scenarios unconverged, so both
    refinement stages gather, re-solve and merge real sub-batches."""
    jp, arrays = batch
    jcfg, tcfg = _configs()
    ref = j_solve_batch(jcfg, jp)
    base = solution_to_numpy(_dispatch(tcfg, problem_from_numpy(arrays, device="cpu")))
    got = solution_to_numpy(solve_batch(tcfg, problem_from_numpy(arrays, device="cpu"),
                                        device="cpu"))
    assert not base.diagnostics.converged.all()
    assert got.diagnostics.converged.sum() > base.diagnostics.converged.sum()
    np.testing.assert_array_equal(got.diagnostics.converged,
                                  np.asarray(ref.diagnostics.converged))
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls), atol=1e-6, rtol=0)
    for name in ("final_cost", "final_mu", "kkt_feasibility"):
        np.testing.assert_allclose(getattr(got.diagnostics, name),
                                   np.asarray(getattr(ref.diagnostics, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    # Scenarios that refinement did not take come back bit-identical.
    kept = got.diagnostics.converged == base.diagnostics.converged
    np.testing.assert_array_equal(got.controls[kept], base.controls[kept])
    # make_batch_solver is the same solve closed over the config.
    again = make_batch_solver(tcfg, device="cpu")(problem_from_numpy(arrays, device="cpu"))
    np.testing.assert_array_equal(again.controls.numpy(), got.controls)


@pytest.mark.parametrize(
    "solver,err",
    [
        (dict(solve_backend="Split"), ValueError),
        (dict(lqr_backend="xla"), ValueError),
        (dict(mehrotra="sco"), ValueError),
        (dict(elastic_obstacles=True, mehrotra="pc"), ValueError),
        (dict(solve_backend="fused", mehrotra="pc"), ValueError),
        (dict(solve_backend="fused", mehrotra="soc"), ValueError),
    ],
)
def test_solve_batch_refusals(batch, solver, err):
    _, arrays = batch
    _, tcfg = _configs()
    cfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver, **solver))
    with pytest.raises(err):
        solve_batch(cfg, problem_from_numpy(arrays, device="cpu"), device="cpu")


def test_per_scenario_mu_sigma_refused(batch):
    _, arrays = batch
    _, tcfg = _configs()
    with pytest.raises(ValueError):
        _dispatch(tcfg, problem_from_numpy(arrays, device="cpu"),
                  mu_sigma=torch.full((8,), 0.5))


def test_default_device_needs_cuda(batch):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    _, arrays = batch
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        problem_from_numpy(arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batch(tcfg, problem_from_numpy(arrays, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        kissmpc_tpu_torch.scenarios.free_problems(tcfg, 2)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    """solve_batch, make_solver, fleet_step and episode_worlds run on the
    card by default and raise without CUDA; device="cpu" runs them here."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    from kissmpc_tpu_torch import environment, make_solver
    from kissmpc_tpu_torch.agent import AgentParams
    from kissmpc_tpu_torch.scenarios import episode_worlds, free_problems

    cfg = TConfig(horizon=6, time_step=0.1, max_obstacles=2)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, iterations=3))
    problems = free_problems(cfg, 2, device="cpu")
    env, obstacles = episode_worlds(cfg, 2, device="cpu")
    calls = {
        "solve_batch": lambda **d: solve_batch(cfg, problems, **d),
        "make_solver": lambda **d: make_solver(cfg, **d)(problems),
        "fleet_step": lambda **d: environment.fleet_step(cfg, AgentParams(), env, obstacles, **d),
        "episode_worlds": lambda **d: episode_worlds(cfg, 2, **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        out = call(device="cpu")
        assert out is not None, name


def _perception_io_calls(tmp_path):
    """Each public entry point of the perception and I/O packages, as a call
    taking the device keyword."""
    from kissmpc_tpu_torch.io import frames, model
    from kissmpc_tpu_torch.perception import detectors, pipeline, segnet, tracker

    walk = str(tmp_path / "walk.npz")
    frames.record_synthetic_walk(walk, n_frames=3)
    fr = next(frames.FrameReplayer(walk).synced())
    cfg = tracker.TrackerConfig()
    geom = lambda **d: bridge.geometry_from_numpy(fr.geometry, **d)  # noqa: E731
    table = tracker.init_tracks(2, device="cpu")
    cpu_geom = geom(device="cpu")
    state = pipeline.init_perception(2, device="cpu")
    net = segnet.TinySegNet.brightness(device="cpu")
    return {
        "init_tracks": lambda **d: tracker.init_tracks(2, **d),
        "init_perception": lambda **d: pipeline.init_perception(2, batch=3, **d),
        "detect_centers": lambda **d: pipeline.detect_centers(
            cpu_geom, fr.points, fr.point_mask, fr.instance_masks, fr.instance_valid, **d),
        "pipeline.step": lambda **d: pipeline.step(
            cfg, state, cpu_geom, torch.tensor(fr.points), torch.tensor(fr.point_mask),
            torch.tensor(fr.instance_masks), torch.tensor(fr.instance_valid), 0.1, **d),
        "replay_session": lambda **d: frames.replay_session(
            frames.FrameReplayer(walk), cfg, capacity=2, **d),
        "Model": lambda **d: model.Model(**d),
        "TinySegNet.brightness": lambda **d: segnet.TinySegNet.brightness(**d),
        "TorchSegmentationAdapter": lambda **d: detectors.TorchSegmentationAdapter(net, **d),
        "geometry_from_numpy": geom,
        "perception_state_from_numpy": lambda **d: bridge.perception_state_from_numpy(
            table, **d),
        "segnet_from_numpy": lambda **d: bridge.segnet_from_numpy(
            {k: v.numpy() for k, v in net.state_dict().items()}, **d),
    }


@pytest.mark.parametrize("name", [
    "init_tracks", "init_perception", "detect_centers", "pipeline.step", "replay_session",
    "Model", "TinySegNet.brightness", "TorchSegmentationAdapter", "geometry_from_numpy",
    "perception_state_from_numpy", "segnet_from_numpy",
])
def test_perception_and_io_need_cuda_unless_cpu_is_asked(name, tmp_path):
    """Every entry point of the perception and I/O packages runs on the card
    by default and raises without CUDA; device="cpu" runs it here."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    call = _perception_io_calls(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert call(device="cpu") is not None


def test_import_leaves_jax_out():
    code = (
        "import sys, kissmpc_tpu_torch, kissmpc_tpu_torch.ops.riccati\n"
        "import kissmpc_tpu_torch.ops.ipm_fused, kissmpc_tpu_torch.ops.probe\n"
        "import kissmpc_tpu_torch.agent, kissmpc_tpu_torch.environment\n"
        "import kissmpc_tpu_torch.scenarios, kissmpc_tpu_torch.bridge\n"
        "import kissmpc_tpu_torch.perception, kissmpc_tpu_torch.perception.detectors\n"
        "import kissmpc_tpu_torch.perception.segnet, kissmpc_tpu_torch.io\n"
        "import kissmpc_tpu_torch.io.frames, kissmpc_tpu_torch.io.replay\n"
        "import kissmpc_tpu_torch.io.ros2, kissmpc_tpu_torch.io.markers\n"
        "import kissmpc_tpu_torch.parallel.fleet, kissmpc_tpu_torch.parallel.multihost\n"
        "import kissmpc_tpu_torch.utils.metrics, kissmpc_tpu_torch.utils.profiling\n"
        "import kissmpc_tpu_torch.utils.checkpoint, kissmpc_tpu_torch.ops.lqr_pt\n"
        "import kissmpc_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kissmpc_tpu' or m.startswith('kissmpc_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_module_of_the_port_imports_jax():
    pattern = re.compile(
        r"^\s*(import\s+(jax|kissmpc_tpu)\b|from\s+(jax|kissmpc_tpu)\b)",
        re.M,
    )
    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
