"""The batched path made capturable (`kissmpc_tpu_torch/solver/graph.py`),
on the CPU at N <= 15, B <= 16, G <= 16.

On the card `make_batch_solver` (either backend, refinement included), the
fleet tick (`environment.fleet_step` + `obstacles.advance`), the
data-parallel fleet solver and stepper, the CLI `lab` stepper and the
planner's two grid fields each run one CUDA graph per input signature, and
a capture fails on any host synchronisation inside its region.  Here
nothing is captured, so these tests hold each region to that under
`tests/test_torch_capture.py`'s `TorchDispatchMode`: no
`_local_scalar_dense`, `lift_fresh`, `nonzero` or `is_nonzero`.  The fused
kernel cannot run here, so its wrapper's host code runs up to the launch
with a stand-in launcher (`ops/ipm_fused.py::_launch`), on the card's path
and not the plain version's.  The repairs that made the wrapper and the
planner sync-free are held bitwise to the expressions they replaced, and
`make_batch_solver` through `graph.run` to `solve_batch` bitwise and to the
JAX package's jitted `make_batch_solver` within tests/test_torch_api.py's
budget for `solve_batch` (float64 controls within 1e-6, equal converged
flags).  The card's side is tests/test_torch_capture_batch_cuda.py.
"""

import ctypes
import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.scenarios import obstacle_problems as j_obstacle_problems
from kissmpc_tpu.solver.api import make_batch_solver as j_make_batch_solver
from kissmpc_tpu_torch import MPCConfig, make_batch_solver, solve_batch
from kissmpc_tpu_torch._tree import leaves
from kissmpc_tpu_torch.agent import AgentParams
from kissmpc_tpu_torch.bridge import problem_from_numpy, solution_to_numpy
from kissmpc_tpu_torch.ops import ipm_fused
from kissmpc_tpu_torch.parallel import fleet
from kissmpc_tpu_torch.planner import (_OFFSETS, _offsets, bottleneck_clearance,
                                       plan_waypoint_chain)
from kissmpc_tpu_torch.scenarios import episode_worlds, obstacle_problems
from kissmpc_tpu_torch.solver import api, graph
from chip_smoke import fleet_tick
from tests.test_torch_capture import _same, _SyncOps

CPU = "cpu"
STAGES = ((0.5, 16, 0.2), (0.25, 24, 0.7))
TOL = 1e-6  # tests/test_torch_api.py's float64 budget for solve_batch's controls


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small operations, beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_rank():
    """A one-process gloo group (an in-process store, no port), and its
    mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield fleet.make_mesh(CPU)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def regions(monkeypatch):
    """Every function handed to `graph.run` runs under a `_SyncOps`; yields
    the list of (key, counts) it fills."""
    real = graph.run
    found = []

    def spy(key, fn, device, *inputs):
        def counted(*args):
            with _SyncOps() as mode:
                out = fn(*args)
            found.append((key[0], mode))
            return out

        return real(key, counted, device, *inputs)

    monkeypatch.setattr(graph, "run", spy)
    yield found


class _Launcher:
    """Stands in for the fused kernel's library: records each launch's trip
    count and sigma column, read from the packed inputs' memory, reports a
    width of one warp per scenario, and leaves the outputs as allocated."""

    def __init__(self):
        self.trips, self.sigma = [], []

    def kissmpc_ipm_fused_f32(self, trips, scal, *ptrs):
        params = ptrs[-2]._obj
        ptrs[-3]._obj.value = 1
        self.trips.append(ctypes.c_int32.from_address(trips).value)
        rows = 27  # the scal row: 3 + 3 + 4 + 4 + 6 + 6 + 1
        self.sigma.append([ctypes.c_float.from_address(scal + 4 * (b * rows + rows - 1)).value
                           for b in range(params.B)])
        return 0


@pytest.fixture
def card_launch(monkeypatch):
    """`solve_batch` dispatches float32 fused solves to the wrapper's card
    path with the stand-in launcher; yields the launcher."""
    lib = _Launcher()

    def fused(cfg, problems, *, iterations=None, mu_sigma=None):
        ipm_fused._check_supported(cfg)
        ipm_fused._check_problems(cfg, problems)
        return ipm_fused._launch(lib, 0, cfg, problems, iterations, mu_sigma)

    monkeypatch.setattr(api, "solve_batch_fused", fused)
    yield lib


def _cfg(K=3, backend="split", **solver):
    cfg = MPCConfig(horizon=12, time_step=0.1, max_obstacles=K)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, solve_backend=backend, iterations=6, refine_stages=STAGES, **solver))


def _fleet():
    """The fleet loop's configuration at N=15, K=8 with affine tracks, and
    16 detour-routed worlds."""
    cfg = MPCConfig(horizon=15, time_step=0.041, max_obstacles=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=4, refine_stages=((0.125, 4, 0.2), (0.02, 6, 0.7)),
        mu_sigma_max=0.7, fused_affine_tracks=True))
    params = AgentParams(complete_warm_starts=False, prediction_dt=cfg.time_step,
                         stall_skip_ticks=50)
    env, obstacles = episode_worlds(cfg, 16, n_waypoints=2, seed=3, device=CPU)
    return cfg, params, env, obstacles


def _never_synced(regions, keys, min_ops=400):
    assert [key for key, _ in regions] == keys
    for key, mode in regions:
        assert mode.ops > min_ops, key  # the whole program ran inside the region
        assert not mode.seen, (key, dict(mode.seen))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_make_batch_solver_never_syncs(regions, dtype):
    """Split `make_batch_solver` at B=8 with two refine stages: the base
    solve, the stages' sort, gathers and merges, inside one region (after
    the pool builder's own region)."""
    cfg = _cfg()
    p = obstacle_problems(cfg, 8, seed=4, dtype=dtype, device=CPU)
    sol = make_batch_solver(cfg, device=CPU)(p)
    assert not bool(sol.diagnostics.converged.all())  # the stages had work
    _never_synced(regions, ["scenarios.obstacle_problems", "make_batch_solver"])
    assert regions[-1][1].ops > 10_000


@pytest.mark.parametrize("mu_sigma", [None, 0.35, "per-scenario"])
def test_fused_wrapper_never_syncs_up_to_the_launch(card_launch, mu_sigma):
    """The fused wrapper's card path (packing, the trip count and sigma
    made on the device, the outputs and the certificate) issues no host
    round-trip, and the launcher reads the trip count and sigma it was
    given."""
    cfg = _cfg(K=3, backend="fused", fused_affine_tracks=True, mu_sigma_max=0.7)
    p = obstacle_problems(cfg, 5, seed=2, device=CPU)
    sig = torch.linspace(0.1, 0.5, 5) if mu_sigma == "per-scenario" else mu_sigma
    before = ipm_fused.solve_batch_fused.launches
    with _SyncOps() as mode:
        api.solve_batch_fused(cfg, p, iterations=7, mu_sigma=sig)
    assert mode.ops > 20 and not mode.seen, dict(mode.seen)
    assert ipm_fused.solve_batch_fused.launches == before + 1
    assert card_launch.trips == [7]
    want = sig.numpy() if mu_sigma == "per-scenario" else np.full(
        5, cfg.solver.mu_sigma if mu_sigma is None else mu_sigma, np.float32)
    assert card_launch.sigma == [[float(x) for x in want]]


def test_fused_make_batch_solver_never_syncs(regions, card_launch):
    """Fused `make_batch_solver` at B=16 with two refine stages through the
    wrapper's card path: one launch per stage, each with its trip count and
    sigma, in one region (after the pool builder's own region)."""
    cfg = _cfg(K=3, backend="fused", fused_affine_tracks=True, mu_sigma_max=0.7)
    make_batch_solver(cfg, device=CPU)(obstacle_problems(cfg, 16, seed=2, device=CPU))
    _never_synced(regions, ["scenarios.obstacle_problems", "make_batch_solver"])
    assert card_launch.trips == [6, 16, 24]
    assert [len(s) for s in card_launch.sigma] == [16, 8, 4]
    assert [s[0] for s in card_launch.sigma[1:]] == [float(np.float32(0.2)),
                                                    float(np.float32(0.7))]


def test_fleet_tick_never_syncs(regions, card_launch):
    """The fleet tick (`chip_smoke.py::fleet_tick`) at B=16, K=8 with affine
    tracks, two refine stages: the problem build, the solve on the
    wrapper's card path, the bookkeeping (skip-ahead, stall-skip) and
    `obstacles.advance`, over two ticks."""
    cfg, params, env, obstacles = _fleet()
    for _ in range(2):
        env, obstacles, _ = fleet_tick(cfg, params, env, obstacles, CPU)
    _never_synced(regions, ["fleet_tick"] * 2)
    assert card_launch.trips == [4, 4, 6] * 2


def test_data_parallel_programs_never_sync(regions, card_launch, one_rank):
    """The fleet solver and stepper on a one-process gloo group: the
    shard's work and `fleet_metrics`' two collectives in one region each
    (on the CPU `graph.run` runs them eagerly; the pool builder's region
    comes first), the counter moved by 2 per call."""
    cfg, params, env, obstacles = _fleet()
    count = fleet.fleet_metrics.collectives
    solver = fleet.make_fleet_solver(cfg, one_rank)
    sol, metrics = solver(obstacle_problems(cfg, 16, seed=5, device=CPU))
    _, _, step_metrics = fleet.make_fleet_env_stepper(cfg, params, one_rank)(env, obstacles)
    _never_synced(regions, ["scenarios.obstacle_problems", "make_fleet_solver",
                            "make_fleet_env_stepper"])
    assert fleet.fleet_metrics.collectives == count + 4
    assert metrics.converged_fraction.shape == step_metrics.mean_cost.shape == ()


def _planner_inputs(B=6, K=4, W=2, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.concatenate([rng.uniform(-1, 1, (B, 2)), np.zeros((B, 1))], 1)
    wps = np.concatenate([rng.uniform(2, 4, (B, W, 2)), np.zeros((B, W, 1))], 2)
    centers = rng.uniform(0, 3, (B, K, 2))
    radii = rng.uniform(0.1, 0.4, (B, K))
    static = rng.random((B, K)) < 0.8
    return starts, wps, centers, radii, static


def test_planner_fields_never_sync(regions):
    """`plan_waypoint_chain` and `bottleneck_clearance` at G=16: each grid
    field in its own region, keyed by its grid."""
    starts, wps, centers, radii, static = _planner_inputs()
    out, reach = plan_waypoint_chain(starts, wps, centers, radii, static, 0.4, grid=16,
                                     device=CPU)
    w = bottleneck_clearance(starts, wps[:, -1], centers, radii, static, 0.4, grid=16,
                             device=CPU)
    assert out.shape == (6, 8, 3) and reach.shape == (6, 2) and w.shape == (6,)
    _never_synced(regions, ["planner._plan_fields", "planner._bottleneck_fields"])


@pytest.mark.parametrize("sig", [0.2, 0.7, 0.1, 1.0 / 3.0, 1e-40, 3, True, 0.0,
                                 np.float64(0.45)])
def test_sigma_fill_bitwise(sig):
    """The sigma column filled on the device equals the expression it
    replaced, `torch.as_tensor(sig).reshape(-1, 1).expand(B, 1)`, bit for
    bit (1e-40 is subnormal in float32), in both dtypes the packer takes."""
    cfg = _cfg(backend="fused")
    p = obstacle_problems(cfg, 4, seed=0, device=CPU)
    for dtype in (torch.float32, torch.float64):
        col = ipm_fused.pack_inputs(cfg, p, sig, dtype).scal[:, -1:]
        want = torch.as_tensor(sig, dtype=dtype).reshape(-1, 1).expand(4, 1)
        assert _same(col, want.contiguous())


@pytest.mark.parametrize("iters", [0, 1, 32, 128, 2**31 - 1])
def test_trip_count_fill_bitwise(iters):
    """The trip count made by a fill equals `torch.tensor([iters],
    dtype=torch.int32)`, bit for bit."""
    got = torch.full((1,), iters, dtype=torch.int32, device=CPU)
    assert _same(got, torch.tensor([iters], dtype=torch.int32))


def test_planner_offsets_bitwise():
    """The backtrack offsets made on the device equal `torch.tensor(_OFFSETS,
    dtype=torch.int32)`, bit for bit."""
    assert _same(_offsets(CPU), torch.tensor(_OFFSETS, dtype=torch.int32))


@pytest.mark.parametrize("backend,dtype", [("split", torch.float32), ("split", torch.float64),
                                           ("fused", torch.float32)])
def test_make_batch_solver_is_solve_batch(backend, dtype):
    """`make_batch_solver` through `graph.run` is `solve_batch` bit for bit
    on the CPU (the fused backend runs its plain version here)."""
    cfg = _cfg(backend=backend)
    p = obstacle_problems(cfg, 8, seed=4, dtype=dtype, device=CPU)
    got, ref = make_batch_solver(cfg, device=CPU)(p), solve_batch(cfg, p, device=CPU)
    assert all(_same(a, b) for a, b in zip(leaves(got), leaves(ref), strict=True))


def test_make_batch_solver_matches_jax():
    """`make_batch_solver` (split, float64, two refine stages) against the
    JAX package's jitted `make_batch_solver` on the same batch: controls
    within 1e-6, converged flags equal."""
    import jax

    jcfg = JConfig(horizon=12, time_step=0.1, max_obstacles=3)
    jcfg = jcfg.replace(solver=dataclasses.replace(
        jcfg.solver, solve_backend="split", iterations=6, refine_stages=STAGES))
    jp = j_obstacle_problems(jcfg, 8, seed=4, dtype=jax.numpy.float64)
    ref = j_make_batch_solver(jcfg)(jp)
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    got = solution_to_numpy(make_batch_solver(_cfg(), device=CPU)(
        problem_from_numpy(arrays, device=CPU)))
    assert not got.diagnostics.converged.all()
    np.testing.assert_array_equal(got.diagnostics.converged,
                                  np.asarray(ref.diagnostics.converged))
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls), atol=TOL, rtol=0)
