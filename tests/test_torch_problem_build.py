"""The problem build on the CPU: its plain version against the JAX package,
and the build kernel's wrapper.

`ops/problem_build.py::build_plain` (the sensor's top K, the tracks,
`default_problem`'s rows, the repair, the moved test and the completion
rollout) is held against the JAX `problem_with_obstacles`
(`kissmpc_tpu/solver/problem.py:278`, vmapped over the batch) on
chip_smoke.py's `build_inputs` (N=12, a plan step of 0.5 s, so that most
warm starts cross the circles and roll out): repair and completion on and
off, a zero completion threshold, K=0, K_all > K, one set shared by every
scenario (a stride-0 ``expand``, JAX's unbatched set), the start tiled with
the default prediction dt; float64, every Problem field of each scenario
within 1e-9 of its scale (at least 1), but for scenarios whose rollout took
a decision the other way on an ulp (at most max(1, twice the port's own
f32-vs-f64 flips)).  On CPU tensors `problem_with_obstacles` is
`build_plain`, bit for bit.  The wrapper's card path
(`problem_build._launch`) is driven through a stand-in launcher: every
launch argument is made from ``cfg``, the keyword numbers and the shapes
alone; the inputs are handed in place with their batch strides (a shared
set at stride 0, a start that is a column of a plan at the plan's
stride); no host round-trip and no work beyond allocation on the way;
one launch counted; a failed launch, impossible shapes and a bound given
as a tensor (the plain version's alone) raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _field_ratio, build_inputs
from kissmpc_tpu import MPCConfig as JConfig
from kissmpc_tpu.obstacles import obstacles as jobs
from kissmpc_tpu.solver import problem as jprob
from kissmpc_tpu_torch import MPCConfig as TConfig
from kissmpc_tpu_torch.obstacles.obstacles import ObstacleSet
from kissmpc_tpu_torch.ops import problem_build
from kissmpc_tpu_torch.solver.problem import problem_with_obstacles

from .test_torch_capture import _SyncOps

N, DT = 12, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run beside others in parallel
    workers, where many threads per worker only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# name -> (K, obstacles per scenario K_all, shared set, warm start, keywords)
CASES = {
    "k4": (4, 4, False, True, {}),
    "k4_kall7": (4, 7, False, True, {}),
    "k4_shared": (4, 6, True, True, {}),
    "k4_no_repair": (4, 4, False, True, {"repair_warm_start_states": False}),
    "k4_no_completion": (4, 4, False, True, {"complete_warm_start_states": False}),
    "k4_neither": (4, 4, False, True, {"repair_warm_start_states": False,
                                       "complete_warm_start_states": False}),
    "k4_cold": (4, 5, False, False, {"prediction_dt": None}),
    "k4_threshold0": (4, 4, False, True, {"completion_threshold": 0.0}),
    "k0": (0, 3, False, True, {}),
}


def _inputs(name, dtype=torch.float64, B=8, seed=7):
    K, k_all, shared, warm, options = CASES[name]
    cfg = TConfig(horizon=N, time_step=DT, max_obstacles=K)
    start, goal, obstacles, kw = build_inputs(cfg, B, seed, k_all=k_all, shared=shared,
                                              warm=warm, dtype=dtype, device="cpu")
    return cfg, start, goal, obstacles, {**kw, **options}


def _jax_build(name, start, goal, obstacles, kw):
    K, _, shared, _, _ = CASES[name]
    jcfg = JConfig(horizon=N, time_step=DT, max_obstacles=K)
    np_ = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jo = jobs.ObstacleSet(*(np_(x[0] if shared else x) for x in obstacles))
    fixed = {k: v for k, v in kw.items()
             if k not in ("warm_states", "warm_controls", "dtype", "device")}
    warm = [kw[k] for k in ("warm_states", "warm_controls") if kw.get(k) is not None]

    def one(s, g, o, *w):
        extra = dict(zip(("warm_states", "warm_controls"), w))
        return jprob.problem_with_obstacles(jcfg, s, g, o, dtype=jnp.float64, **fixed, **extra)

    axes = (0, 0, None if shared else 0) + (0,) * len(warm)
    return jax.vmap(one, in_axes=axes)(np_(start), np_(goal), jo, *(np_(w) for w in warm))


@pytest.mark.parametrize("name", list(CASES))
def test_build_plain_matches_jax(name):
    """Every field of each scenario within 1e-9 of its scale, except in
    scenarios where a discrete decision went the other way: the rollout
    caps a step so that the robot lands on an inflated circle, and the
    next step's inside-or-out test then turns on the last bit (the two
    frameworks' float64 states differ there by an ulp).  Such scenarios
    are at most max(1, twice the port's own f32-vs-f64 flips), as
    chip_smoke.py's gate counts them on the card."""
    cfg, start, goal, obstacles, kw = _inputs(name)
    got = problem_build.build_plain(cfg, start, goal, obstacles, **kw)
    ref = _jax_build(name, start, goal, obstacles, kw)
    f32 = dict(kw, dtype=torch.float32,
               **{k: kw[k].float() for k in ("warm_states", "warm_controls") if k in kw})
    other = problem_build.build_plain(cfg, start.float(), goal.float(),
                                      ObstacleSet(*(x.float() for x in obstacles)), **f32)
    ratio, own = [], []
    for field in ref._fields:
        r = torch.from_numpy(np.array(getattr(ref, field), np.float64))
        g, o = getattr(got, field), getattr(other, field)
        assert tuple(g.shape) == tuple(r.shape) and g.dtype == torch.float64, field
        ratio.append(_field_ratio(g, r, o, f32=False)[1])
        own.append(_field_ratio(g, g, o, f32=False, own=True)[1])
    flips = torch.stack(ratio).amax(0) > 1.0
    allowed = max(1, 2 * int((torch.stack(own).amax(0) > 1.0).sum()))
    assert int(flips.sum()) <= allowed, (flips, allowed)


@pytest.mark.parametrize("name", ["k4", "k4_shared", "k4_no_repair", "k0"])
def test_problem_with_obstacles_on_the_cpu_is_build_plain(name):
    cfg, start, goal, obstacles, kw = _inputs(name, torch.float32)
    a = problem_with_obstacles(cfg, start, goal, obstacles, **kw)
    b = problem_build.build_plain(cfg, start, goal, obstacles, **kw)
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


class _Launcher:
    """Stands in for the library: records what the launcher is handed,
    writes nothing, returns ``err``; asks for ``scratch_bytes`` of global
    scratch (the kernel's rows in global memory, long horizons)."""

    def __init__(self, err=0, scratch_bytes=0):
        self.err = err
        self.scratch_bytes = scratch_bytes
        self.calls = []

    def _record(self, kind, params, inputs, strides, outputs, scratch, stream):
        self.calls.append((kind, params._obj, inputs._obj, strides._obj, outputs._obj, scratch,
                           stream))
        return self.err

    def kissmpc_build_f32(self, *a):
        return self._record("f32", *a)

    def kissmpc_build_f64(self, *a):
        return self._record("f64", *a)

    def kissmpc_build_scratch_bytes(self, params, elem_bytes):
        return self.scratch_bytes

    def kissmpc_cuda_error_string(self, err):
        return b"stand-in failure"


# Ops the card path may dispatch: allocation and views, no work.
ALLOWED_OPS = {"aten.empty", "aten.expand", "aten.select", "aten.view", "aten.as_strided",
               "aten.alias", "aten._reshape_alias", "aten.reshape", "aten.slice"}


class _Ops(_SyncOps):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_card_path_hands_the_kernel_cfg_strides_and_pointers(dtype):
    """One launch with the config's and the keywords' numbers, every input
    in place with its batch stride (the shared set at 0, the start a column
    of the plan), the outputs of the Problem's shapes, a global scratch of
    the bytes the library asks for (none where the rows fit in shared
    memory); counted; no host round-trip, nothing but allocation and
    views dispatched."""
    cfg, _, goal, obstacles, kw = _inputs("k4_shared", dtype, B=5)
    plan = kw["warm_states"]
    start = plan[:, 1]  # the current state: column 1 of the last plan
    lib = _Launcher()
    before = problem_build.build_cuda.launches
    with _Ops() as ops:
        out = problem_build._launch(lib, 0, cfg, start, goal, obstacles, **kw)
    assert not ops.seen, dict(ops.seen)
    assert ops.names <= ALLOWED_OPS, ops.names - ALLOWED_OPS
    assert problem_build.build_cuda.launches - before == 1
    [(kind, params, inputs, strides, outputs, scratch, stream)] = lib.calls
    assert kind == ("f32" if dtype == torch.float32 else "f64") and stream == 0
    assert (params.B, params.N, params.K, params.K_all) == (5, N, 4, 6)
    assert (params.repair, params.complete, params.passes) == (1, 1, problem_build.REPAIR_PASSES)
    assert (params.dt, params.pred_dt, params.sensor_radius) == (DT, DT, 2.5)
    assert (params.threshold, params.margin) == (0.05, problem_build.REPAIR_MARGIN)
    assert list(params.cl) == [-0.2, -0.5] and list(params.cu) == [0.5, 0.5]
    y = 20.0 if cfg.bound_y else np.inf
    assert list(params.xl) == [-20.0, -y, -np.inf] and list(params.xu) == [20.0, y, np.inf]
    assert params.infl == 0.25
    assert inputs.x0 == start.data_ptr() and strides.x0 == 3 * (N + 1)
    assert (inputs.goal, strides.goal) == (goal.data_ptr(), 3)
    assert (inputs.warm_x, strides.warm_x) == (plan.data_ptr(), 3 * (N + 1))
    assert (inputs.warm_u, strides.warm_u) == (kw["warm_controls"].data_ptr(), 2 * N)
    for name, leaf in zip(ObstacleSet._fields, obstacles, strict=True):
        assert getattr(inputs, name) == leaf.data_ptr() and getattr(strides, name) == 0
    assert [getattr(outputs, f) for f in out._fields] == [x.data_ptr() for x in out]
    shapes = {"obstacle_centers": (5, 4, N, 2), "obstacle_radii": (5, 4),
              "warm_states": (5, N + 1, 3), "warm_controls": (5, N, 2), "inflation_radius": (5,)}
    for name, shape in shapes.items():
        assert tuple(getattr(out, name).shape) == shape and getattr(out, name).dtype == dtype
    assert scratch is None
    lib = _Launcher(scratch_bytes=4096)
    with _Ops() as ops:
        problem_build._launch(lib, 0, cfg, start, goal, obstacles,
                              **{**kw, "repair_warm_start_states": False})
    assert not ops.seen, dict(ops.seen)
    assert lib.calls[0][5] is not None and lib.calls[0][1].repair == 0


def test_card_path_raises():
    cfg, start, goal, obstacles, kw = _inputs("k4", torch.float32, B=3)
    with pytest.raises(RuntimeError, match="stand-in failure"):
        problem_build._launch(_Launcher(err=98), 0, cfg, start, goal, obstacles, **kw)
    few = ObstacleSet(*(x[:, :3] for x in obstacles))
    with pytest.raises(ValueError, match="top 4"):
        problem_build._launch(_Launcher(), 0, cfg, start, goal, few, **kw)
    with pytest.raises(TypeError, match="float32 or float64"):
        problem_build._launch(_Launcher(), 0, cfg, start, goal, obstacles,
                              **{**kw, "dtype": torch.float16})
    for bad in ({"inflation_radius": torch.full((3,), 0.25)},
                {"control_bounds": ((torch.tensor(-0.1), 0.4), (-0.5, 0.5))}):
        with pytest.raises(TypeError, match="as numbers"):
            problem_build._launch(_Launcher(), 0, cfg, start, goal, obstacles, **{**kw, **bad})
