"""The problem build's CUDA kernel (`csrc/problem_build.cu`).

`solver/problem.py::problem_with_obstacles` builds a batch of Problems
from an obstacle set: the sensor's top K, their constant-velocity tracks,
`default_problem`'s rows, the warm start's repair and, where the repair
moved it far enough, its completion rollout.  On the card that is one
launch of the build kernel, the port's counterpart of what XLA fuses of
the reference's build under `jax.jit` (`kissmpc_tpu/solver/problem.py:278`);
there is no TPU kernel behind it.  Its plain version is `build_plain`, the
build as plain PyTorch (`solver/problem.py`'s pieces).

For tensors on the CPU `build_cuda` runs `build_plain`; on the card it
launches the kernel or raises, and counts each launch in
``build_cuda.launches`` (registered with `graph.counter`).  The card path
is `_launch(lib, stream, ...)`: every host value reaches the kernel as a
launch argument made from ``cfg``, the call's keyword numbers and the
shapes alone (never a tensor's value), so a CUDA graph captures it, and a
CPU test can drive it through a stand-in launcher or the g++ build of
`scripts/ipm_split_cpu_shim.py`.  Inputs are read in place, with a batch
stride each: an obstacle set shared by every scenario (a stride-0
`expand`, as `agent.build_problem` passes it) or a start that is a column
of a plan is not copied.  The bounds, the inflation, the sensor radius
and the prediction dt are launch arguments: on the card they are numbers
(as every caller passes them); the plain version also takes tensors.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from . import _build
from .._device import resolve_device
from ..obstacles.obstacles import ObstacleSet
from ..solver import graph
from ..solver.problem import (
    COMPLETION_THRESHOLD, CONTROL_BOUNDS, SENSOR_RADIUS, STATE_BOUNDS, Problem,
    complete_warm_start, default_problem, repair_warm_start,
)

SOURCE = _build.CSRC / "problem_build.cu"
# `solver/problem.py::repair_warm_start`'s margin and passes, as the build uses them.
REPAIR_MARGIN = 0.02
REPAIR_PASSES = 3


class _Params(ctypes.Structure):
    """Mirror of ``struct BuildParams`` in `csrc/problem_build.cu`."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "N", "K", "K_all", "repair", "complete", "passes",
    )] + [(name, ctypes.c_double) for name in (
        "dt", "pred_dt", "sensor_radius", "threshold", "margin",
    )] + [("cl", ctypes.c_double * 2), ("cu", ctypes.c_double * 2),
          ("xl", ctypes.c_double * 3), ("xu", ctypes.c_double * 3), ("infl", ctypes.c_double)]


def _pointers(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": [(f, ctypes.c_void_p) for f in fields]})


STRIDED = ("x0", "goal", "warm_x", "warm_u") + ObstacleSet._fields
_Inputs = _pointers("_Inputs", STRIDED)
_Strides = type("_Strides", (ctypes.Structure,),
                {"_fields_": [(f, ctypes.c_longlong) for f in STRIDED]})
_Outputs = _pointers("_Outputs", Problem._fields)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' signatures on a loaded build of ``SOURCE``
    (this package's, or the CPU shim's)."""
    ptr = ctypes.POINTER
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"kissmpc_build_{dt}")
        fn.argtypes = [ptr(_Params), ptr(_Inputs), ptr(_Strides), ptr(_Outputs), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.kissmpc_build_scratch_bytes.argtypes = [ptr(_Params), ctypes.c_int]
    lib.kissmpc_build_scratch_bytes.restype = ctypes.c_longlong
    lib.kissmpc_build_occupancy.argtypes = [ptr(_Params), ctypes.c_int, ptr(ctypes.c_int)]
    lib.kissmpc_build_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE, "kissmpc_problem_build"))


def build_plain(cfg, initial_state, goal_state, obstacles: ObstacleSet, *,
                sensor_radius: float = SENSOR_RADIUS, prediction_dt: float | None = None,
                repair_warm_start_states: bool = True, complete_warm_start_states: bool = True,
                completion_threshold: float = COMPLETION_THRESHOLD, **kwargs) -> Problem:
    """`solver/problem.py::problem_with_obstacles` as plain PyTorch: sensor
    top-K filter, constant-velocity track prediction, `default_problem`'s
    rows, warm-start repair, and the feasibility rollout where the repair
    moved the warm start by more than ``completion_threshold``.  The plain
    version of the build kernel."""
    from ..obstacles import obstacles as obs_mod

    dtype = kwargs.get("dtype", torch.float32)
    dev = resolve_device(kwargs.get("device"))
    initial_state = torch.as_tensor(initial_state, dtype=dtype, device=dev).reshape(-1, 3)
    nearest = obs_mod.select_nearest(
        obstacles, initial_state[:, :2], sensor_radius, cfg.max_obstacles
    )
    dt = obs_mod.PREDICTION_DT if prediction_dt is None else prediction_dt
    tracks = obs_mod.predict_tracks(nearest, cfg.horizon, dt)
    problem = default_problem(
        cfg,
        initial_state,
        goal_state,
        obstacle_centers=tracks,
        obstacle_radii=nearest.radius,
        obstacle_mask=nearest.active,
        **kwargs,
    )
    if cfg.max_obstacles == 0 or not (
        repair_warm_start_states or complete_warm_start_states
    ):
        return problem
    if repair_warm_start_states:
        repaired = repair_warm_start(
            problem.warm_states,
            problem.obstacle_centers,
            problem.obstacle_radii,
            problem.obstacle_mask,
            problem.inflation_radius,
            margin=REPAIR_MARGIN,
            passes=REPAIR_PASSES,
        )
    else:
        repaired = problem.warm_states
    if not complete_warm_start_states:
        return problem._replace(warm_states=repaired)
    if repair_warm_start_states:
        moved = torch.amax(torch.abs(repaired - problem.warm_states), dim=(1, 2))
    else:
        diff = problem.warm_states[:, 1:, None, :2] - problem.obstacle_centers.transpose(1, 2)
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, N, K]
        intrusion = (
            problem.obstacle_radii[:, None, :]
            + problem.inflation_radius[:, None, None]
            - dist
        )
        moved = torch.amax(
            torch.where(
                problem.obstacle_mask[:, None, :] > 0.5,
                intrusion,
                torch.zeros_like(intrusion),
            ),
            dim=(1, 2),
        )
    rolled_states, rolled_controls = complete_warm_start(
        repaired,
        problem.initial_state,
        problem.control_lower,
        problem.control_upper,
        problem.obstacle_centers,
        problem.obstacle_radii,
        problem.obstacle_mask,
        problem.inflation_radius,
        cfg.time_step,
    )
    roll = moved > completion_threshold
    return problem._replace(
        warm_states=torch.where(roll[:, None, None], rolled_states, repaired),
        warm_controls=torch.where(
            roll[:, None, None], rolled_controls, problem.warm_controls
        ),
    )


def build_cuda(cfg, initial_state, goal_state, obstacles: ObstacleSet, *, device=None,
               **kwargs) -> Problem:
    """The batch of Problems of `problem_with_obstacles` (``kwargs`` its
    keywords): the build kernel on the card, `build_plain` on the CPU
    (``device``; None is the card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return build_plain(cfg, initial_state, goal_state, obstacles, device=dev, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"the build kernel runs on CUDA or CPU tensors, got {dev}")
    with torch.cuda.device(dev):
        return _launch(_library(), torch.cuda.current_stream(dev).cuda_stream, cfg,
                       initial_state, goal_state, obstacles, device=dev, **kwargs)


def _strided(x, shape: tuple, dtype, device) -> tuple:
    """``x`` broadcast to ``shape`` (leading batch axis) in ``dtype`` on
    ``device``, each scenario's block contiguous: (tensor, batch stride).
    A tensor already so is read in place (a stride-0 batch axis shares
    it)."""
    t = torch.as_tensor(x, dtype=dtype, device=device).broadcast_to(shape)
    if shape[0] and not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def _launch(lib, stream: int, cfg, initial_state, goal_state, obstacles: ObstacleSet, *,
            sensor_radius: float = SENSOR_RADIUS, prediction_dt: float | None = None,
            repair_warm_start_states: bool = True, complete_warm_start_states: bool = True,
            completion_threshold: float = COMPLETION_THRESHOLD, control_bounds=CONTROL_BOUNDS,
            state_bounds=STATE_BOUNDS, inflation_radius=0.0, warm_states=None,
            warm_controls=None, dtype=torch.float32, device=None) -> Problem:
    """Allocate the Problem and launch the build on ``stream`` through
    ``lib`` (`problem_with_obstacles`' keywords; ``device`` where the
    tensors go)."""
    from ..obstacles.obstacles import PREDICTION_DT

    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the build kernel takes float32 or float64, got {dtype}")
    N, K = cfg.horizon, cfg.max_obstacles
    x0 = torch.as_tensor(initial_state, dtype=dtype, device=device).reshape(-1, 3)
    B = x0.shape[0]
    x0, x0_stride = _strided(x0, (B, 3), dtype, device)
    K_all = obstacles.position.shape[-2]
    if K_all < K:
        raise ValueError(f"the sensor's top {K} needs at least {K} obstacles, got {K_all}")
    obs = [_strided(x, (B, K_all, 2) if name == "position" else (B, K_all), dtype, device)
           for name, x in zip(ObstacleSet._fields, obstacles)]
    goal, goal_stride = _strided(goal_state, (B, 3), dtype, device)
    warm_x = warm_u = None
    strides = {"x0": x0_stride, "goal": goal_stride, "warm_x": 0, "warm_u": 0}
    if warm_states is not None:
        warm_x, strides["warm_x"] = _strided(warm_states, (B, N + 1, 3), dtype, device)
    if warm_controls is not None:
        warm_u, strides["warm_u"] = _strided(warm_controls, (B, N, 2), dtype, device)
    strides.update((name, s) for name, (_, s) in zip(ObstacleSet._fields, obs))

    (v_lb, v_ub), (w_lb, w_ub) = control_bounds
    lo, hi = state_bounds
    given = (v_lb, v_ub, w_lb, w_ub, lo, hi, inflation_radius, sensor_radius)
    if not all(isinstance(v, numbers.Real) and not isinstance(v, bool) for v in given):
        raise TypeError("the build kernel takes the bounds, the inflation and the sensor radius "
                        "as numbers (launch arguments)")
    inf = float("inf")
    params = _Params(
        B=B, N=N, K=K, K_all=K_all, repair=int(repair_warm_start_states),
        complete=int(complete_warm_start_states), passes=REPAIR_PASSES,
        dt=cfg.time_step, pred_dt=PREDICTION_DT if prediction_dt is None else prediction_dt,
        sensor_radius=sensor_radius, threshold=completion_threshold, margin=REPAIR_MARGIN,
        cl=(ctypes.c_double * 2)(v_lb, w_lb), cu=(ctypes.c_double * 2)(v_ub, w_ub),
        xl=(ctypes.c_double * 3)(lo, lo if cfg.bound_y else -inf, -inf),
        xu=(ctypes.c_double * 3)(hi, hi if cfg.bound_y else inf, inf),
        infl=inflation_radius,
    )
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    inputs = _Inputs(ptr(x0), ptr(goal), ptr(warm_x), ptr(warm_u), *(ptr(t) for t, _ in obs))
    kw = dict(dtype=dtype, device=device)
    out = Problem(
        initial_state=torch.empty((B, 3), **kw), goal_state=torch.empty((B, 3), **kw),
        control_lower=torch.empty((B, 2), **kw), control_upper=torch.empty((B, 2), **kw),
        state_lower=torch.empty((B, 3), **kw), state_upper=torch.empty((B, 3), **kw),
        obstacle_centers=torch.empty((B, K, N, 2), **kw), obstacle_radii=torch.empty((B, K), **kw),
        obstacle_mask=torch.empty((B, K), **kw), inflation_radius=torch.empty((B,), **kw),
        warm_states=torch.empty((B, N + 1, 3), **kw), warm_controls=torch.empty((B, N, 2), **kw),
    )
    # Global scratch only where one scenario's rows pass the card's shared
    # memory (long horizons).
    n_scratch = lib.kissmpc_build_scratch_bytes(ctypes.byref(params), out.initial_state.element_size())
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=device) if n_scratch else None
    fn = lib.kissmpc_build_f32 if dtype == torch.float32 else lib.kissmpc_build_f64
    err = fn(ctypes.byref(params), ctypes.byref(inputs),
             ctypes.byref(_Strides(*(strides[name] for name in STRIDED))),
             ctypes.byref(_Outputs(*(x.data_ptr() for x in out))), ptr(scratch), stream)
    _build.check_launch(lib, err, "problem build kernel")
    build_cuda.launches += 1
    return out


def occupancy(cfg, K_all: int, B: int = 1, dtype: torch.dtype = torch.float32) -> dict:
    """The build's launch shape on the current card for ``cfg`` and
    ``K_all`` obstacles per scenario: scenarios (warps) per block, dynamic
    shared bytes per block, whether the rows take the global scratch,
    resident scenarios per SM, registers and local (stack and spill) bytes
    per thread.  Builds the kernel; needs CUDA."""
    lib = _library()
    params = _Params(B=B, N=cfg.horizon, K=cfg.max_obstacles, K_all=K_all)
    out = (ctypes.c_int * 6)()
    elem = 4 if dtype == torch.float32 else 8
    _build.check_launch(lib, lib.kissmpc_build_occupancy(ctypes.byref(params), elem, out),
                        "problem build occupancy query")
    warps, smem, glob, blocks, regs, local = out
    return {"scenarios_per_block": warps, "smem_bytes_per_block": smem,
            "global_rows": bool(glob), "scenarios_per_sm": blocks * warps, "registers": regs,
            "local_bytes": local}


graph.counter(build_cuda)
