"""The split IPM solve's four CUDA kernels (`csrc/ipm_split.cu`).

On the card a split solve is `init_cuda` (the first iterate and mu), then
per iteration three launches: `condense_cuda` (the condensed LQR model of
the iterate), the Riccati kernel (`ops/riccati.py::solve_lqr_cuda`) and
`step_cuda` (steps, fraction to the boundary, penalty weight, merit line
search, update, next mu), then `diagnostics_cuda` (the final mu and the
KKT residuals): 1 + 3 x iterations + 1 launches.  The step
kernel runs one block per scenario, of `step_warps(B, N, K)` warps: one
where the batch fills the card with small scenarios, four where scenarios
are large (K=8 at N=50) or the batch is small (the refine batches, the
node's batch of one).  They are
the port's counterpart of what XLA fuses of the reference's split
solve under `jax.jit` (`kissmpc_tpu/solver/ipm.py:180`, `:407-714`,
`:715`); there is no TPU kernel behind them.  Their plain versions are
`solver/ipm.py::init_plain`, `condense_plain`, `step_plain` and
`diagnostics_plain`.  The init and diagnostics kernels run one block of
four warps per scenario at every batch; the diagnostics take the stages
in chunks of a fixed size whatever the horizon, and its adjoint sweep runs
as suffix scans over each chunk (`diagnostics_occupancy`).

For tensors on the CPU each wrapper runs its plain version; for CUDA
tensors it launches its kernel or raises, and counts each launch in its
``.launches`` (registered with `graph.counter`, so a replay moves them by
the captured count).  The card path is `_init`, `_condense`, `_step` and
`_diagnostics` (each ``(lib, stream, ...)``): every
host value reaches the kernel as a launch argument made from ``cfg`` and
the shapes alone, so a CUDA graph captures it, and a CPU test can drive
it through a stand-in launcher or the g++ build of
`scripts/ipm_split_cpu_shim.py`.

The library is built from the package's own source with ``nvcc`` at first
use (`ops/_build.py`), as a shared library with a plain C interface loaded
through ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..config import MPCConfig
from ..solver import graph, ipm
from ..solver.problem import Diagnostics, Problem
from .lqr import LQRData, LQRSolution

SOURCE = _build.CSRC / "ipm_split.cu"
# Line-search candidates the step kernel keeps in registers (kMaxLs).
MAX_LS_ITERS = 8
CORR_FIELDS = ("cl", "cu", "xl", "xu", "ob")
# `ipm.IPMState`'s fields, in order (`solver/ipm.py` imports this module
# before it defines the class).
ITERATE_FIELDS = ("states", "controls", "s_cl", "s_cu", "s_xl", "s_xu", "s_ob", "nu_cl",
                  "nu_cu", "nu_xl", "nu_xu", "nu_ob", "e_ob", "reg", "sigma")


class _Params(ctypes.Structure):
    """Mirror of ``struct SplitParams`` in `csrc/ipm_split.cu`."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "N", "K", "ls_iters", "warps", "exclude_terminal", "reverse_squared", "curvature",
        "elastic", "adaptive_sigma", "raw_mu",
    )] + [(name, ctypes.c_double) for name in (
        "dt", "tau", "ls_backtrack", "merit_penalty", "reg", "rho_e", "w0", "w1", "w2",
        "w_neg", "w_pos", "w_ang", "mu_init", "mu_floor", "mu_sigma", "sigma_cap",
        "kkt_tol", "comp_tol",
    )]


def _pointers(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": [(f, ctypes.c_void_p) for f in fields]})


_ProblemPtrs = _pointers("_ProblemPtrs", Problem._fields[:10])
_IteratePtrs = _pointers("_IteratePtrs", ITERATE_FIELDS)
_LqrPtrs = _pointers("_LqrPtrs", LQRData._fields)
_CorrPtrs = _pointers("_CorrPtrs", CORR_FIELDS)
_StepOut = _pointers("_StepOut", ("mu", "alpha", "merit", "rho", "scratch"))
_DiagPtrs = _pointers("_DiagPtrs", Diagnostics._fields)

# Warps per scenario of the step kernel: one where the batch fills the card
# (ONE_WARP_MIN_BATCH: 8 one-warp blocks on each of the 132 SMs) and one
# warp's lanes take at most ONE_WARP_MAX_ELEMENTS / 32 elements each (the
# obstacle-free N=50 and the node's N=7 scenarios; K=8 at N=50 has 906),
# else SMALL_BATCH_WARPS.  `scripts/ipm_split_design_sweep.py` measured
# the choice: at B=8192 one warp is fastest for 104 elements and within 5%
# of the fastest for 506, four fastest for 906 and at every smaller batch.
SMS = 132
ONE_WARP_MIN_BATCH = SMS * 8
ONE_WARP_MAX_ELEMENTS = 512
SMALL_BATCH_WARPS = 4
MAX_WARPS = 4


def build():
    """Compile `csrc/ipm_split.cu` (once per source content); return the .so."""
    return _build.build(SOURCE, "kissmpc_ipm_split")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' signatures on a loaded build of ``SOURCE``
    (this package's, or the CPU shim's)."""
    ptr = ctypes.POINTER
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"kissmpc_split_condense_{dt}")
        fn.argtypes = [ptr(_Params), ptr(_ProblemPtrs), ptr(_IteratePtrs), ctypes.c_void_p,
                       ptr(_CorrPtrs), ptr(_LqrPtrs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"kissmpc_split_step_{dt}")
        fn.argtypes = ([ptr(_Params), ptr(_ProblemPtrs), ptr(_IteratePtrs)]
                       + [ctypes.c_void_p] * 5
                       + [ptr(_CorrPtrs), ptr(_IteratePtrs), ptr(_StepOut), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"kissmpc_split_init_{dt}")
        fn.argtypes = [ptr(_Params), ptr(_ProblemPtrs), ptr(_IteratePtrs), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"kissmpc_split_diagnostics_{dt}")
        fn.argtypes = [ptr(_Params), ptr(_ProblemPtrs), ptr(_IteratePtrs), ptr(_DiagPtrs),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.kissmpc_split_step_scratch_bytes.argtypes = [ctypes.c_int] * 7
    lib.kissmpc_split_step_scratch_bytes.restype = ctypes.c_longlong
    lib.kissmpc_split_step_occupancy.argtypes = [ptr(_Params), ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
    lib.kissmpc_split_step_occupancy.restype = ctypes.c_int
    lib.kissmpc_split_diagnostics_occupancy.argtypes = [ptr(_Params), ctypes.c_int,
                                                        ctypes.c_void_p]
    lib.kissmpc_split_diagnostics_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE, "kissmpc_ipm_split"))


def step_warps(B: int, N: int, K: int) -> int:
    """Warps per scenario of the step kernel for ``B`` scenarios of horizon
    ``N`` with ``K`` obstacles: one where the batch fills the card and the
    scenario has at most ONE_WARP_MAX_ELEMENTS constraint entries, else
    SMALL_BATCH_WARPS."""
    elements = 10 * N + 6 + N * K  # box entries of the four families, obstacle rows
    if B >= ONE_WARP_MIN_BATCH and elements <= ONE_WARP_MAX_ELEMENTS:
        return 1
    return SMALL_BATCH_WARPS


def _params(cfg: MPCConfig, B: int, dtype: torch.dtype, warps: int = 1) -> _Params:
    """The kernels' runtime parameters: ``cfg``, the batch and the step's
    warps per scenario alone."""
    sc, cc = cfg.solver, cfg.cost
    w0, w1, w2 = cc.goal_weights
    kkt_tol, comp_tol = ipm._kkt_tols(cfg, dtype)
    return _Params(
        B=B, N=cfg.horizon, K=cfg.max_obstacles, ls_iters=sc.ls_iters, warps=warps,
        exclude_terminal=int(cc.goal_cost_mode == "exclude_terminal"),
        reverse_squared=int(cc.reverse_penalty_mode == "squared"),
        curvature=int(sc.obstacle_curvature),
        elastic=int(sc.elastic_obstacles and cfg.max_obstacles > 0),
        adaptive_sigma=int(sc.mu_sigma_max > 0.0),
        raw_mu=int(sc.mehrotra == "pc"),
        dt=cfg.time_step, tau=sc.tau, ls_backtrack=sc.ls_backtrack,
        merit_penalty=sc.merit_penalty, reg=sc.reg, rho_e=sc.elastic_penalty,
        w0=w0, w1=w1, w2=w2, w_neg=cc.negative_velocity_weight,
        w_pos=cc.positive_velocity_weight, w_ang=cc.angular_velocity_weight,
        mu_init=sc.mu_init, mu_floor=ipm._mu_floor(cfg, dtype), mu_sigma=sc.mu_sigma,
        sigma_cap=max(sc.mu_sigma_max, sc.mu_sigma),
        kkt_tol=kkt_tol, comp_tol=comp_tol,
    )


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, device) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != dtype or x.device != device:
        raise TypeError(f"{name} is {x.dtype} on {x.device}; expected {dtype} on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_problem(cfg: MPCConfig, problem: Problem, B: int, dtype, device,
                   warm: bool = False) -> None:
    """Validate the Problem's leaves the kernels read (with ``warm``, the
    warm start too)."""
    N, K = cfg.horizon, cfg.max_obstacles
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the split kernels run on CUDA or CPU tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the split kernels take float32 or float64, got {dtype}")
    problem_shapes = {
        "initial_state": (B, 3), "goal_state": (B, 3), "control_lower": (B, 2),
        "control_upper": (B, 2), "state_lower": (B, 3), "state_upper": (B, 3),
        "obstacle_centers": (B, K, N, 2), "obstacle_radii": (B, K), "obstacle_mask": (B, K),
        "inflation_radius": (B,),
    }
    if warm:
        problem_shapes.update(warm_states=(B, N + 1, 3), warm_controls=(B, N, 2))
    for name, shape in problem_shapes.items():
        _check(f"Problem.{name}", getattr(problem, name), shape, dtype, device)


def _family_shapes(cfg: MPCConfig, B: int) -> dict:
    """Shape of each constraint family's rows (slacks, duals, corrections)."""
    N, K = cfg.horizon, cfg.max_obstacles
    return {"cl": (B, N, 2), "cu": (B, N, 2), "xl": (B, N + 1, 3), "xu": (B, N + 1, 3),
            "ob": (B, N, K)}


def _check_iterate(cfg: MPCConfig, it, B: int, dtype, device) -> None:
    N, K = cfg.horizon, cfg.max_obstacles
    row = _family_shapes(cfg, B)
    state_shapes = {"states": (B, N + 1, 3), "controls": (B, N, 2), "e_ob": (B, N, K),
                    "reg": (B,), "sigma": (B,),
                    **{f"s_{f}": row[f] for f in CORR_FIELDS},
                    **{f"nu_{f}": row[f] for f in CORR_FIELDS}}
    for name, shape in state_shapes.items():
        _check(f"IPMState.{name}", getattr(it, name), shape, dtype, device)


def _check_inputs(cfg: MPCConfig, problem: Problem, it, mu, corr) -> tuple:
    """Validate what the condensation and the step read; return (B, dtype,
    device)."""
    B = it.states.shape[0]
    dtype, device = it.states.dtype, it.states.device
    _check_problem(cfg, problem, B, dtype, device)
    if not 1 <= cfg.solver.ls_iters <= MAX_LS_ITERS:
        raise ValueError(f"the step kernel takes 1 to {MAX_LS_ITERS} line-search candidates, "
                         f"got ls_iters={cfg.solver.ls_iters}")
    row = _family_shapes(cfg, B)
    _check_iterate(cfg, it, B, dtype, device)
    _check("mu", mu, (B,), dtype, device)
    if corr is not None:
        for f in CORR_FIELDS:
            _check(f"corr.{f}", getattr(corr, f), row[f], dtype, device)
    return B, dtype, device


def _structs(problem: Problem, it, corr):
    return (_ProblemPtrs(*(x.data_ptr() for x in problem[:10])),
            _IteratePtrs(*(x.data_ptr() for x in it)),
            _CorrPtrs(*((getattr(corr, f).data_ptr() for f in CORR_FIELDS)
                        if corr is not None else [None] * 5)))


def condense_cuda(cfg: MPCConfig, problem: Problem, it, mu: torch.Tensor,
                  corr=None) -> LQRData:
    """The condensed LQR model of the iterate ``it`` at the barrier ``mu``
    ([B]), with the Mehrotra correction rows ``corr`` if given: the
    condensation kernel for CUDA tensors, `ipm.condense_plain` on the CPU.
    The eight tensors come out contiguous, as the Riccati kernel reads
    them."""
    _, _, device = _check_inputs(cfg, problem, it, mu, corr)
    if device.type == "cpu":
        return ipm.condense_plain(cfg, problem, it, mu, corr)
    with torch.cuda.device(device):
        return _condense(_library(), torch.cuda.current_stream(device).cuda_stream,
                         cfg, problem, it, mu, corr)


def _condense(lib, stream: int, cfg: MPCConfig, problem: Problem, it, mu, corr=None) -> LQRData:
    """Allocate the LQRData and launch the condensation on ``stream``
    through ``lib``."""
    N, B = cfg.horizon, it.states.shape[0]
    dtype = it.states.dtype
    kw = dict(dtype=dtype, device=it.states.device)
    out = LQRData(
        A=torch.empty((B, N, 3, 3), **kw), B=torch.empty((B, N, 3, 2), **kw),
        d=torch.empty((B, N, 3), **kw), d0=torch.empty((B, 3), **kw),
        Qxx=torch.empty((B, N + 1, 3, 3), **kw), qx=torch.empty((B, N + 1, 3), **kw),
        Quu=torch.empty((B, N, 2, 2), **kw), qu=torch.empty((B, N, 2), **kw),
    )
    pr, ip, cp = _structs(problem, it, corr)
    fn = lib.kissmpc_split_condense_f32 if dtype == torch.float32 else lib.kissmpc_split_condense_f64
    err = fn(ctypes.byref(_params(cfg, B, dtype)), ctypes.byref(pr), ctypes.byref(ip),
             mu.data_ptr(), ctypes.byref(cp), ctypes.byref(_LqrPtrs(*(x.data_ptr() for x in out))),
             stream)
    _build.check_launch(lib, err, "split condensation kernel")
    condense_cuda.launches += 1
    return out


def _check_solution(cfg: MPCConfig, data: LQRData, sol: LQRSolution, B, dtype, device) -> None:
    N = cfg.horizon
    _check("LQRData.qx", data.qx, (B, N + 1, 3), dtype, device)
    _check("LQRData.A", data.A, (B, N, 3, 3), dtype, device)
    _check("LQRSolution.dx", sol.dx, (B, N + 1, 3), dtype, device)
    _check("LQRSolution.du", sol.du, (B, N, 2), dtype, device)


def step_cuda(cfg: MPCConfig, problem: Problem, it, mu: torch.Tensor, data: LQRData,
              sol: LQRSolution, corr=None):
    """The iteration after the Newton-KKT solve ``sol`` of ``data``: the
    step kernel for CUDA tensors, `ipm.step_plain` on the CPU.  Returns an
    `ipm.Step` (the new iterate, the next iteration's mu, the accepted step
    length)."""
    B, dtype, device = _check_inputs(cfg, problem, it, mu, corr)
    _check_solution(cfg, data, sol, B, dtype, device)
    if device.type == "cpu":
        return ipm.step_plain(cfg, problem, it, mu, data, sol, corr)
    with torch.cuda.device(device):
        return _step(_library(), torch.cuda.current_stream(device).cuda_stream,
                     cfg, problem, it, mu, data, sol, corr)


def _step(lib, stream: int, cfg: MPCConfig, problem: Problem, it, mu, data: LQRData,
          sol: LQRSolution, corr=None, merits: bool = False, warps: int | None = None):
    """Allocate the new iterate and launch the step on ``stream`` through
    ``lib``, with ``warps`` per scenario (`step_warps` unless given).
    Returns an `ipm.Step`; with ``merits``, the pair (`ipm.Step`,
    `ipm.Merits`), as `ipm.step_plain` does."""
    B, dtype = it.states.shape[0], it.states.dtype
    N, K = cfg.horizon, cfg.max_obstacles
    warps = step_warps(B, N, K) if warps is None else warps
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"the step kernel takes 1 to {MAX_WARPS} warps per scenario, got {warps}")
    params = _params(cfg, B, dtype, warps)
    new = ipm.IPMState(*(torch.empty_like(x) for x in it))
    mu_next = torch.empty_like(mu)
    alpha = torch.empty_like(mu)
    kw = dict(dtype=dtype, device=mu.device)
    merit = torch.empty((B, 1 + cfg.solver.ls_iters), **kw) if merits else None
    rho = torch.empty((B,), **kw) if merits else None
    per = lib.kissmpc_split_step_scratch_bytes(N, K, params.elastic, int(corr is not None),
                                               mu.element_size(), warps, params.ls_iters)
    scratch = torch.empty((B * per,), dtype=torch.uint8, device=mu.device) if per else None
    so = _StepOut(*(x.data_ptr() if x is not None else None
                    for x in (mu_next, alpha, merit, rho, scratch)))
    pr, ip, cp = _structs(problem, it, corr)
    fn = lib.kissmpc_split_step_f32 if dtype == torch.float32 else lib.kissmpc_split_step_f64
    err = fn(ctypes.byref(params), ctypes.byref(pr), ctypes.byref(ip),
             mu.data_ptr(), data.qx.data_ptr(), data.A.data_ptr(), sol.dx.data_ptr(),
             sol.du.data_ptr(), ctypes.byref(cp),
             ctypes.byref(_IteratePtrs(*(x.data_ptr() for x in new))), ctypes.byref(so), stream)
    _build.check_launch(lib, err, "split step kernel")
    step_cuda.launches += 1
    out = ipm.Step(new, mu_next, alpha)
    return (out, ipm.Merits(merit, rho)) if merits else out


def init_cuda(cfg: MPCConfig, problem: Problem):
    """The solve's first iterate and mu from the warm start of ``problem``:
    the init kernel for CUDA tensors, `ipm.init_plain` on the CPU.  Returns
    (`ipm.IPMState`, mu [B]); the iterate's trajectory is the warm start's
    tensors, as `ipm.init_plain`'s is."""
    B = problem.initial_state.shape[0]
    dtype, device = problem.initial_state.dtype, problem.initial_state.device
    _check_problem(cfg, problem, B, dtype, device, warm=True)
    if device.type == "cpu":
        return ipm.init_plain(cfg, problem)
    with torch.cuda.device(device):
        return _init(_library(), torch.cuda.current_stream(device).cuda_stream, cfg, problem)


def _init(lib, stream: int, cfg: MPCConfig, problem: Problem):
    """Allocate the first iterate and mu and launch the init on ``stream``
    through ``lib``."""
    B, dtype = problem.initial_state.shape[0], problem.initial_state.dtype
    N, K = cfg.horizon, cfg.max_obstacles
    kw = dict(dtype=dtype, device=problem.initial_state.device)
    row = lambda *shape: torch.empty((B, *shape), **kw)  # noqa: E731
    it = ipm.IPMState(problem.warm_states, problem.warm_controls,
                      row(N, 2), row(N, 2), row(N + 1, 3), row(N + 1, 3), row(N, K),
                      row(N, 2), row(N, 2), row(N + 1, 3), row(N + 1, 3), row(N, K),
                      row(N, K), row(), row())
    mu = row()
    pr, ip, _ = _structs(problem, it, None)
    fn = lib.kissmpc_split_init_f32 if dtype == torch.float32 else lib.kissmpc_split_init_f64
    err = fn(ctypes.byref(_params(cfg, B, dtype)), ctypes.byref(pr), ctypes.byref(ip),
             mu.data_ptr(), stream)
    _build.check_launch(lib, err, "split init kernel")
    init_cuda.launches += 1
    return it, mu


def diagnostics_cuda(cfg: MPCConfig, problem: Problem, it) -> Diagnostics:
    """The solve's `Diagnostics` at the last iterate ``it`` (the final mu and
    the KKT residuals): the diagnostics kernel for CUDA tensors,
    `ipm.diagnostics_plain` on the CPU."""
    B, dtype, device = it.states.shape[0], it.states.dtype, it.states.device
    _check_problem(cfg, problem, B, dtype, device)
    _check_iterate(cfg, it, B, dtype, device)
    if device.type == "cpu":
        return ipm.diagnostics_plain(cfg, problem, it)
    with torch.cuda.device(device):
        return _diagnostics(_library(), torch.cuda.current_stream(device).cuda_stream, cfg,
                            problem, it)


def _diagnostics(lib, stream: int, cfg: MPCConfig, problem: Problem, it) -> Diagnostics:
    """Allocate the Diagnostics and launch the diagnostics on ``stream``
    through ``lib``."""
    B, dtype = it.states.shape[0], it.states.dtype
    kw = dict(dtype=dtype, device=it.states.device)
    out = Diagnostics(torch.empty((B,), dtype=torch.bool, device=it.states.device),
                      *(torch.empty((B,), **kw) for _ in range(5)))
    pr, ip, _ = _structs(problem, it, None)
    fn = (lib.kissmpc_split_diagnostics_f32 if dtype == torch.float32
          else lib.kissmpc_split_diagnostics_f64)
    err = fn(ctypes.byref(_params(cfg, B, dtype)), ctypes.byref(pr), ctypes.byref(ip),
             ctypes.byref(_DiagPtrs(*(x.data_ptr() for x in out))), stream)
    _build.check_launch(lib, err, "split diagnostics kernel")
    diagnostics_cuda.launches += 1
    return out


def step_occupancy(cfg: MPCConfig, B: int, dtype: torch.dtype = torch.float32,
                   corr: bool = False, warps: int | None = None) -> dict:
    """The launch shape of a step of ``B`` scenarios of ``cfg`` on the
    current card: warps per scenario, dynamic shared bytes per block,
    whether the arena is global, resident scenarios per SM, registers and
    local (stack and spill) bytes per thread.  Builds the kernel; needs
    CUDA."""
    N, K = cfg.horizon, cfg.max_obstacles
    warps = step_warps(B, N, K) if warps is None else warps
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.kissmpc_split_step_occupancy(ctypes.byref(_params(cfg, B, dtype, warps)),
                                           int(corr), 4 if dtype == torch.float32 else 8, out)
    _build.check_launch(lib, err, "split step occupancy query")
    w, smem, glob, blocks, regs, local = out
    return {"warps_per_scenario": w, "smem_bytes_per_block": smem, "global_arena": bool(glob),
            "scenarios_per_sm": blocks, "registers": regs, "local_bytes": local}


def diagnostics_occupancy(cfg: MPCConfig, B: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch shape of a diagnostics launch of ``B`` scenarios of
    ``cfg`` on the current card: warps per scenario, stages per chunk,
    dynamic shared bytes per block, resident blocks per SM (each block one
    scenario), registers and local (stack and spill) bytes per thread.
    Builds the kernel; needs CUDA."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.kissmpc_split_diagnostics_occupancy(ctypes.byref(_params(cfg, B, dtype)),
                                                  4 if dtype == torch.float32 else 8, out)
    _build.check_launch(lib, err, "split diagnostics occupancy query")
    warps, chunk, smem, blocks, regs, local = out
    return {"warps_per_scenario": warps, "chunk_stages": chunk, "smem_bytes_per_block": smem,
            "scenarios_per_sm": blocks, "registers": regs, "local_bytes": local}


graph.counter(init_cuda)
graph.counter(condense_cuda)
graph.counter(step_cuda)
graph.counter(diagnostics_cuda)
