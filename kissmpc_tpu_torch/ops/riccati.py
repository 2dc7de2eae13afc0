"""Wrapper of the hand-written CUDA Riccati kernel (`csrc/riccati.cu`).

`solve_lqr_cuda(data, reg)` has the contract of `ops/lqr.py::solve_lqr`
(dx, du, and the gains K and k as views of the kernel's [B, N, 8] gains output).
It replaces the TPU kernel `kissmpc_tpu/ops/pallas/riccati.py`.
For tensors on the CPU it runs that plain version; for CUDA tensors it
launches the kernel or raises, and counts each launch in
``solve_lqr_cuda.launches``.

The kernel is built from the package's own source with ``nvcc`` at first
use (`ops/_build.py`), as a shared library with a plain C interface loaded
through ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import _build
from ..solver import graph
from .lqr import LQRData, LQRSolution, solve_lqr

SOURCE = _build.CSRC / "riccati.cu"


def build() -> Path:
    """Compile `csrc/riccati.cu` (once per source content); return the .so."""
    return _build.build(SOURCE, "kissmpc_riccati")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a loaded build of
    `csrc/riccati.cu` (this package's, or an edited copy's)."""
    args = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_void_p]
    for name in ("kissmpc_riccati_f32", "kissmpc_riccati_f64"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.kissmpc_riccati_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.kissmpc_riccati_smem_bytes.restype = ctypes.c_longlong
    lib.kissmpc_riccati_max_horizon.argtypes = [ctypes.c_int]
    lib.kissmpc_riccati_max_horizon.restype = ctypes.c_int
    lib.kissmpc_riccati_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.kissmpc_riccati_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE, "kissmpc_riccati"))


@functools.lru_cache(maxsize=None)
def max_horizon(dtype: torch.dtype) -> int:
    """The longest horizon N whose gains stay on chip in ``dtype``, the same
    at every batch: up to it the kernel keeps them in shared memory for the
    whole horizon, beside the staging ring, within the 227 KB a block may
    take on sm_90; above it the kernel's global-gains instance writes them
    to the output in the sweep and reads them back in the rollout.  Builds
    the kernel; needs nvcc."""
    return _library().kissmpc_riccati_max_horizon(4 if dtype == torch.float32 else 8)


def occupancy(Bsz: int, N: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch shape of a solve of B scenarios with horizon N on the
    current card: lanes per scenario, scenarios per block, dynamic shared
    memory per block, resident blocks and scenarios per SM, registers and
    local (spill) bytes per thread.  Builds the kernel; needs CUDA."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.kissmpc_riccati_occupancy(Bsz, N, 4 if dtype == torch.float32 else 8, out)
    _build.check_launch(lib, err, "Riccati occupancy query")
    lanes, per_block, smem, blocks, regs, local = out
    return {"lanes_per_scenario": lanes, "scenarios_per_block": per_block,
            "smem_bytes_per_block": smem, "blocks_per_sm": blocks,
            "scenarios_per_sm": per_block * blocks, "registers": regs, "local_bytes": local}


def _check(data: LQRData) -> tuple[int, int]:
    """Validate the batch the kernel takes; return (B, N)."""
    Bsz, N = data.A.shape[0], data.A.shape[1]
    expected = {
        "A": (Bsz, N, 3, 3), "B": (Bsz, N, 3, 2), "d": (Bsz, N, 3),
        "d0": (Bsz, 3), "Qxx": (Bsz, N + 1, 3, 3), "qx": (Bsz, N + 1, 3),
        "Quu": (Bsz, N, 2, 2), "qu": (Bsz, N, 2),
    }
    dtype, device = data.A.dtype, data.A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Riccati kernel takes float32 or float64, got {dtype}")
    for name, shape in expected.items():
        x = getattr(data, name)
        if tuple(x.shape) != shape:
            raise ValueError(f"LQRData.{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != dtype or x.device != device:
            raise TypeError(
                f"LQRData.{name} is {x.dtype} on {x.device}; expected {dtype} on {device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"LQRData.{name} must be contiguous")
    return Bsz, N


def solve_lqr_cuda(data: LQRData, reg: float = 0.0) -> LQRSolution:
    """Batched Riccati solve: CUDA kernel for CUDA tensors, plain torch on
    the CPU.  Returns dx [B, N+1, 3], du [B, N, 2], K [B, N, 2, 3], k [B, N, 2].

    Any horizon: at N <= ``max_horizon(dtype)`` the launcher takes the
    instance that keeps the gains in shared memory, above it the one that
    keeps them in the [B, N, 8] output (`csrc/riccati.cu`)."""
    Bsz, N = _check(data)
    device, dtype = data.A.device, data.A.dtype
    if device.type == "cpu":
        return solve_lqr(data, reg)
    if device.type != "cuda":
        raise ValueError(f"Riccati kernel runs on CUDA or CPU tensors, got {device}")
    lib = _library()
    fn = lib.kissmpc_riccati_f32 if dtype == torch.float32 else lib.kissmpc_riccati_f64
    dx = torch.empty((Bsz, N + 1, 3), dtype=dtype, device=device)
    du = torch.empty((Bsz, N, 2), dtype=dtype, device=device)
    gains = torch.empty((Bsz, N, 8), dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            data.A.data_ptr(), data.B.data_ptr(), data.d.data_ptr(),
            data.d0.data_ptr(), data.Qxx.data_ptr(), data.qx.data_ptr(),
            data.Quu.data_ptr(), data.qu.data_ptr(),
            dx.data_ptr(), du.data_ptr(), gains.data_ptr(),
            Bsz, N, float(reg), stream,
        )
    _build.check_launch(lib, err, "Riccati kernel")
    solve_lqr_cuda.launches += 1
    return LQRSolution(
        dx=dx, du=du, K=gains[..., :6].unflatten(-1, (2, 3)), k=gains[..., 6:]
    )


graph.counter(solve_lqr_cuda)
