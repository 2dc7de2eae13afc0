"""Wrapper of the trip-count probe kernel (`csrc/probe_dynamic_trip.cu`).

`dynamic_trip(x, iters)` adds 1.0 to every value of an [8, 128] float32
tile ``iters[0]`` times, with the count read by the kernel from device
memory.  It replaces the TPU probe `scripts/probe_dynamic_trip.py::kernel`
and checks the mechanism the fused IPM kernel's runtime iteration count
rests on.  For tensors on the CPU it runs the plain version; for CUDA
tensors it launches the kernel or raises, and counts each launch in
``dynamic_trip.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..solver import graph

SOURCE = _build.CSRC / "probe_dynamic_trip.cu"
SHAPE = (8, 128)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "kissmpc_probe")
    fn = lib.kissmpc_probe_dynamic_trip
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dynamic_trip_plain(x: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x + 1.0`` repeated ``iters[0]`` times."""
    out = x.clone()
    for _ in range(int(iters[0])):
        out += 1.0
    return out


def dynamic_trip(x: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """x [8, 128] float32, iters [1] int32 on the same device."""
    if tuple(x.shape) != SHAPE or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 {SHAPE}, got {x.dtype} {tuple(x.shape)}")
    if tuple(iters.shape) != (1,) or iters.dtype != torch.int32:
        raise ValueError(f"iters must be int32 [1], got {iters.dtype} {tuple(iters.shape)}")
    if x.device != iters.device:
        raise TypeError(f"x is on {x.device}, iters on {iters.device}")
    if not (x.is_contiguous() and iters.is_contiguous()):
        raise ValueError("x and iters must be contiguous")
    if x.device.type == "cpu":
        return dynamic_trip_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on CUDA or CPU tensors, got {x.device}")
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kissmpc_probe_dynamic_trip(
            iters.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(), stream
        )
    _build.check_launch(lib, err, "probe kernel")
    dynamic_trip.launches += 1
    return out


graph.counter(dynamic_trip)
