"""ctypes bindings for the native (C++) host components, with lazy build.

A port-owned copy of `kissmpc_tpu/native/` (its `edt.cpp` and
`mailbox.cpp` sit beside this file unchanged but for their header notes).
The shared library is compiled with g++ on first use into
``build/kissmpc_tpu_torch/native/`` at the repository root (git-ignored),
never next to the sources; its name carries a hash of the sources, so an
edited source is rebuilt and a stale library never loaded.  These are
host-side map tools, not device kernels: where g++ is missing, `load`
returns None and callers fall back to the numpy oracle in
`obstacles/mapping.py`, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = (_HERE / "edt.cpp", _HERE / "mailbox.cpp")
BUILD_DIR = _HERE.parents[1] / "build" / "kissmpc_tpu_torch" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in _SRCS)).hexdigest()[:12]
    return BUILD_DIR / f"libkissmpc_native-{digest}.so"


def _build(lib: Path) -> bool:
    """Compile the sources to ``lib``; it appears by an atomic rename, so a
    concurrent build never loads half a file."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *map(str, _SRCS), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    os.replace(tmp, lib)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.kissmpc_edt.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.kissmpc_edt.restype = None
        lib.kissmpc_pack_circles.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.kissmpc_pack_circles.restype = ctypes.c_int
        lib.kissmpc_mailbox_create.argtypes = [ctypes.c_int64]
        lib.kissmpc_mailbox_create.restype = ctypes.c_void_p
        lib.kissmpc_mailbox_destroy.argtypes = [ctypes.c_void_p]
        lib.kissmpc_mailbox_destroy.restype = None
        lib.kissmpc_mailbox_publish.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.kissmpc_mailbox_publish.restype = ctypes.c_uint64
        lib.kissmpc_mailbox_read.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.kissmpc_mailbox_read.restype = ctypes.c_uint64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def edt(foreground: np.ndarray) -> Optional[np.ndarray]:
    """Native exact EDT; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    fg = np.ascontiguousarray(foreground != 0, dtype=np.uint8)
    h, w = fg.shape
    out = np.empty((h, w), dtype=np.float32)
    lib.kissmpc_edt(
        fg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def pack_circles_from_dist(
    dist: np.ndarray, min_radius: float, max_circles: int
):
    """Native greedy packing on a distance transform; None if unavailable.

    Mutates a copy of ``dist``; returns (centers [M, 2] (x, y), radii [M]).
    """
    lib = load()
    if lib is None:
        return None
    d = np.ascontiguousarray(dist, dtype=np.float32).copy()
    h, w = d.shape
    centers = np.empty((max_circles, 2), dtype=np.float32)
    radii = np.empty((max_circles,), dtype=np.float32)
    n = lib.kissmpc_pack_circles(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h,
        w,
        ctypes.c_float(min_radius),
        max_circles,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        radii.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return centers[:n].astype(np.float64), radii[:n].astype(np.float64)


class Mailbox:
    """Native seqlock mailbox for fixed-capacity float payloads.

    Single-writer / any-reader, lock-free (mailbox.cpp): publish never
    blocks, read never observes a torn payload, and the critical section
    runs outside the GIL.  ``None`` from `create` means the native
    toolchain is unavailable.
    """

    def __init__(self, lib, handle, capacity: int):
        self._lib = lib
        self._h = handle
        self._cap = capacity
        self._out = np.empty((capacity,), dtype=np.float64)
        self._n = ctypes.c_int64(0)

    @staticmethod
    def create(capacity: int) -> Optional["Mailbox"]:
        lib = load()
        if lib is None:
            return None
        h = lib.kissmpc_mailbox_create(ctypes.c_int64(capacity))
        if not h:
            return None
        return Mailbox(lib, h, capacity)

    def publish(self, data: np.ndarray) -> int:
        flat = np.ascontiguousarray(data, dtype=np.float64).reshape(-1)
        if flat.size > self._cap:
            raise ValueError(f"payload of {flat.size} values exceeds capacity {self._cap}")
        return int(
            self._lib.kissmpc_mailbox_publish(
                self._h,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(flat.size),
            )
        )

    def read(self):
        """-> (payload copy [n] | None, version)."""
        v = int(
            self._lib.kissmpc_mailbox_read(
                self._h,
                self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.byref(self._n),
            )
        )
        if v == 0:
            return None, 0
        return self._out[: self._n.value].copy(), v

    def close(self) -> None:
        if self._h:
            self._lib.kissmpc_mailbox_destroy(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the explicit path
        try:
            self.close()
        except Exception:
            pass
