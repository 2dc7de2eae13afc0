"""Build and load one `csrc/*.cu` source as a plain-C shared library.

Every CUDA kernel of the port is compiled with ``nvcc`` for ``sm_90a`` at
first use into ``build/kissmpc_tpu_torch/`` at the repository root
(git-ignored) and loaded through ctypes.  No source includes PyTorch's
headers, so a build takes seconds.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kissmpc_tpu_torch"
# No --use_fast_math: the kernels' safety logic needs IEEE sqrt, log,
# sin, cos and division.  FMA contraction (nvcc's default) stays on.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build(source: Path, name: str, build_dir: Path = BUILD_DIR,
          flags: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` (once per content of the source and of the
    headers beside it, and per ``flags``, extra nvcc options after
    NVCC_FLAGS) to ``build_dir/lib<name>-<hash>.so``.

    The library name carries a hash of the source and the flags, so an
    edited kernel is rebuilt and a stale one is never loaded.  The compiler's register and
    spill report (``-Xptxas -v``) is kept beside it as ``.log``; the library
    appears by an atomic rename, so concurrent builds never load half a
    file.
    """
    # The shared headers (csrc/*.cuh) count as part of every source.
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    key = source.read_bytes() + headers + " ".join(flags).encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    lib = build_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


def load(source: Path, name: str, build_dir: Path = BUILD_DIR,
         flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; binds the shared error-string
    function every library exports."""
    lib = ctypes.CDLL(str(build(source, name, build_dir, flags)))
    lib.kissmpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kissmpc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        msg = lib.kissmpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
