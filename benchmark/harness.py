"""The harness: one cell, one run, one JSON line.

It loads the cell (`workloads/<cell>.json`), its configuration
(`configs/<config>.json`) and its traffic driver (`traffic/<driver>.py`)
by name, lets the driver set up and warm every shape it uses (the set-up),
measures closed-loop for the window, reads the device's peak memory, has
the driver compare what the timed path produced with the plain reference,
and prints the result.  With ``trace`` a steady stretch of the window is
profiled and each per-layer metric's reader (`metrics/<metric>.py`) reads
it.  Nothing here imports JAX, the JAX package or the port: the drivers
import the port.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

from . import traces

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "kissmpc_tpu")
# ... and that the plain reference may not import.
REFERENCE_FORBIDDEN = FORBIDDEN + ("kissmpc_tpu_torch",)
# The traced stretch starts this far into the window.
TRACE_FROM = 0.25


class BenchError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as exc:
        raise BenchError(f"{path.relative_to(ROOT)} is missing") from exc


def load_cell(name: str) -> tuple[dict, dict]:
    """(cell, config) of the cell named ``name``."""
    cell = read_json(BENCH / "workloads" / f"{name}.json")
    if cell.get("name") != name:
        raise BenchError(f"workloads/{name}.json names the cell {cell.get('name')!r}")
    config = read_json(BENCH / "configs" / f"{cell['config']}.json")
    if config.get("name") != cell["config"]:
        raise BenchError(f"configs/{cell['config']}.json names {config.get('name')!r}")
    return cell, config


def load_module(folder: str, name: str):
    """The module in ``folder/<name>.py`` (names may hold dots)."""
    path = BENCH / folder / f"{name}.py"
    if not path.exists():
        raise BenchError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def imported_top_levels(path: Path) -> set[str]:
    """The top-level names of every absolute import in a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_imports_ok() -> list[str]:
    """Files of the plain reference that import what it may not."""
    bad = []
    for path in sorted((BENCH / "reference").glob("*.py")):
        found = imported_top_levels(path) & set(REFERENCE_FORBIDDEN)
        if found:
            bad.append(f"{path.name}: {sorted(found)}")
    return bad


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between ranks, as
    numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise BenchError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Window(NamedTuple):
    """What the measured window saw: every timed call's seconds, the
    window's seconds, and with a trace its stretch, the stretch's first
    call, the seconds of each of its calls, and the seconds from its start
    to the end of reading the trace (the profiler's own cost with it)."""

    times: list
    seconds: float
    trace: traces.Trace | None
    trace_first: int
    trace_times: list
    trace_seconds: float = 0.0

    def untraced(self) -> tuple[list, float]:
        """(the timed seconds of the calls outside the traced stretch, the
        window's seconds per call outside it): the calls as the profiler
        leaves them, for a traced run's per-layer readings."""
        n = len(self.trace_times)
        times = self.times[:self.trace_first] + self.times[self.trace_first + n:]
        if not times:
            return [], 0.0
        return times, (self.seconds - self.trace_seconds) / len(times)


def run_window(step, seconds: float, trace: bool = False, trace_calls: int = 20) -> Window:
    """Call ``step(i)`` back to back for ``seconds``; each returns the
    seconds of its timed part.  The window ends with the first call that
    ends past ``seconds``.  With ``trace``, ``trace_calls`` calls from
    TRACE_FROM of the window on are profiled, each after a marker, and the
    window lasts at least until they are."""
    times, prof, traced, first, i, began, spent = [], None, None, 0, 0, 0.0, 0.0
    start = time.perf_counter()
    while True:
        if trace and prof is None and traced is None \
                and time.perf_counter() - start >= TRACE_FROM * seconds:
            began = time.perf_counter()
            prof, first = traces.begin(), i
        if prof is not None:
            traces.mark()
        times.append(step(i))
        i += 1
        if prof is not None and i - first >= trace_calls:
            traced, prof = traces.finish(prof), None
            spent = time.perf_counter() - began
        if time.perf_counter() - start >= seconds and (not trace or traced is not None):
            break
    elapsed = time.perf_counter() - start
    stretch = times[first:first + trace_calls] if traced is not None else []
    return Window(times, elapsed, traced, first, stretch, spent)


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else \
        f"not read (nvidia-smi exit {out.returncode})"


class Run(NamedTuple):
    """What a per-layer metric's reader is given."""

    cell: dict
    config: dict
    driver: object
    window: Window
