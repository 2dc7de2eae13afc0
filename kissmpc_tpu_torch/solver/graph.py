"""CUDA graphs: the port's counterpart of `jax.jit` on the single-robot path.

The reference compiles `make_solver` (`kissmpc_tpu/solver/api.py:26`), the
node's tick (`kissmpc_tpu/io/model.py:97`) and the CLI `demo` stepper
(`kissmpc_tpu/cli.py:47`) into one device program each.  Here each of them
calls `run(key, fn, device, *inputs)`, which returns ``fn`` of the inputs
moved to ``device``:

- on the CPU, and inside `eager()`, by calling ``fn``;
- on the card, the first call for a key and input signature (every input's
  shape and dtype) runs ``fn`` once on a side stream (the warm-up: it loads
  the kernels' libraries, sets their launch attributes and creates the
  cuBLAS handle and workspace, outside any capture), returns that result,
  and captures ``fn`` on the same stream into a `torch.cuda.CUDAGraph`
  under the default capture error mode; every later call copies its inputs
  into the graph's static inputs, replays the graph and returns clones of
  its static outputs, so a result the caller keeps never changes.

``fn`` must be a function of its tensor inputs alone for a given key (the
key names whatever else it closes over: a config, a dtype), must return a
tree of tensors (`_tree.py`), and must not synchronise with the host: a
capture that meets a synchronisation raises, and nothing falls back to the
eager path.  The graphs live for the process, one cache for every caller
(`agent.step` makes a new solver every tick), like `jax.jit`'s cache of
compiled shapes.  The graphs of one device share one memory pool: a graph
may write its intermediates where another keeps its static outputs, which
is safe because every replay runs on the caller's stream and its outputs
are cloned before anything else is enqueued.  Not thread-safe: one thread
drives the card.

The kernels' wrappers count their launches in Python (``.launches``),
which a replay does not run: `run` records how far each counter moved
while ``fn`` was being captured, puts it back (a capture launches
nothing), and adds that amount on every replay.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Hashable, NamedTuple

import torch

from .._tree import leaves, tree_map
from ..ops.ipm_fused import solve_batch_fused
from ..ops.riccati import solve_lqr_cuda

# The solver kernels' wrappers, which count their launches.
COUNTED = (solve_lqr_cuda, solve_batch_fused)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static inputs the replay reads
    outputs: Any  # the tree of static outputs it writes
    launches: tuple  # per COUNTED wrapper, its launches in one replay


_GRAPHS: dict = {}
_POOLS: dict = {}  # device -> the memory pool its graphs share
_STREAMS: dict = {}  # device -> the side stream of warm-ups and captures
_EAGER = False


@contextlib.contextmanager
def eager():
    """Run every `run` in the block as the eager stream of ops, on the card
    too: for holding a replay against the ops it captured."""
    global _EAGER
    before, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = before


def captured() -> int:
    """How many graphs the process holds."""
    return len(_GRAPHS)


def run(key: Hashable, fn: Callable, device: torch.device, *inputs: torch.Tensor):
    """``fn(*inputs)`` with the inputs moved to ``device``: captured once per
    (key, device, input shapes and dtypes) and replayed on the card."""
    device = torch.device(device)
    if device.type != "cuda" or _EAGER:
        return fn(*(x.to(device) for x in inputs))
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sig = (key, device, tuple((tuple(x.shape), x.dtype) for x in inputs))
    entry = _GRAPHS.get(sig)
    if entry is None:
        result, _GRAPHS[sig] = _capture(fn, device, inputs)
        return result
    for dst, src in zip(entry.inputs, inputs):
        dst.copy_(src, non_blocking=True)
    entry.graph.replay()
    for wrapper, n in zip(COUNTED, entry.launches):
        wrapper.launches += n
    return tree_map(torch.clone, entry.outputs)


def _capture(fn: Callable, device: torch.device, inputs) -> tuple:
    """Warm ``fn`` up on the side stream, then capture it there; returns the
    warm-up's result and the graph."""
    static = [torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs]
    for dst, src in zip(static, inputs):
        dst.copy_(src, non_blocking=True)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
        _POOLS[device] = torch.cuda.graph_pool_handle()
    side, caller = _STREAMS[device], torch.cuda.current_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        result = tree_map(torch.clone, fn(*static))
    before = [w.launches for w in COUNTED]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_POOLS[device], stream=side):
        outputs = fn(*static)
    launches = tuple(w.launches - b for w, b in zip(COUNTED, before))
    for wrapper, b in zip(COUNTED, before):
        wrapper.launches = b
    caller.wait_stream(side)
    for x in leaves(result):
        x.record_stream(caller)
    return result, _Graph(graph, static, outputs, launches)

