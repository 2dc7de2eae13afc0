"""CUDA graphs: the port's counterpart of `jax.jit`.

The reference compiles its entry points into one device program each:
`make_solver` and `make_batch_solver` (`kissmpc_tpu/solver/api.py:26,151`),
the node's tick (`kissmpc_tpu/io/model.py:97`), the CLI `demo` and `lab`
steppers (`kissmpc_tpu/cli.py:47,128`), the data-parallel fleet solver and
stepper (`kissmpc_tpu/parallel/fleet.py:78,116`), the planner's two
fields (`kissmpc_tpu/planner.py:77,300`) and the pool builder
(`kissmpc_tpu/scenarios.py:182`).  Here each of them calls
`run(key, fn, device, *inputs)`, which returns ``fn`` of the inputs moved
to ``device``:

- on the CPU, and inside `eager()`, by calling ``fn`` (after freezing and
  hashing the key, as the card's path does);
- on the card, the first call for a key and input signature (every input's
  shape and dtype) runs ``fn`` once on a side stream (the warm-up: it loads
  the kernels' libraries, sets their launch attributes and creates the
  cuBLAS handle and workspace, outside any capture), returns that result,
  and captures ``fn`` on the same stream into a `torch.cuda.CUDAGraph`
  under the default capture error mode; every later call copies its inputs
  into the graph's static inputs, replays the graph and returns clones of
  its static outputs, so a result the caller keeps never changes.

``fn`` must be a function of its tensor inputs alone for a given key (the
key names whatever else it closes over: a config, a dtype; `freeze` makes
lists in it tuples, and a key that stays unhashable raises), must return a
tree of tensors (`_tree.py`), and must not synchronise with the host: a
capture that meets a synchronisation raises, and nothing falls back to the
eager path.  The graphs live for the process, one cache for every caller
(`agent.step` makes a new solver every tick), like `jax.jit`'s cache of
compiled shapes.  The graphs of one device share one memory pool (a new
one after a capture that raised, `_recover`): a graph may write its
intermediates where another keeps its static outputs, which is safe
because every replay runs on the caller's stream and its outputs are
cloned before anything else is enqueued.  Not thread-safe: one thread
drives the card.

Some host code inside a region counts what it enqueues: the kernels'
wrappers their launches (``.launches``), the fleet's metric reduction its
collectives (``.collectives``).  A replay runs no Python, so each such
counter registers itself with `counter`, and `run` records how far each
moved while ``fn`` was being captured, puts it back (a capture launches
nothing), and adds that amount on every replay.

`run` opens the span ``graph.run`` on every path and, on the card,
``graph.capture`` around a first call or ``graph.copy_in``,
``graph.replay`` and ``graph.clone_out`` around the steps of a later one
(`utils/profiling.py::annotate`); a captured region holds no span.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Hashable, NamedTuple

import torch

from .._tree import leaves, tree_map
from ..utils.profiling import annotate

# (holder, attribute) of every registered counter, in registration order.
COUNTERS: list = []


def counter(holder, attr: str = "launches") -> None:
    """Register ``holder.<attr>``, set to 0, as a count that host code inside
    a captured region moves: every replay adds what the capture counted."""
    setattr(holder, attr, 0)
    COUNTERS.append((holder, attr))


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static inputs the replay reads
    outputs: Any  # the tree of static outputs it writes
    counts: tuple  # per registered counter, how far one replay moves it


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


def captured(name: str | None = None) -> int:
    """How many graphs the process holds (whose key starts with ``name``)."""
    return sum(1 for sig in _GRAPHS if name is None or sig[0][0] == name)


def freeze(key: Any) -> Hashable:
    """``key`` with every list and tuple made a tuple, recursively, the
    fields of a dataclass (a config, `AgentParams`) included: keys equal in
    value freeze equal, so a config given lists shares its graph with its
    twin given tuples.  The configs themselves keep what they were given,
    as the reference's do."""
    if isinstance(key, (list, tuple)):
        return tuple(freeze(x) for x in key)
    if dataclasses.is_dataclass(key) and not isinstance(key, type):
        return (type(key), *((f.name, freeze(getattr(key, f.name)))
                             for f in dataclasses.fields(key)))
    return key


def run(key: Hashable, fn: Callable, device: torch.device, *inputs: torch.Tensor):
    """``fn(*inputs)`` with the inputs moved to ``device``: captured once per
    (key, device, input shapes and dtypes) and replayed on the card.  The
    key is frozen (`freeze`) and hashed on every path, the CPU's and
    `eager()`'s too, so a key the card cannot look up raises everywhere."""
    with annotate("graph.run"):
        device = torch.device(device)
        key = freeze(key)
        hash(key)
        if device.type != "cuda" or _EAGER:
            return fn(*(x.to(device) for x in inputs))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        sig = (key, device, tuple((tuple(x.shape), x.dtype) for x in inputs))
        entry = _GRAPHS.get(sig)
        if entry is None:
            with annotate("graph.capture"):
                result, _GRAPHS[sig] = _capture(fn, device, inputs)
            return result
        with annotate("graph.copy_in"):
            for dst, src in zip(entry.inputs, inputs):
                dst.copy_(src, non_blocking=True)
        with annotate("graph.replay"):
            entry.graph.replay()
        for (holder, attr), n in zip(COUNTERS, entry.counts):
            setattr(holder, attr, getattr(holder, attr) + n)
        with annotate("graph.clone_out"):
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
    before = [getattr(holder, attr) for holder, attr in COUNTERS]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=_POOLS[device], stream=side):
            outputs = fn(*static)
        counts = tuple(getattr(holder, attr) - b for (holder, attr), b in zip(COUNTERS, before))
    except BaseException:
        _recover(device, caller)
        raise
    finally:
        for (holder, attr), b in zip(COUNTERS, before):
            setattr(holder, attr, b)
    caller.wait_stream(side)
    for x in leaves(result):
        x.record_stream(caller)
    return result, _Graph(graph, static, outputs, counts)


def _recover(device: torch.device, caller: torch.cuda.Stream) -> None:
    """Leave the device ready for the next capture after one that raised:
    when the region breaks a capture, `CUDAGraph.capture_end` raises before
    it ends the pool's allocation to the graph, and `torch.cuda.graph`
    before it restores the caller's stream.  This ends the allocation and
    restores the stream, and later graphs take a new pool: the failed
    capture leaves its pool refusing every later capture."""
    torch.cuda.set_stream(caller)
    try:
        torch._C._cuda_endAllocateToPool(device.index, _POOLS[device])
    except RuntimeError:  # capture_end had ended it: the region raised alone
        pass
    _POOLS[device] = torch.cuda.graph_pool_handle()
