"""CUDA graphs: the port's counterpart of ``jax.jit`` (no JAX counterpart
module; JAX compiles the step in ``train.py:135-138`` and the decode step
in ``models/serving.py:140``).

:class:`Captured` records one call of a function as a ``torch.cuda.CUDAGraph``
over buffers whose addresses stay fixed, and replays it: a replay launches
every kernel of the call in one ``cudaGraphLaunch``, with no Python, no
ctypes call and no allocator between them. What a replay reads is what
lies in those buffers then, so the caller copies its inputs into them (or
hands them over: JAX's donation) before each replay; what it returns lies
in the graph's own memory pool, which the next replay overwrites.

- Warm-up. Before the capture the function runs once on a side stream, as
  PyTorch asks: the first launches build the kernels' library,
  cuBLAS and cuDNN handles and plans, and the caches that live beyond the
  call (RoPE tables, codebooks), none of which may be made inside a
  capture. A function with side effects on its inputs is given ``restore``,
  run after the warm-up, which puts the inputs back.
- A pool of its own. Each graph allocates from a private pool: PyTorch lets
  graphs share a pool only where they replay in the order they were
  captured, which graphs of different shapes do not.
- Launch counts. A replay runs no wrapper, so no counter of
  ``ops.launch_counts()`` moves. The capture takes the counts its region
  added (``ops.launch_totals()``), the warm-up's and the capture's own are
  taken back, and each replay adds the captured counts
  (``ops.add_launch_counts``): a graphed call reports what the same call
  run eagerly launches.

- Garbage collection. Every capture runs Python's cyclic collector first
  and holds it off until the capture ends (:func:`capture`): a dead
  reference cycle that holds another graph (a decode step keeps its graph
  on itself) collected inside a capture would destroy that graph or
  release its pool there, which invalidates the capture
  (``cudaErrorStreamCaptureInvalidated``). PyTorch no longer collects at
  capture begin by default.

Nothing falls back: a capture that fails raises, with PyTorch's reason.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable

import torch

from .. import ops


_REPLAYS = [0]  # every graph's replays since the last reset_replay_count()


def replay_count() -> int:
    """Replays of every :class:`Captured` since :func:`reset_replay_count`:
    what shows that a run went through graphs and not eager calls."""
    return _REPLAYS[0]


def reset_replay_count() -> None:
    _REPLAYS[0] = 0


def counts_delta(after: dict, before: dict) -> dict:
    """The counters that moved between two ``ops.launch_totals()``, by how
    much (zeros left out)."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def set_counts(counts: dict) -> None:
    """Every counter of ``ops.launch_totals()`` to ``counts``."""
    ops.add_launch_counts(counts_delta(counts, ops.launch_totals()))


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph):
    """``torch.cuda.graph(graph)``, with the cyclic garbage collector run
    before it and held off while it captures (the module's docstring)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class Captured:
    """One CUDA graph of ``fn()`` (a closure over fixed buffers).

    ``Captured(fn, restore)`` runs ``fn`` once on a side stream,
    calls ``restore`` (where given), captures it, and keeps its outputs;
    :meth:`replay` runs the graph and returns those outputs (the same
    tensors each time, refilled). ``replays`` counts its replays (and
    :func:`replay_count` every graph's), so a caller can show that the
    graph, and not an eager call, ran."""

    def __init__(self, fn: Callable[[], Any], restore: Callable[[], None] | None = None):
        start = ops.launch_totals()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            if restore is not None:
                restore()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_totals()
        with capture(self.graph):
            self.outputs = fn()
        self.launches = counts_delta(ops.launch_totals(), before)
        set_counts(start)  # the warm-up and the capture ran nothing a caller asked for
        self.replays = 0

    def replay(self):
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        self.replays += 1
        _REPLAYS[0] += 1
        return self.outputs


def same_buffers(a: list, b: list) -> bool:
    """Whether two lists of tensors are the same buffers, one for one."""
    return len(a) == len(b) and all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b))
