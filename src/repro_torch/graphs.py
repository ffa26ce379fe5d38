"""CUDA graphs: the port's counterpart of ``jax.jit`` on the card.

The JAX package compiles each step a job runs once, at warm-up, and every
block runs the compiled program.  Here a step is captured once, at
warm-up, as a ``torch.cuda.CUDAGraph`` (:func:`capture`) and every block
replays it (:meth:`Graph.replay`): one launch of the whole step from the
host instead of one Python dispatch per operation.  The JAX package has
no such module: jit is built into JAX.

A step given to :func:`capture` is a function of no arguments that reads
and writes tensors it keeps across calls (a replay reads and writes the
addresses the capture saw) and returns its output, which every replay
overwrites.  It may not read device data on the host (``.item()``, a
boolean mask, ``nonzero``): the capture refuses that, and
``tests/test_torch_graphs.py`` checks the serving step for it without a
card.

- The capture runs on a side stream, after :data:`WARMUP` eager calls on
  that stream: each kernel's first launch (its module load, its
  ``cudaFuncSetAttribute``), cuBLAS's workspace for the stream and the
  allocator's growth happen outside the graph.
- It runs in ``thread_local`` mode: a serving run's driver thread
  captures a job at warm-up while its asyncio thread builds the next job
  (allocations, threefry launches on the default stream), which a capture
  in global mode would refuse.
- A failed capture raises; nothing falls back to eager.

The kernel wrappers count their launches through :func:`count`: a launch
made while this thread captures is counted at each replay instead, so the
counts say what the card ran.  A wrapper that hands a launch a tensor it
keeps beyond the call (the decode kernel's counters) passes it to
:func:`hold`, and the graph keeps it alive.  Each graph has a memory
pool of its own, freed with the graph.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, Optional

import torch

#: Eager calls of a step on the capture stream before it is captured.
WARMUP = 2

_local = threading.local()
# Launch counts are added from several threads (a serving run's driver
# thread replays while its asyncio thread draws the next job's weights).
_counts_lock = threading.Lock()


class _Record:
    """What a capture in progress saw: launches by wrapper, tensors held."""

    def __init__(self):
        self.counts: Dict[Callable, int] = {}
        self.held: List[torch.Tensor] = []


def _record() -> Optional[_Record]:
    return getattr(_local, "record", None)


@contextlib.contextmanager
def _recording() -> Iterator[_Record]:
    """Within the block, this thread's launches and held tensors go to the
    record it yields (a capture's)."""
    rec = _Record()
    _local.record = rec
    try:
        yield rec
    finally:
        _local.record = None


def count(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel: counted now (``wrapper.launches
    += 1``), or at each replay when this thread is capturing a graph."""
    rec = _record()
    if rec is None:
        with _counts_lock:
            wrapper.launches += 1
    else:
        rec.counts[wrapper] = rec.counts.get(wrapper, 0) + 1


def hold(t: torch.Tensor) -> None:
    """Keep ``t`` alive as long as the graph this thread is capturing (a
    no-op outside a capture): a launch baked its address into the graph."""
    rec = _record()
    if rec is not None:
        rec.held.append(t)


class Graph:
    """A captured step: :meth:`replay` runs it again on the current
    stream; ``out`` is the step's output, overwritten by every replay;
    ``counts`` the kernel launches one replay makes, by wrapper."""

    def __init__(self, graph: torch.cuda.CUDAGraph, out, held: list,
                 counts: Dict[Callable, int]):
        self._graph, self.out, self._held = graph, out, held
        self.counts = counts

    def replay(self):
        """Run the step once more; returns ``out``."""
        self._graph.replay()
        with _counts_lock:
            for wrapper, n in self.counts.items():
                wrapper.launches += n
        return self.out


def capture(step: Callable[[], object], device) -> Graph:
    """Capture ``step`` on ``device`` (a CUDA device) as a graph, after
    :data:`WARMUP` eager calls on the capture stream; the current stream
    waits for both.  Raises if ``step`` does anything a capture refuses."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                step()
        graph = torch.cuda.CUDAGraph()
        with _recording() as rec, torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            out = step()
        current.wait_stream(side)
    return Graph(graph, out, rec.held, rec.counts)
