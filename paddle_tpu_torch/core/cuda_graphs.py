"""Shape-keyed CUDA graphs of step bodies (counterpart of the JAX
package's per-key ``jax.jit`` caches with donated buffers:
``Predictor._decode_fns`` and ``ServingEngine._step_fns``).

A step body is a function of its static buffers: it reads its inputs
from them and writes its results back into them in place. One
``StepGraphs`` per predictor or serving engine holds, for each
``(site, key)``, the static buffers (made on the key's first use; the
caller refreshes them with ``copy_`` before a step) and, on a CUDA
device, the ``torch.cuda.CUDAGraph`` of one call of the body. The key is
the shape key that ``CompileStats.note`` records for the site: the
values a jitted step of the JAX package is specialised on.

On a CUDA device the first step of a key runs the body on a side
stream, which is the warmup PyTorch asks for before a capture (it
builds the kernels, fills their plan caches, creates the cuBLAS handles)
and is that step itself; then it captures the body into the object's
one memory pool. Every later step of the key replays the graph. Capture
and replay errors raise: no step falls back to the eager body. A
``torch.Generator`` the body draws from is registered with the graph,
so each replay reads the generator's current Philox offset and advances
it by what the captured calls drew, as the eager step would: a graphed
run draws the eager run's numbers. The kernel launches a capture counted
are added to the wrappers' counters on every replay
(``ops/kernels/__init__.py``).

Everything a graph reads or writes outside its own temporaries is a
static buffer allocated outside the capture, and no tensor allocated
inside one outlives it, so graphs sharing the pool may replay in any
order.

On the CPU, and inside ``eager()`` (the counterpart of
``jax.disable_jit``, for tests and checks), the body simply runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.kernels import add_launches, recording_launches
from .compile_stats import CompileStats

__all__ = ["StepGraphs", "eager"]

_EAGER = contextvars.ContextVar("paddle_tpu_torch_eager", default=False)


@contextlib.contextmanager
def eager():
    """Run every step body inside the block without a graph, on the same
    static buffers; graphs already captured stay valid."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


class _Entry:
    __slots__ = ("bufs", "graph", "launches")

    def __init__(self, bufs):
        self.bufs = bufs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[Callable, int] = {}


class StepGraphs:
    """The step graphs and static buffers of one predictor or engine."""

    def __init__(self, device: torch.device, stats: CompileStats):
        self.device = torch.device(device)
        self.stats = stats
        self._entries: Dict[Tuple[str, Any], _Entry] = {}
        # made at the first capture: the graphs' one memory pool, and the
        # side stream that warmups and captures run on
        self._pool = None
        self._side = None

    def buffers(self, site: str, key, make: Callable[[], Any]):
        """The static buffers of ``(site, key)``, made by ``make()`` on
        the key's first use and the same objects on every later one."""
        e = self._entries.get((site, key))
        if e is None:
            e = self._entries[(site, key)] = _Entry(make())
        return e.bufs

    def step(self, site: str, key, body: Callable[[Any], None],
             generator: Optional[torch.Generator] = None) -> None:
        """One step of ``(site, key)``: ``body(buffers)``, as a graph
        replay where one was captured."""
        e = self._entries[(site, key)]
        if self.device.type != "cuda" or _EAGER.get():
            body(e.bufs)
        elif e.graph is None:
            self._warm_and_capture(site, e, body, generator)
        else:
            e.graph.replay()
            add_launches(e.launches)
            self.stats.replays[site] += 1

    def _warm_and_capture(self, site, e, body, generator):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        main, side = torch.cuda.current_stream(self.device), self._side
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(e.bufs)                          # this step, eagerly
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        # torch.cuda.graph would leave a failed capture's stream current:
        # here the stream context outlives capture_end, which raises too
        with recording_launches() as launches, torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                body(e.bufs)                      # recorded, not run
            finally:
                graph.capture_end()
        self.stats.note_capture(
            site, time.perf_counter() - t0,
            torch.cuda.memory_reserved(self.device) - reserved)
        e.graph, e.launches = graph, launches
