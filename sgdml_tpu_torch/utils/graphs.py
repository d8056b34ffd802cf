"""CUDA graphs of the JAX package's compiled programs: the MD blocks, the
serving buckets and the conjugate-gradient chunks.

The JAX package runs these as compiled programs: the MD trajectory is one
``jax.jit`` of a ``lax.scan`` (``sgdml_tpu/md.py:_run_nve``,
``_run_langevin``), each serving bucket one jitted ``_predict_geoms``
(``sgdml_tpu/predict.py``), and each CG chunk one jitted ``lax.while_loop``
(``sgdml_tpu/solvers/iterative.py:_pcg_chunk``,
``sgdml_tpu/solvers/analytic.py:_pcg_chol``). The host enqueues a program,
not each of its operations. A :class:`Program` is their counterpart here: a
body of device operations over static tensors, captured once as a CUDA graph
and then replayed. A :class:`Loop` keeps a loop's state resident in static
tensors and advances it by replaying Programs of a block of iterations each,
with a host read between blocks where the JAX loop tests its condition on
the device.

Its first call runs the body eagerly, on the capture stream, as real work
whose results are used: every lazy step of the body (the kernel library's
load and its shared-memory limits, index tensors built from numpy, cuBLAS's
workspace) happens there and not inside the capture. The capture follows
that call, and every later call replays. K1's launches in the graph are
recorded at the capture and counted at each replay
(``fused_predict.recording_launches``), so the launch counts equal those of
the same work run eagerly. Without a graph (the CPU, or the private eager
oracle) every call runs the body. A failed capture or replay raises.

The first call and its capture are the span ``graph.capture`` and add one to
the counter ``graph.captures``; each host read of a Loop is a
:func:`host_read` (``utils/profiling.py`` records them).
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..ops import fused_predict
from . import profiling

__all__ = ['Loop', 'Program', 'host_read', 'on_stream']

# A capture empties the allocator's cache first only when the card has less
# than this many bytes free: a graph's pool grows by allocations inside the
# capture, and freeing cached blocks then would be an error. With more free,
# emptying the cache (as ``torch.cuda.graph`` does each time) only costs:
# late in a long process it took a capture from about 20 ms to 0.5 s on an
# H100, and the next solve paid for its allocations again (PERF.md).
EMPTY_CACHE_BELOW_BYTES = 8 << 30


@contextlib.contextmanager
def on_stream(stream):
    """Run the block on ``stream`` (a side stream, where graphs are captured
    and replayed: never the default stream), after the current stream's work
    so far and before its later work. ``None`` (the CPU, or no graph) runs
    the block where it is."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def host_read(read):
    """``read()``, a read of the device that the host waits on: the span
    ``host.read``, and one more ``host_reads``."""
    with profiling.span('host.read'):
        value = read()
    profiling.count('host_reads')
    return value


class Program:
    """``body()`` over static tensors: run eagerly at the first call, then
    (with ``graph``) captured as a CUDA graph into ``pool`` on the current
    stream and replayed by every later call, which returns the outputs of
    the capture (static tensors: copy them out before the next call).

    ``capture_s`` is the capture's host seconds (None before it)."""

    def __init__(self, body, graph: bool, pool=None):
        self.body = body
        self.graph = graph
        self.pool = pool
        self.cuda_graph = None
        self.out = None
        self.launches = None
        self.capture_s = None

    def __call__(self):
        if self.cuda_graph is not None:
            self.cuda_graph.replay()
            fused_predict.count_replay(self.launches)
            return self.out
        if not self.graph:
            return self.body()
        with profiling.span('graph.capture'):
            out = self.body()
            self._capture()
        profiling.count('graph.captures')
        return out

    def _capture(self):
        t0 = time.perf_counter()
        cuda_graph = torch.cuda.CUDAGraph()
        # Freeing a graph (or an event or a pinned buffer) is not allowed
        # while a stream is captured, and invalidates the capture: the
        # cyclic garbage collector, which frees at any allocation, waits.
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.synchronize()
            if torch.cuda.mem_get_info()[0] < EMPTY_CACHE_BELOW_BYTES:
                torch.cuda.empty_cache()
            with fused_predict.recording_launches() as launches:
                cuda_graph.capture_begin(*(() if self.pool is None else (self.pool,)))
                try:
                    self.out = self.body()
                finally:
                    cuda_graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.cuda_graph, self.launches = cuda_graph, launches
        self.capture_s = time.perf_counter() - t0


class Loop:
    """Iterations of ``step`` over a loop's state, kept in static tensors and
    advanced in blocks of at most ``block`` iterations, each block a
    :class:`Program` (one for each block length) captured into one pool on
    the loop's own stream and replayed by every later block of that length.

    ``step(state) -> state`` is one iteration over a tuple of tensors; a
    tensor it updates in place it returns as itself. ``like``: tensors of
    the state's shapes and types. ``step`` must not refer to the Loop, so
    that dropping the Loop frees its graphs and their pool at once.
    ``capture_s`` is the host seconds of its captures so far."""

    def __init__(self, step, like, block: int, graph: bool):
        self.state = tuple(torch.empty_like(t) for t in like)
        self.block = block
        self.graph = graph
        self.stream = torch.cuda.Stream(like[0].device) if graph else None
        self.pool = torch.cuda.graph_pool_handle() if graph else None
        self._step = step
        self._programs = {}

    @property
    def capture_s(self) -> float:
        return sum(p.capture_s or 0.0 for p in self._programs.values())

    def _program(self, k: int) -> Program:
        run = self._programs.get(k)
        if run is None:
            state, step = self.state, self._step

            def body():
                now = state
                for _ in range(k):
                    now = step(now)
                for dst, src in zip(state, now):
                    if src is not dst:
                        dst.copy_(src)

            run = self._programs[k] = Program(body, self.graph, self.pool)
        return run

    def __call__(self, start, iters: int, going):
        """Copy ``start`` into the state, run ``iters`` iterations in blocks
        while ``going(state)`` (a host read, before each block) holds, and
        return a copy of the state (never the static tensors)."""
        out = tuple(torch.empty_like(t) for t in self.state)
        with on_stream(self.stream):
            for dst, src in zip(self.state, start):
                dst.copy_(src)
            for i0 in range(0, iters, self.block):
                if not host_read(lambda: going(self.state)):
                    break
                self._program(min(self.block, iters - i0))()
            for dst, src in zip(out, self.state):
                dst.copy_(src)
        return out
