"""CUDA graphs of the one-geometry programs: the MD blocks and the serving buckets.

The JAX package runs these as compiled programs: the MD trajectory is one
``jax.jit`` of a ``lax.scan`` (``sgdml_tpu/md.py:_run_nve``,
``_run_langevin``) and each serving bucket one jitted ``_predict_geoms``
(``sgdml_tpu/predict.py``). The host enqueues a program, not each of its
operations. A :class:`Program` is their counterpart here: a body of device
operations over static tensors, captured once as a CUDA graph and then
replayed.

Its first call runs the body eagerly, on the capture stream, as real work
whose results are used: every lazy step of the body (the kernel library's
load and its shared-memory limits, index tensors built from numpy, cuBLAS's
workspace) happens there and not inside the capture. The capture follows
that call, and every later call replays. K1's launches in the graph are
recorded at the capture and counted at each replay
(``fused_predict.recording_launches``), so the launch counts equal those of
the same work run eagerly. Without a graph (the CPU, or the private eager
oracle) every call runs the body. A failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..ops import fused_predict

__all__ = ['Program', 'on_stream']


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
        out = self.body()
        if self.graph:
            self._capture()
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
            with fused_predict.recording_launches() as launches:
                with torch.cuda.graph(cuda_graph, pool=self.pool, stream=torch.cuda.current_stream()):
                    self.out = self.body()
        finally:
            if collecting:
                gc.enable()
        self.cuda_graph, self.launches = cuda_graph, launches
        self.capture_s = time.perf_counter() - t0
