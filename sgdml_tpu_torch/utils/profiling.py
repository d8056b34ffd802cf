"""Profiling and phase timing.

* :class:`PhaseTimer` -- named wall-clock spans with a summary table, used by
  the training pipeline. CUDA launches return before the device is done, so
  a timer on a CUDA device synchronizes it at the end of every phase: the
  phase is charged its own device work, not the next phase's wait.
* :func:`trace` -- a context manager around ``torch.profiler`` that writes a
  Chrome/Perfetto trace of host operations and, on a GPU, device kernels.
* :func:`annotate` -- a named region that shows up in such a trace.

Same names and use as ``sgdml_tpu.utils.profiling``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import timeit

import torch

__all__ = ['PhaseTimer', 'annotate', 'trace']

log = logging.getLogger(__name__)


class PhaseTimer:
    """Accumulate named wall-clock phases.

    >>> t = PhaseTimer(device)
    >>> with t.phase('assembly'): ...
    >>> t.summary()

    ``device``: where the timed work runs. On a CUDA device each phase ends
    with ``torch.cuda.synchronize(device)``.
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.durations: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = timeit.default_timer()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            dt = timeit.default_timer() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        total = sum(self.durations.values())
        lines = ['%-32s %9s %6s %6s' % ('phase', 'seconds', 'calls', '%')]
        for name, dur in sorted(self.durations.items(), key=lambda kv: -kv[1]):
            lines.append(
                '%-32s %9.3f %6d %5.1f%%'
                % (name, dur, self.counts[name], 100 * dur / max(total, 1e-12))
            )
        lines.append('%-32s %9.3f' % ('total', total))
        return '\n'.join(lines)

    def log_summary(self, level=logging.INFO):
        for line in self.summary().splitlines():
            log.log(level, line)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write a Chrome/Perfetto trace into ``log_dir``.

    >>> with trace('build/trace'): model = trainer.train(task)

    Records host operations, and CUDA kernels when a GPU is present; the
    trace file is ``log_dir/trace.json``.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    log.info('Device trace written to %s', path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in :func:`trace` output."""
    with torch.profiler.record_function(name):
        yield
