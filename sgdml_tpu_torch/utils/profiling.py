"""Profiling, phase timing and the port's spans.

* :class:`PhaseTimer` -- named wall-clock phases with a summary table, used
  by the training pipeline. CUDA launches return before the device is done,
  so a timer on a CUDA device synchronizes it at the end of every phase: the
  phase is charged its own device work, not the next phase's wait. Each
  phase is also a span.
* :func:`span`, :func:`count`, :func:`note` -- the recorder: spans at the
  port's layer boundaries and named counters. It records exactly while a
  ``torch.profiler`` session is on (it reads the profiler's flag and has no
  setting of its own); off, a span is one flag read and a shared null
  context. On, each span is stamped with ``time.time_ns()``, the clock of
  the profiler's (kineto's) events, and is also a host event of the trace
  itself, ``sgdml/<name>``. That event is a ``_RecordFunctionFast``, cheaper
  than ``record_function`` and of a function's scope: the user scope of
  ``record_function`` would also lay an annotation over the kernels
  launched inside it on the card's timeline, which a reader of the device's
  busy time counts as work. A span or count made while the profiler is on,
  when the last one saw it off, starts a new record: the record holds the
  current profiling session.
* :func:`seconds`, :func:`self_seconds`, :func:`calls`, :func:`counter`,
  :func:`spans` -- the record's aggregates, for readers.
* :func:`trace` -- profile a block and write ``trace.json`` (a
  Chrome/Perfetto trace of host operations, the spans among them, and on a
  GPU the device's kernels) and ``spans.json`` (the record).

:class:`PhaseTimer` has the names and use of ``sgdml_tpu.utils.profiling``'s.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
import timeit

import torch
from torch.autograd import profiler as _profiler

__all__ = ['PhaseTimer', 'calls', 'clear', 'count', 'counter', 'note', 'seconds', 'self_seconds', 'span',
           'spans', 'trace']

log = logging.getLogger(__name__)

# A span as the record keeps it.
FIELDS = ('name', 'start_ns', 'end_ns', 'id', 'parent', 'root', 'attrs')


class _Recorder:
    """The process's record: finished spans (tuples of :data:`FIELDS`,
    in the order they ended), counters, the open spans (innermost last)
    and whether the last span or count saw the profiler on."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.open: list = []
        self.live = False
        self.ids = itertools.count(1)

    def recording(self) -> bool:
        """The profiler's flag; where it turned on since the last span or
        count saw it off, the record starts anew."""
        if not _profiler._is_profiler_enabled:
            self.live = False
            return False
        if not self.live:
            self.clear()
            self.live = True
        return True

    def clear(self):
        self.spans, self.counters = [], {}


_RECORDER = _Recorder()
_NULL = contextlib.nullcontext()


class _Span:
    """A recorded span: the profiler's ``sgdml/<name>`` host event and a
    tuple of the record, stamped inside that event. The event is looked up
    at each span, where a test can replace it."""

    __slots__ = ('name', 'attrs', 'id', 'parent', 'root', 'start', 'event')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _RECORDER.open
        outer = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        stack.append(self)
        self.event = torch._C._profiler._RecordFunctionFast('sgdml/' + self.name)
        self.event.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.event.__exit__(*exc)
        _RECORDER.open.pop()
        _RECORDER.spans.append((self.name, self.start, end, self.id, self.parent, self.root, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name``, its
    parent the innermost open span and its root (the request: one
    ``predict``, one ``run_nve``, one training) the outermost; ``attrs``
    are a few ints (B, the bucket, the steps). Off, a shared null context.

    >>> with span('predict', B=250): ...
    """
    if not _RECORDER.recording():
        return _NULL
    return _Span(name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``; nothing while off."""
    if _RECORDER.recording():
        counters = _RECORDER.counters
        counters[name] = counters.get(name, 0) + n


def note(**attrs):
    """Add ``attrs`` to the innermost open span; nothing while off."""
    if _profiler._is_profiler_enabled and _RECORDER.open:
        _RECORDER.open[-1].attrs.update(attrs)


def clear():
    """Empty the record."""
    _RECORDER.clear()


def spans(name: str | None = None) -> list:
    """The record's spans (of ``name``) as dicts of :data:`FIELDS`, in the
    order they ended."""
    return [dict(zip(FIELDS, s)) for s in _RECORDER.spans if name is None or s[0] == name]


def calls(name: str) -> int:
    """How many spans ``name`` the record holds."""
    return sum(1 for s in _RECORDER.spans if s[0] == name)


def seconds(name: str) -> float:
    """The summed seconds of the spans ``name``."""
    return 1e-9 * sum(s[2] - s[1] for s in _RECORDER.spans if s[0] == name)


def self_seconds(name: str) -> float:
    """The summed self time of the spans ``name``: each one's duration less
    the part of it that its child spans cover."""
    mine = [s for s in _RECORDER.spans if s[0] == name]
    ids = {s[3] for s in mine}
    children: dict = {}
    for s in _RECORDER.spans:
        if s[4] in ids:
            children.setdefault(s[4], []).append((s[1], s[2]))
    total = 0
    for _, t0, t1, sid, *_ in mine:
        covered, reach = 0, t0
        for c0, c1 in sorted(children.get(sid, ())):
            c0, c1 = max(c0, reach), min(c1, t1)
            if c1 > c0:
                covered += c1 - c0
                reach = c1
        total += t1 - t0 - covered
    return 1e-9 * total


def counter(name: str) -> int:
    """The counter ``name`` (0 where nothing counted it)."""
    return _RECORDER.counters.get(name, 0)


class PhaseTimer:
    """Accumulate named wall-clock phases.

    >>> t = PhaseTimer(device)
    >>> with t.phase('assembly'): ...
    >>> t.summary()

    ``device``: where the timed work runs. On a CUDA device each phase ends
    with ``torch.cuda.synchronize(device)``. Each phase is also a
    :func:`span` of its name, the synchronization inside it.
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.durations: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
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
    """Profile the block; write ``log_dir/trace.json``, a Chrome/Perfetto
    trace of host operations (the spans as ``sgdml/<name>``) and, where a
    GPU is present, its kernels; and ``log_dir/spans.json``, the record
    (``{"fields", "spans", "counters"}``, stamps in ``time.time_ns()``).

    >>> with trace('build/trace'): model = trainer.train(task)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        clear()
        _RECORDER.live = True
        yield prof
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, 'spans.json'), 'w') as f:
        json.dump({'fields': FIELDS, 'spans': _RECORDER.spans, 'counters': _RECORDER.counters}, f)
    log.info('Device trace written to %s', path)
