"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` records host operations and, on a card, every kernel,
copy and fill (graph replays included). :func:`summarize` reduces the
events to the busy seconds (the union of the device's intervals), the
seconds and launches of each kernel by name, and the idle gaps named by the
innermost host operation that was running when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import timeit
from dataclasses import dataclass, field

import torch

__all__ = ['Summary', 'profile', 'summarize', 'short_name']

# Device events that are copies or fills, not kernels (kineto's names).
_NOT_KERNELS = ('Memcpy', 'Memset')
# Idle gaps named one by one, longest first; the rest are summed.
NAMED_GAPS = 2000


@dataclass
class Summary:
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name: [seconds, launches]
    gaps: dict = field(default_factory=dict)  # host operation: idle seconds

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern`` (a regex
        searched in the short name)."""
        return sum(s for name, (s, _) in self.kernels.items() if re.search(pattern, name))

    def idle_share(self):
        """% of the traced window in which no kernel, copy or fill ran on
        the card; None where the trace saw none."""
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.busy_s else None

    def breakdown(self, top: int = 10):
        ops = sorted(([n, s] for n, (s, _) in self.kernels.items()), key=lambda x: -x[1])[:top]
        gaps = sorted(([n, s] for n, s in self.gaps.items()), key=lambda x: -x[1])[:top]
        return {'device_ops': ops, 'idle_gaps': gaps}


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r'^void ', '', name)
    depth, out = 0, []
    for ch in name:
        if ch == '(' and depth == 0:
            break
        depth += ch == '<'
        depth -= ch == '>'
        out.append(ch)
    return ''.join(out)[:160]


def summarize(events, window_s: float) -> Summary:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    summary = Summary(window_s)
    device, host = [], []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for e in events:
        t0 = e.start_ns()
        if e.device_type() == cuda:
            device.append((t0, t0 + e.duration_ns()))
            name = e.name()
            if not name.startswith(_NOT_KERNELS):
                entry = summary.kernels.setdefault(short_name(name), [0.0, 0])
                entry[0] += e.duration_ns() * 1e-9
                entry[1] += 1
        elif e.device_type() == cpu:
            host.append((t0, t0 + e.duration_ns(), e.name()))
    if not device:
        return summary
    device.sort()
    start = min(device[0][0], min((h[0] for h in host), default=device[0][0]))
    end = max(max(d[1] for d in device), max((h[1] for h in host), default=0))
    busy, gaps = 0, []
    cur0, cur1 = device[0]
    if cur0 > start:
        gaps.append((start, cur0))
    for t0, t1 in device[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    if end > cur1:
        gaps.append((cur1, end))
    summary.busy_s = busy * 1e-9
    host.sort()
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[:NAMED_GAPS]:
        name = _host_at(host, g0)
        summary.gaps[name] = summary.gaps.get(name, 0.0) + (g1 - g0) * 1e-9
    if len(gaps) > NAMED_GAPS:
        rest = 'the %d shorter gaps' % (len(gaps) - NAMED_GAPS)
        summary.gaps[rest] = sum(g1 - g0 for g0, g1 in gaps[NAMED_GAPS:]) * 1e-9
    return summary


def _host_at(host, t) -> str:
    """The innermost host operation running at time t (host sorted by
    start), or 'host idle'."""
    i = bisect.bisect_right(host, (t, float('inf'), ''))
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        h0, h1, name = host[j]
        if h1 >= t and (best is None or h1 - h0 < best[0]):
            best = (h1 - h0, name)
    return best[1] if best else 'host idle'


@contextlib.contextmanager
def profile(enabled: bool, device):
    """Profile the block where ``enabled``; the yielded dict then gets
    ``'summary'`` (:class:`Summary`) at the block's end, after the device
    has finished its work."""
    out = {}
    if not enabled:
        yield out
        return
    cuda = torch.device(device).type == 'cuda'
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    t0 = timeit.default_timer()
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        window_s = timeit.default_timer() - t0
        prof.__exit__(None, None, None)
    out['summary'] = summarize(prof.profiler.kineto_results.events(), window_s)
