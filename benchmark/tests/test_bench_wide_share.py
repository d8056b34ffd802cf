"""The reader of K1's wide-route share: ``k1_wide_share.md`` from a record
filled by hand, and None where the record holds no K1 launch, no MD
trajectory, or the program has no recorder."""

from __future__ import annotations

import types

import pytest
from sgdml_tpu_torch.utils import profiling

from benchmark import harness

from conftest import BENCH

MS = 1_000_000  # ns
NAME = 'k1_wide_share.md'


def _read(run):
    return harness._reader(BENCH, NAME)(run)


@pytest.fixture
def record(monkeypatch):
    """``fill(n_chunks, counters)``: one ``md.trajectory`` span a chunk of
    5,000 steps, and the counters."""

    def fill(n_chunks, counters=None):
        spans = [('md.trajectory', 1000.0 * i * MS, 1000.0 * (i + 1) * MS, i + 1, None, i + 1, {'steps': 5000})
                 for i in range(n_chunks)]
        monkeypatch.setattr(profiling._RECORDER, 'spans', spans)
        monkeypatch.setattr(profiling._RECORDER, 'counters', dict(counters or {}))

    fill(0)
    return fill


def _run():
    return types.SimpleNamespace(window_s=2.0, units=2, work=10_000, records={'steps': 10_000, 'k1_calls': 10_100})


def test_the_share_of_wide_launches_over_the_window_s_k1_launches(record):
    record(2, {'k1.launches': 10_100, 'k1.wide_launches': 10_100, 'md.unfused_steps': 10_000})
    assert _read(_run()) == pytest.approx(100.0)
    record(2, {'k1.launches': 10_100, 'k1.wide_launches': 2_525})
    assert _read(_run()) == pytest.approx(25.0)
    record(2, {'k1.launches': 10_100, 'k1.wide_launches': 0})  # every launch by another route
    assert _read(_run()) == 0.0


def test_the_share_is_silent_where_no_k1_launch_was_counted(record, monkeypatch):
    assert _read(_run()) is None  # nothing recorded
    record(2, {'md.unfused_steps': 10_000})  # a program without the launch counters
    assert _read(_run()) is None
    record(0, {'k1.launches': 10_100, 'k1.wide_launches': 10_100})  # no md.trajectory span
    assert _read(_run()) is None
    record(2, {'k1.launches': 10_100, 'k1.wide_launches': 10_100})
    monkeypatch.delattr(profiling, 'calls')  # a program without the recorder
    assert _read(_run()) is None


def test_the_share_names_its_layer_and_cell():
    spec = {m['name']: m for m in harness._json(BENCH.parent / 'BENCHMARK.json')['per_layer']}[NAME]
    assert spec['source'] == 'program_counter' and spec['layer'] == 'Contraction K1'
    assert spec['moves'] == 'md_steps_per_s' and spec['workloads'] == ['buckyball.md_nve']
    assert spec['unit'] == '%' and spec['better'] == 'higher'
