"""The reader of the MD loop's fused steps: ``fused_step_share.md`` from a
record filled by hand, and None where the record holds no fused step or the
program has no recorder."""

from __future__ import annotations

import types

import pytest
from sgdml_tpu_torch.utils import profiling

from benchmark import harness

from conftest import BENCH

MS = 1_000_000  # ns
NAME = 'fused_step_share.md'


def _read(run):
    return harness._reader(BENCH, NAME)(run)


@pytest.fixture
def record(monkeypatch):
    """``fill(steps, counters)``: one ``md.trajectory`` span a chunk of
    ``steps``, and the counters."""

    def fill(steps, counters=None):
        spans = [('md.trajectory', 1000.0 * i * MS, 1000.0 * (i + 1) * MS, i + 1, None, i + 1, {'steps': n})
                 for i, n in enumerate(steps)]
        monkeypatch.setattr(profiling._RECORDER, 'spans', spans)
        monkeypatch.setattr(profiling._RECORDER, 'counters', dict(counters or {}))

    fill([])
    return fill


def _run():
    return types.SimpleNamespace(window_s=2.0, units=2, work=100_000, records={'steps': 100_000})


def test_the_share_of_fused_steps_over_the_window(record):
    record([50_000, 50_000], {'md.fused_steps': 100_000, 'graph.captures': 2})
    assert _read(_run()) == pytest.approx(100.0)
    record([50_000, 50_000], {'md.fused_steps': 50_000})
    assert _read(_run()) == pytest.approx(50.0)


def test_the_share_is_silent_where_nothing_was_fused(record, monkeypatch):
    assert _read(_run()) is None  # nothing recorded
    record([50_000], {'graph.captures': 1})  # a program that counts no fused step
    assert _read(_run()) is None
    record([50_000], {'md.fused_steps': 50_000})
    assert _read(_run()) == pytest.approx(100.0)
    monkeypatch.delattr(profiling, 'calls')  # a program without the recorder
    assert _read(_run()) is None


def test_the_share_names_its_layer_and_cell():
    spec = {m['name']: m for m in harness._json(BENCH.parent / 'BENCHMARK.json')['per_layer']}[NAME]
    assert spec['source'] == 'program_counter' and spec['layer'] == 'MD loop'
    assert spec['moves'] == 'md_steps_per_s' and spec['workloads'] == ['aspirin.md_nve']
