"""The readers of the port's spans and counters: each value from a record
filled by hand under a stand-in run, and None where the record holds none
of its spans or the program has no recorder."""

from __future__ import annotations

import math
import types

import pytest
from sgdml_tpu_torch.utils import profiling

from benchmark import harness

from conftest import BENCH

SERVE = ('stage_us_per_geometry.serve', 'launch_us_per_geometry.serve', 'to_host_us_per_geometry.serve',
         'caller_us_per_geometry.serve')
MD = ('capture_share.md', 'captures_per_chunk.md')
TRAIN = ('capture_share.train', 'host_reads_per_iter.train')
MS = 1_000_000  # ns


def _read(name, run):
    return harness._reader(BENCH, name)(run)


def _run(window_s, units, work, records=None):
    return types.SimpleNamespace(window_s=window_s, units=units, work=work, records=records or {})


@pytest.fixture
def record(monkeypatch):
    """Fill the recorder: ``fill(spans, counters)`` with spans as (name,
    start ms, end ms, id, parent, root)."""

    def fill(spans, counters=None):
        monkeypatch.setattr(profiling._RECORDER, 'spans',
                            [(n, t0 * MS, t1 * MS, i, p, r, {}) for n, t0, t1, i, p, r in spans])
        monkeypatch.setattr(profiling._RECORDER, 'counters', dict(counters or {}))

    fill([])
    return fill


def test_the_serving_readers_split_the_window_a_geometry(record):
    # Two requests of 250 in a 10 ms window: stage 0.5 + 0.25 ms, launch 2 +
    # 2 ms, to host 1 + 1.5 ms, predict 4 + 4.5 ms.
    record([('predict.stage', 0.0, 0.5, 2, 1, 1), ('predict.launch', 0.5, 2.5, 3, 1, 1),
            ('predict.to_host', 2.5, 3.5, 4, 1, 1), ('predict', 0.0, 4.0, 1, None, 1),
            ('predict.stage', 5.0, 5.25, 6, 5, 5), ('predict.launch', 5.25, 7.25, 7, 5, 5),
            ('predict.to_host', 7.5, 9.0, 8, 5, 5), ('predict', 5.0, 9.5, 5, None, 5)])
    run = _run(0.010, 2, 500)
    got = {n: _read(n, run) for n in SERVE}
    assert got == pytest.approx({'stage_us_per_geometry.serve': 1.5, 'launch_us_per_geometry.serve': 8.0,
                                 'to_host_us_per_geometry.serve': 5.0, 'caller_us_per_geometry.serve': 3.0})
    self_us = 1e6 * profiling.self_seconds('predict') / run.work
    assert self_us == pytest.approx(2.5)  # 0.5 and 0.75 ms
    assert math.isclose(sum(got.values()) + self_us, 1e6 * run.window_s / run.work)


def test_the_md_readers_read_the_captures_of_the_window(record):
    record([('graph.capture', 1.0, 121.0, 3, 2, 1), ('md.blocks', 1.0, 130.0, 2, 1, 1),
            ('md.trajectory', 0.0, 3500.0, 1, None, 1)], {'graph.captures': 1})
    run = _run(4.0, 1, 50_000)
    assert _read('capture_share.md', run) == pytest.approx(3.0)
    assert _read('captures_per_chunk.md', run) == 1.0


def test_the_training_readers_read_the_captures_and_host_reads(record):
    record([('graph.capture', 10.0, 90.0, 3, 2, 1), ('cg.chunk', 10.0, 100.0, 2, 1, 1),
            ('train', 0.0, 10_000.0, 1, None, 1), ('graph.capture', 10_010.0, 10_130.0, 6, 5, 4),
            ('cg.chunk', 10_010.0, 10_200.0, 5, 4, 4), ('train', 10_000.0, 20_000.0, 4, None, 4)],
           {'host_reads': 132, 'graph.captures': 2})
    trainings = [{'iters': 550, 'times': {'cg': 8.0}}, {'iters': 550, 'times': {'cg': 8.1}}]
    run = _run(40.0, 2, 2, {'trainings': trainings})
    assert _read('capture_share.train', run) == pytest.approx(0.5)
    assert _read('host_reads_per_iter.train', run) == pytest.approx(0.12)
    dense = _run(40.0, 2, 2, {'trainings': [{'iters': 0, 'times': {'factor': 2.0}}]})
    assert _read('host_reads_per_iter.train', dense) is None


@pytest.mark.parametrize('name', SERVE + MD + TRAIN)
def test_a_reader_is_silent_where_its_spans_are_absent(record, monkeypatch, name):
    trainings = {'trainings': [{'iters': 550, 'times': {'cg': 8.0}}]}
    run = _run(10.0, 2, 500, trainings)
    assert _read(name, run) is None
    # Spans of another cell only.
    record([('other', 0.0, 1.0, 1, None, 1)], {'host_reads': 3, 'graph.captures': 1})
    assert _read(name, run) is None
    # Every root, in a program without the recorder (a commit before it,
    # whose module has only PhaseTimer and trace).
    record([(root, 0.0, 1.0, i, None, i) for i, root in enumerate(('predict', 'md.trajectory', 'train', 'cg.chunk'))],
           {'host_reads': 3, 'graph.captures': 1})
    assert _read(name, run) is not None
    monkeypatch.delattr(profiling, 'calls')
    assert _read(name, run) is None


def test_each_new_metric_names_a_layer_and_cell_of_the_benchmark():
    spec = {m['name']: m for m in harness._json(BENCH.parent / 'BENCHMARK.json')['per_layer']}
    for name in SERVE + MD + TRAIN:
        m = spec[name]
        assert m['source'] in ('program_span', 'program_counter') and len(m['workloads']) == 1
        assert (BENCH / 'metrics' / (name + '.py')).exists()
