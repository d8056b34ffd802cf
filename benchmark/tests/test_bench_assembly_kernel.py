"""The reader of the dense assembly's kernel share: ``assembly_kernel_share.train``
from a record filled by hand, and None where the record holds no kernel
block or the program has no recorder."""

from __future__ import annotations

import types

import pytest
from sgdml_tpu_torch.utils import profiling

from benchmark import harness

from conftest import BENCH

MS = 1_000_000  # ns
NAME = 'assembly_kernel_share.train'
CELLS = ['aspirin.train_inplace', 'aspirin_sym.train_inplace', 'aspirin.train_sigma_sweep']


def _read(run):
    return harness._reader(BENCH, NAME)(run)


@pytest.fixture
def record(monkeypatch):
    """``fill(n_trainings, counters)``: one ``train`` span a training, and
    the counters."""

    def fill(n_trainings, counters=None):
        spans = [('train', 1000.0 * i * MS, 1000.0 * (i + 1) * MS, i + 1, None, i + 1, {})
                 for i in range(n_trainings)]
        monkeypatch.setattr(profiling._RECORDER, 'spans', spans)
        monkeypatch.setattr(profiling._RECORDER, 'counters', dict(counters or {}))

    fill(0)
    return fill


def _run():
    return types.SimpleNamespace(window_s=10.0, units=3, work=3, records={})


def test_the_share_of_kernel_blocks_over_the_assembled_blocks(record):
    record(3, {'assembly.perm_blocks': 18_000_000, 'assembly.kernel_blocks': 18_000_000})
    assert _read(_run()) == pytest.approx(100.0)
    record(2, {'assembly.perm_blocks': 2_000_000, 'assembly.kernel_blocks': 500_000})
    assert _read(_run()) == pytest.approx(25.0)


def test_the_share_is_silent_where_the_program_counts_no_kernel_block(record, monkeypatch):
    assert _read(_run()) is None  # nothing recorded
    record(3, {'assembly.perm_blocks': 18_000_000})  # the tile loop: no kernel block counted
    assert _read(_run()) is None
    record(1, {'assembly.kernel_blocks': 1000})  # no dense assembly to share
    assert _read(_run()) is None
    monkeypatch.delattr(profiling, 'calls')  # a program without the recorder
    assert _read(_run()) is None


def test_the_share_names_its_layer_and_cells():
    spec = {m['name']: m for m in harness._json(BENCH.parent / 'BENCHMARK.json')['per_layer']}[NAME]
    assert spec['source'] == 'program_counter' and spec['layer'] == 'Dense assembly'
    assert spec['moves'] == 'train_s' and spec['workloads'] == CELLS
