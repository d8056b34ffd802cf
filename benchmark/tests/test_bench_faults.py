"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault a cell can have. And the control, the plain
reference in float32 in the program's place, fails the limits."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, harness
from sgdml_tpu_torch import md as md_mod
from sgdml_tpu_torch import predict as predict_mod
from sgdml_tpu_torch.solvers import analytic

from conftest import BENCH


def _correct(tiny, name):
    cell = harness.load_cell(name, spec_path=tiny[0], root=tiny[1])
    result, _ = harness.run_cell(cell, 99, 0.2, False, 'cpu')
    return result['correct']


def _solve_returning(change):
    solve = analytic.Analytic.solve

    def broken(self, *args, **kw):
        return change(solve(self, *args, **kw))

    return broken


def _altered(x):
    x = x.clone()
    x[7] += 0.01 * x.abs().max()
    return x


@pytest.mark.parametrize('cell', ['aspirin.train_inplace', 'aspirin.md_nve'])
@pytest.mark.parametrize('fault', [
    lambda a: torch.zeros_like(a),  # the solve returns its state unchanged
    _altered,  # an answer altered where it is produced
    lambda a: torch.cat([a[:a.shape[0] // 2], torch.zeros_like(a[a.shape[0] // 2:])]),  # half left out
], ids=['state_unchanged', 'answer_altered', 'half_left_out'])
def test_a_broken_training_is_not_correct(tiny, monkeypatch, cell, fault):
    assert _correct(tiny, cell)
    monkeypatch.setattr(analytic.Analytic, 'solve', _solve_returning(fault))
    assert not _correct(tiny, cell)


def _scale_with(change):
    scale = predict_mod._scale

    def broken(E, F_d, *args):
        E, F = scale(E, F_d, *args)
        return change(E, F)

    return broken


def _half_mean(E, F):
    h = max(F.shape[0] // 2, 1)
    return torch.cat([E[:h], E[:h].mean().expand(E.shape[0] - h)]), torch.cat([F[:h], F[:h].mean(0).expand(
        F.shape[0] - h, -1)])


@pytest.mark.parametrize('fault', [
    lambda E, F: (E, F + (torch.arange(F.numel()).reshape(F.shape) == 0) * 0.01 * F.abs().max()),
    _half_mean,
], ids=['answer_altered', 'half_left_out'])
def test_a_broken_prediction_is_not_correct(tiny, monkeypatch, fault):
    assert _correct(tiny, 'atat.serve_test')
    monkeypatch.setattr(predict_mod, '_scale', _scale_with(fault))
    assert not _correct(tiny, 'atat.serve_test')


def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny, monkeypatch):
    def run_nve(self, r0, v0, dt, n_steps, snapshot_every=1):
        return self._trajectory(r0, v0, n_steps, snapshot_every, lambda r, v, f, i: (r, v, f))

    monkeypatch.setattr(md_mod.MDEngine, 'run_nve', run_nve)
    assert not _correct(tiny, 'aspirin.md_nve')


@pytest.mark.parametrize('name', ['aspirin.train_inplace', 'atat.serve_test', 'aspirin.md_nve'])
def test_the_control_and_the_faults_fail_the_cells_limits(tiny, name):
    cell = harness.load_cell(name, spec_path=tiny[0], root=tiny[1])
    limits = json.loads((BENCH / 'workloads' / (name + '.json')).read_text())['limits']
    got = control.readings(cell, 5, 0.2, 'cpu')

    def fails(numbers):
        return isinstance(numbers, str) or any(not np.isfinite(v) or v > limits[k] for k, v in numbers.items())

    assert not fails(got.pop('sound'))
    for reading, numbers in got.items():
        assert fails(numbers), reading
