"""The harness finds every piece by name, meets the contract's shape, and
runs each cell end to end at a tiny size on the CPU."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness

from conftest import BENCH, CHECKOUT, make_tiny

SPEC = json.loads((CHECKOUT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_loads_its_pieces_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config['name'] == next(w['config'] for w in SPEC['workloads'] if w['name'] == name)
    assert (BENCH / 'kinds' / (cell.traffic['kind'] + '.py')).exists()
    assert set(cell.workload) == {'trace_seconds', 'limits'}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness._reader(BENCH, m['name']))
    assert {m['name'] for m in cell.end_to_end} >= {'setup_s'} and len(cell.end_to_end) >= 2
    assert cell.per_layer


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark'] and SPEC['command'] == ['python3', 'benchmark/run.py']
    assert 1 <= SPEC['run_seconds'] <= 51
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end', 'per_layer') for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        conf = json.loads((CHECKOUT / c['file']).read_text())
        assert conf['name'] == c['name'] and conf['reduced'] == c['reduced'] and conf['source'] == c['source']
        assert any(w['config'] == c['name'] for w in SPEC['workloads'])
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(pairs) == len(set(pairs))
    for w in SPEC['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] in (1, 4)
        assert 1 <= len(w['why']) <= 200 and (BENCH / 'traffic' / (w['traffic'] + '.json')).exists()
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in SPEC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['moves'] in e2e and m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        for w in m['workloads']:
            assert w in e2e[m['moves']].get('workloads', CELLS)
        if m['name'].split('.')[0].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    assert len(json.dumps(SPEC)) < 64 * 1024


def _run(spec, root, name, traced):
    cell = harness.load_cell(name, spec_path=spec, root=root)
    return harness.run_cell(cell, 2**31 + 12345, 0.3, traced, 'cpu')


@pytest.mark.parametrize('traced', [False, True])
@pytest.mark.parametrize('name', CELLS)
def test_each_cell_runs_correct_at_a_tiny_size(tiny, name, traced):
    result, foreign = _run(*tiny, name, traced)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks' and result['attempted'] >= 1
    cell = harness.load_cell(name, spec_path=tiny[0], root=tiny[1])
    wanted = {m['name'] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(result['metrics']) <= wanted
    if not traced:  # the CPU has no device trace: only those readers are silent
        assert set(result['metrics']) == wanted
    for m in result['metrics'].values():
        assert math.isfinite(m['value'])


def _add_cell(tmp_path, name, traffic, like):
    """A cell that a later change adds: a traffic mix, a workload file and
    a BENCHMARK.json entry that reports the metrics of the cell ``like``,
    with no edit of an existing file."""
    spec_path = make_tiny(tmp_path)
    spec = json.loads(spec_path.read_text())
    (tmp_path / 'traffic' / (name + '.json')).write_text(json.dumps(traffic))
    shutil.copy(tmp_path / 'workloads' / (like + '.json'), tmp_path / 'workloads' / ('tiny.%s.json' % name))
    spec['workloads'].append({'name': 'tiny.' + name, 'config': 'tiny', 'traffic': name, 'chips': 1, 'why': 'tests'})
    for m in spec['end_to_end'] + spec['per_layer']:
        if like in m.get('workloads', ()):
            m['workloads'].append('tiny.' + name)
    spec_path.write_text(json.dumps(spec))
    return spec_path


def test_an_extra_cell_loads_from_its_own_files(tmp_path):
    """A mix of a known kind: a data file alone (here the calculator's one
    geometry a request)."""
    spec_path = _add_cell(tmp_path, 'serve_b1', {'kind': 'serve', 'dtype': 'float64', 'batch_size': 8,
                                                 'request': 1, 'passes': [6], 'pool': 32, 'check_share': 0.5},
                          'atat.serve_test')
    result, _ = _run(spec_path, tmp_path, 'tiny.serve_b1', False)
    assert result['correct'] and set(result['metrics']) == {'setup_s', 'serve_gps', 'serve_p95_ms'}
    assert result['attempted'] >= 6


def test_an_extra_mix_forwards_its_train_args_and_a_new_kind_is_a_new_file(tmp_path, monkeypatch):
    """Every key of a mix's ``train_args`` reaches ``train()``; and a kind
    that no file of the benchmark has is found by its own file."""
    from sgdml_tpu_torch.train import GDMLTrain

    seen = []
    train = GDMLTrain.train

    def spy(self, task, **kw):
        seen.append(kw)
        return train(self, task, **kw)

    monkeypatch.setattr(GDMLTrain, 'train', spy)
    args = {'solver': 'analytic', 'solver_max_seconds': 1000}
    spec_path = _add_cell(tmp_path, 'train_args', {'kind': 'train', 'train_args': args, 'check_models': 2},
                          'aspirin.train_inplace')
    assert _run(spec_path, tmp_path, 'tiny.train_args', False)[0]['correct'] and seen[-1] == args
    kind = (BENCH / 'kinds' / 'train.py').read_text().replace("'train_args', {}", "'args', {}")
    (tmp_path / 'kinds' / 'train_renamed.py').write_text(kind)
    spec_path = _add_cell(tmp_path, 'renamed', {'kind': 'train_renamed', 'args': {'solver': 'analytic'},
                                                'check_models': 2}, 'aspirin.train_inplace')
    assert _run(spec_path, tmp_path, 'tiny.renamed', False)[0]['correct'] and seen[-1] == {'solver': 'analytic'}


def test_emit_prints_checks_last_on_stderr_and_the_result_last_on_stdout(capsys):
    result = {'correct': True, 'attempted': 3, 'failed': 0, 'metrics': {}, 'device': {},
              'checks': {'resid': {'value': 1e-9, 'limit': 1e-6}}}
    assert harness.emit(result, []) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])['checks']['resid']['limit'] == 1e-6
    assert err.strip().splitlines()[-1] == 'check resid 1e-09 limit 1e-06'
    assert harness.emit(result, ['jax']) != 0
    out, err = capsys.readouterr()
    assert out == '' and 'jax' in err


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    """Here no card; and a directory holding only BENCHMARK.json and the
    benchmark's folder (no program) fails too."""
    for cwd in (CHECKOUT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(CHECKOUT / 'BENCHMARK.json', tmp_path)
            shutil.copytree(BENCH, tmp_path / 'benchmark', ignore=shutil.ignore_patterns('__pycache__'))
        proc = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0], '--seed', '1',
                               '--seconds', '1', '--trace', '0'], cwd=cwd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0 and proc.stdout == ''


def test_a_configuration_that_fixes_its_data_varies_only_the_order(tiny):
    from benchmark import generator
    from sgdml_tpu_torch.train import GDMLTrain

    cell = harness.load_cell('atat.train_cg600', spec_path=tiny[0], root=tiny[1])
    config = dict(cell.config, data_seed=4)
    tasks = []
    for seed in (1, 2):
        seeds = generator.Seeds(seed)
        ds = generator.dataset(config, seeds, config['n_frames'])
        tasks.append(generator.task(GDMLTrain(device='cpu'), config, ds, seeds, config['n_valid']))
    a, b = tasks
    assert sorted(a['idxs_train']) == sorted(b['idxs_train']) and list(a['idxs_train']) != list(b['idxs_train'])
    order = np.argsort(a['idxs_train'])[np.argsort(np.argsort(b['idxs_train']))]
    np.testing.assert_array_equal(a['R_train'][order], b['R_train'])
    np.testing.assert_array_equal(a['F_train'][order], b['F_train'])


@pytest.mark.card
@pytest.mark.parametrize('name', CELLS)
def test_each_cell_is_correct_on_the_card(card, name):
    """On the chip: ``python3 -m pytest benchmark/tests -m card``."""
    result, foreign = harness.run_cell(harness.load_cell(name), 2**31 + 99, 1.0, False, card)
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu' and foreign == []


def test_a_limit_the_configuration_states_is_that_limit():
    cell = harness.load_cell('atat.train_cg600')
    assert cell.workload['limits']['resid'] == cell.config['cg_tol']
