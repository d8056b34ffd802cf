"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark's
cells (the same workload, traffic and metric files, a tiny configuration),
and ``card`` for the tests that need a CUDA card."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest
import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

BENCH = CHECKOUT / 'benchmark'
TINY = dict(n_atoms=6, n_train=30, n_valid=10, n_frames=80, sig=5, lam=1e-10, use_E=True, use_E_cstr=False,
            use_sym=False, dtype='float64', molecule_seed=3,
            trajectory={'dt': 0.05, 'friction': 0.05, 'temperature': 0.06, 'burn_in': 50})
# The traffic mixes at a size a test holds, each key as the real mix has it.
TINY_TRAFFIC = {
    'serve_test': {'batch_size': 16, 'request': 10, 'passes': [15, 25], 'pool': 40, 'check_share': 0.2},
    'md_nve': {'snapshot_every': 50, 'chunk_steps': 200, 'check_pairs': 4},
}


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card (run on the chip); skips without one')


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


def make_tiny(root: pathlib.Path) -> pathlib.Path:
    """A benchmark root under ``root``: BENCHMARK.json with every cell on a
    tiny configuration, the real workload, driver and metric files, and the real
    traffic mixes shrunk. Returns the BENCHMARK.json path."""
    spec = json.loads((CHECKOUT / 'BENCHMARK.json').read_text())
    for d in ('configs', 'traffic', 'workloads'):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ('metrics', 'kinds'):
        shutil.copytree(BENCH / d, root / d, dirs_exist_ok=True, ignore=shutil.ignore_patterns('__pycache__'))
    for w in spec['workloads']:
        shutil.copy(BENCH / 'workloads' / (w['name'] + '.json'), root / 'workloads')
        traffic = json.loads((BENCH / 'traffic' / (w['traffic'] + '.json')).read_text())
        traffic.update(TINY_TRAFFIC.get(w['traffic'], {}))
        (root / 'traffic' / (w['traffic'] + '.json')).write_text(json.dumps(traffic))
        w['config'] = 'tiny'
    spec['configs'] = [{'name': 'tiny', 'source': 'tests', 'file': 'configs/tiny.json', 'reduced': [],
                        'why': 'tests'}]
    (root / 'configs' / 'tiny.json').write_text(json.dumps(dict(TINY, name='tiny')))
    path = root / 'BENCHMARK.json'
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture(scope='session')
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp('bench')
    return make_tiny(root), root
