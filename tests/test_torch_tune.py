"""The port's batch-size tuner against the JAX package's: the same ladder,
stopping rule and choice under a fixed timer, the port's own cache file and
key, and a cached second call that measures nothing."""

import json
import os
import types

import numpy as np
import pytest
import torch

from sgdml_tpu import tune as jax_tune
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu_torch import tune
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.train import GDMLTrain

# Seconds of one bulk request at each rung under the fixed timer: 256 wins.
COST = {64: 5.0, 128: 3.0, 256: 1.0, 512: 2.0, 1024: 4.0}


@pytest.fixture(scope='module')
def model():
    ds = generate_md_dataset(n_atoms=4, n_frames=120, seed=14)
    task = GDMLTrain(device='cpu').create_task(ds, 20, ds, 10, sig=5.0, use_sym=False, rng=np.random.RandomState(14))
    return GDMLTrain(device='cpu').train(task, solver='analytic')


@pytest.fixture
def caches(tmp_path, monkeypatch):
    paths = str(tmp_path / 'torch.json'), str(tmp_path / 'jax.json')
    monkeypatch.setenv('SGDML_TPU_TORCH_BMARK_CACHE', paths[0])
    monkeypatch.setenv('SGDML_TPU_BMARK_CACHE', paths[1])
    return paths


def _fixed_timer(monkeypatch, module, pred):
    """Replace ``module``'s clock: each reading advances by the cost of the
    predictor's current batch size, so one timed request reads its cost.
    Returns the (batch size, geometries) of each request."""
    clock = {'t': 0.0}
    seen = []
    orig = pred.predict

    def fake():
        clock['t'] += COST[pred.batch_size]
        return clock['t']

    def predict(R, *a, **kw):
        seen.append((pred.batch_size, len(R)))
        return orig(R, *a, **kw)

    monkeypatch.setattr(module, 'timeit', types.SimpleNamespace(default_timer=fake))
    monkeypatch.setattr(pred, 'predict', predict)
    return seen


@pytest.mark.parametrize('n_bulk', [100, 300, 1000])
def test_choice_and_ladder_match_jax(model, caches, monkeypatch, n_bulk):
    pred, jax_pred = GDMLPredict(model, device='cpu'), JaxPredict(model)
    seen = _fixed_timer(monkeypatch, tune, pred)
    seen_j = _fixed_timer(monkeypatch, jax_tune, jax_pred)
    gps = tune.prepare_parallel(pred, n_bulk=n_bulk, n_reps=2)
    gps_j = jax_tune.prepare_parallel(jax_pred, n_bulk=n_bulk, n_reps=2)
    assert seen == seen_j  # the same rungs, warm-ups and repeats
    rungs = [b for b in tune.BUCKET_LADDER if b < 2 * n_bulk]
    assert seen == [x for b in rungs for x in [(b, min(b, n_bulk))] + [(b, n_bulk)] * 2]
    best = min(rungs, key=COST.get)
    assert pred.batch_size == jax_pred.batch_size == best
    assert gps == gps_j == n_bulk / COST[best]


def test_cache_is_the_ports_own(model, caches, monkeypatch):
    """The choice lands in the port's cache file under a key of the model's
    shape, n_bulk, dtypes and device; a second predictor reads it without a
    request; the JAX package's cache is not touched; reset removes it."""
    pred = GDMLPredict(model, device='cpu')
    _fixed_timer(monkeypatch, tune, pred)
    gps = pred.prepare_parallel(n_bulk=300, n_reps=1)
    with open(caches[0]) as fh:
        cache = json.load(fh)
    assert cache == {'4-20-1-300-float64-none-1xcpu': {'batch_size': 256, 'gps': gps}}
    assert not os.path.exists(caches[1])

    again = GDMLPredict(model, device='cpu', transfer_dtype=None)
    seen = _fixed_timer(monkeypatch, tune, again)
    assert again.prepare_parallel(n_bulk=300) == gps and again.batch_size == 256
    assert seen == []  # from the cache: nothing measured

    f32 = GDMLPredict(model, dtype=torch.float32, device='cpu')
    seen = _fixed_timer(monkeypatch, tune, f32)
    f32.prepare_parallel(n_bulk=300, n_reps=1)
    assert seen  # another dtype, another key: measured
    assert tune.reset_cache() and not tune.reset_cache()


def test_cache_key_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA H100 80GB HBM3')
    key = tune._cache_key(60, 3000, 1, 1000, torch.float32, torch.float32, 'cuda')
    assert key == '60-3000-1-1000-float32-float32-1xNVIDIA H100 80GB HBM3'
    assert tune._cache_key(60, 3000, 1, 1000, torch.float64, None, torch.device('cpu')).endswith('-none-1xcpu')


def test_default_cache_path(monkeypatch):
    monkeypatch.delenv('SGDML_TPU_TORCH_BMARK_CACHE', raising=False)
    monkeypatch.delenv('SGDML_TPU_BMARK_CACHE', raising=False)
    ours, ref = tune._cache_path(), jax_tune._cache_path()
    assert os.path.dirname(ours) == os.path.dirname(ref)
    assert os.path.basename(ours) == '.bmark_cache_torch.json' != os.path.basename(ref)


def test_prepare_parallel_measures_and_caches(model, caches):
    """Unpatched: real timings install a rung of the ladder, and the second
    call returns the cached throughput."""
    pred = GDMLPredict(model, device='cpu')
    gps = pred.prepare_parallel(n_bulk=128, n_reps=1)
    assert gps > 0 and pred.batch_size in tune.BUCKET_LADDER
    pred2 = GDMLPredict(model, device='cpu')
    assert pred2.prepare_parallel(n_bulk=128) == pytest.approx(gps)
    assert pred2.batch_size == pred.batch_size
