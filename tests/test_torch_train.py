"""The port's GDMLTrain on the CPU against the JAX package and the
reference's golden training: splits, coefficients, integration constant and
predictions, energy constraints, symmetrized training, task rebuilding, and
models moving both ways between the packages."""

import pathlib

import numpy as np
import pytest
import torch

from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_symmetric_md_dataset
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def golden():
    data = dict(np.load(GOLDEN / 'train_predict_ref.npz', allow_pickle=True))
    ds = {'type': 'd', 'name': np.array('synth5'), 'theory': np.array('morse'),
          'z': data['z'], 'R': data['R'], 'E': data['E'], 'F': data['F']}
    ds['md5'] = io.dataset_md5(ds)
    return data, ds


@pytest.fixture(scope='module')
def golden_models(golden):
    """The golden recipe (RandomState(7), 30 train / 20 valid points, sig 4,
    lam 1e-10) trained by the port and by the JAX package."""
    _, ds = golden
    task = GDMLTrain(device='cpu').create_task(
        ds, 30, ds, 20, sig=4.0, lam=1e-10, use_sym=False, rng=np.random.RandomState(7))
    np.random.seed(7)
    jax_task = JaxTrain().create_task(ds, 30, ds, 20, sig=4.0, lam=1e-10, use_sym=False)
    return (task, GDMLTrain(device='cpu').train(task)), (jax_task, JaxTrain().train(jax_task, solver='analytic'))


@pytest.mark.parametrize('draw', ['global', 'RandomState'])
@pytest.mark.parametrize('use_E', [True, False])
def test_splits_match_jax(golden, draw, use_E):
    """Same seed, same splits and order, from the global RNG or a RandomState."""
    _, ds = golden
    if not use_E:
        ds = {k: v for k, v in ds.items() if k != 'E'}
    kw = dict(sig=4.0, lam=1e-10, use_sym=False, use_E=use_E)
    np.random.seed(7)
    ref = JaxTrain().create_task(ds, 30, ds, 20, **kw)
    if draw == 'global':
        np.random.seed(7)
        task = GDMLTrain(device='cpu').create_task(ds, 30, ds, 20, **kw)
    else:
        np.random.seed(99)  # the global RNG plays no part
        task = GDMLTrain(device='cpu').create_task(ds, 30, ds, 20, rng=np.random.RandomState(7), **kw)
    assert sorted(task) == sorted(ref)
    for key in ('idxs_train', 'idxs_valid', 'R_train', 'F_train', 'perms'):
        np.testing.assert_array_equal(task[key], ref[key])
    assert task['md5_train'] == ref['md5_train']


def test_golden_training(golden, golden_models):
    """The golden recipe reproduces the reference's split, std, alphas, c and
    predictions (tolerances of tests/test_train.py), and the JAX package's
    model."""
    data, _ = golden
    (task, model), (_, jax_model) = golden_models
    np.testing.assert_array_equal(task['idxs_train'], data['idxs_train'])
    np.testing.assert_allclose(model['std'], data['std'], rtol=1e-12)
    scale = np.abs(data['alphas_F']).max()
    assert np.abs(model['alphas_F'] - data['alphas_F']).max() / scale < 1e-4
    np.testing.assert_allclose(model['c'], data['c'], rtol=1e-5)
    E, F = GDMLPredict(model, device='cpu').predict(data['R_test'])
    np.testing.assert_allclose(E, data['e_pred'], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(F, data['f_pred'], rtol=1e-5, atol=1e-7)

    assert sorted(model) == sorted(jax_model)
    for key in ('R_desc', 'R_d_desc_alpha', 'alphas_F'):
        ref = np.asarray(jax_model[key])
        assert np.abs(model[key] - ref).max() <= 1e-6 * np.abs(ref).max(), key
    for key in ('tril_perms_lin', 'perms', 'idxs_train', 'idxs_valid'):
        np.testing.assert_array_equal(model[key], jax_model[key])
    np.testing.assert_allclose(model['c'], jax_model['c'], rtol=1e-9)


def test_models_are_served_by_both_packages(golden, golden_models):
    """A model trained by either package is served by the other to 1e-10."""
    data, _ = golden
    for _, model in golden_models:
        E, F = GDMLPredict(model, device='cpu').predict(data['R_test'])
        E_j, F_j = JaxPredict(model).predict(data['R_test'])
        np.testing.assert_allclose(E, E_j, rtol=1e-10, atol=1e-10 * np.abs(E_j).max())
        np.testing.assert_allclose(F, F_j, rtol=1e-10, atol=1e-10 * np.abs(F_j).max())


def test_energy_constrained_training_matches_jax(golden):
    data, ds = golden
    kw = dict(sig=4.0, lam=1e-10, use_sym=False, use_E=True, use_E_cstr=True)
    task = GDMLTrain(device='cpu').create_task(ds, 25, ds, 10, rng=np.random.RandomState(3), **kw)
    model = GDMLTrain(device='cpu').train(task, solver='analytic')
    jax_model = JaxTrain().train(task, solver='analytic')
    assert 'alphas_E' in model and model['c'] == jax_model['c']
    for key in ('alphas_F', 'alphas_E'):
        ref = np.asarray(jax_model[key])
        assert np.abs(model[key] - ref).max() <= 1e-5 * np.abs(ref).max(), key
    E, _ = GDMLPredict(model, device='cpu').predict(data['R_test'])
    E_j, _ = JaxPredict(jax_model).predict(data['R_test'])
    np.testing.assert_allclose(E, E_j, rtol=1e-8)
    assert np.abs(E - data['E'][100:120]).mean() < 0.1  # tests/test_train.py's bound


def test_symmetrized_training_matches_jax():
    """use_sym discovers the group (P > 1 in the assembly and the tables),
    the sGDML model matches the JAX package's, and it is no worse than GDML
    (tests/test_perm.py's check)."""
    ds = generate_symmetric_md_dataset(n_frames=60, seed=0)
    maes = {}
    for use_sym in (False, True):
        np.random.seed(13)
        task = GDMLTrain(device='cpu').create_task(ds, 30, ds, 10, sig=6.0, lam=1e-10, use_sym=use_sym)
        np.random.seed(13)
        jax_task = JaxTrain().create_task(ds, 30, ds, 10, sig=6.0, lam=1e-10, use_sym=use_sym)
        np.testing.assert_array_equal(task['perms'], jax_task['perms'])
        model = GDMLTrain(device='cpu').train(task)
        ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:40]
        _, F = GDMLPredict(model, device='cpu').predict(ds['R'][ti].reshape(len(ti), -1))
        _, F_j = JaxPredict(JaxTrain().train(jax_task, solver='analytic')).predict(
            ds['R'][ti].reshape(len(ti), -1))
        np.testing.assert_allclose(F, F_j, rtol=1e-6, atol=1e-6 * np.abs(F_j).max())
        maes[use_sym] = np.abs(F - ds['F'][ti].reshape(len(ti), -1)).mean()
    assert task['perms'].shape[0] > 1
    assert maes[True] <= maes[False] * 1.1, maes


def test_create_task_from_model_matches_jax(golden, golden_models):
    _, ds = golden
    (_, model), _ = golden_models
    ours = GDMLTrain(device='cpu').create_task_from_model(model, ds)
    ref = JaxTrain().create_task_from_model(model, ds)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_engines_default_to_the_gpu(golden, golden_models):
    """Every engine runs on the card unless asked for the CPU; without a
    card the default raises instead of falling back."""
    (_, model), _ = golden_models
    engines = (lambda: GDMLTrain(), lambda: GDMLPredict(model), lambda: MDEngine(model))
    for make in engines:
        if torch.cuda.is_available():
            assert make().device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert GDMLTrain(device='cpu').device == torch.device('cpu')
