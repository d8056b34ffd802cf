"""The port's GDMLPredict on the CPU against the JAX GDMLPredict and the
reference implementation's goldens: golden parity, symmetrized,
energy-constrained and periodic models, float32, F = -dE/dr, the model
carry-over and model files moving between the packages."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu import train as jax_train
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.utils import io as jax_io
from sgdml_tpu_torch import predict
from sgdml_tpu_torch.models import GDMLModel, model_to_torch
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import io

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def golden():
    data = np.load(GOLDEN / 'train_predict_ref.npz', allow_pickle=True)
    return dict(data), io.load_dict(str(GOLDEN / 'model_ref.npz'))


def _variant(model, kind):
    """The golden model with P=3 permutations, energy-constraint weights or
    a lattice added (coefficients from a numpy seed)."""
    model = dict(model)
    rng = np.random.default_rng(3)
    n, m = model['z'].shape[0], model['R_desc'].shape[1]
    if 'sym' in kind:
        model['perms'] = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(2)])
    if 'ecstr' in kind:
        model['alphas_E'] = rng.normal(size=m) * 0.1
    if 'pbc' in kind:
        model['lattice'] = np.diag([3.1, 3.4, 3.7]) + 0.1 * rng.normal(size=(3, 3))
    return model


def _assert_close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_golden_parity_with_reference_and_jax(golden):
    data, model = golden
    E, F = GDMLPredict(model, device='cpu').predict(data['R_test'])
    np.testing.assert_allclose(E, data['e_pred'], rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(F, data['f_pred'], rtol=1e-8, atol=1e-9)
    E_j, F_j = JaxPredict(model).predict(data['R_test'])
    _assert_close(E, E_j, 1e-12)
    _assert_close(F, F_j, 1e-12)


@pytest.mark.parametrize('kind', ['sym', 'ecstr', 'pbc', 'sym+ecstr+pbc'])
def test_model_variants_match_jax(golden, kind):
    data, model = golden
    model = _variant(model, kind)
    E, F = GDMLPredict(model, device='cpu').predict(data['R_test'])
    E_j, F_j = JaxPredict(model).predict(data['R_test'])
    _assert_close(E, E_j, 1e-10)
    _assert_close(F, F_j, 1e-10)
    if 'pbc' in kind:  # the lattice really changes the answer
        E_open, _ = GDMLPredict(_variant(golden[1], kind.replace('pbc', '')), device='cpu').predict(
            data['R_test'])
        assert np.abs(E - E_open).max() > 1e-3 * np.abs(E).max()


def test_float32_matches_jax_float32(golden):
    data, model = golden
    model = _variant(model, 'sym+ecstr')
    E, F = GDMLPredict(model, dtype=torch.float32, device='cpu').predict(data['R_test'])
    E_j, F_j = JaxPredict(model, dtype=jnp.float32).predict(data['R_test'])
    assert E.dtype == np.float32 and F.dtype == np.float32
    assert np.abs(E - E_j).max() / np.abs(E_j).max() < 1e-4
    assert np.abs(F - F_j).max() / np.abs(F_j).max() < 1e-4


def test_forces_are_negative_energy_gradient(golden):
    """GDML forces are the exact gradient of its energy; autograd through
    the plain path checks the port's (E, F) against each other."""
    data, model = golden
    model = _variant(model, 'ecstr')
    pred = GDMLPredict(model, device='cpu')
    n_atoms = pred.n_atoms
    r = torch.tensor(data['R_test'][0], dtype=torch.float64, requires_grad=True)
    x, jc = desc_ops.descriptor_jacobian(r, n_atoms)
    E, _ = predict.predict_from_tables(
        x[None], jc[None], pred.tables, pred.alphas_E_lin, pred.sig, pred.std, pred.c,
        n_atoms=n_atoms,
    )
    (g,) = torch.autograd.grad(E[0], r)
    _, F = pred.predict(data['R_test'][:1])
    np.testing.assert_allclose(F[0], -g.numpy(), rtol=1e-6, atol=1e-8)


def test_model_to_torch_round_trips(golden):
    _, model = golden
    model = _variant(model, 'sym+ecstr+pbc')
    w = model_to_torch(model, 'cpu', torch.float64)
    np.testing.assert_array_equal(w['R_desc'].T.numpy(), model['R_desc'])
    np.testing.assert_array_equal(w['R_d_desc_alpha'].numpy(), model['R_d_desc_alpha'])
    np.testing.assert_array_equal(w['desc_perms'].numpy(), jax_train.desc_perm_table(model['perms']))
    np.testing.assert_array_equal(w['alphas_E_lin'].numpy(), np.repeat(model['alphas_E'], 3))
    np.testing.assert_array_equal(w['lattice'].numpy(), model['lattice'])
    np.testing.assert_allclose(w['lattice_inv'].numpy() @ model['lattice'], np.eye(3), atol=1e-14)
    w32 = model_to_torch(GDMLModel(model), 'cpu', torch.float32)
    assert w32['R_desc'].dtype == torch.float32 and w32['desc_perms'].dtype == torch.int64
    assert 'alphas_E_lin' not in model_to_torch(golden[1], 'cpu', torch.float64)


def test_model_files_move_between_packages(golden, tmp_path):
    data, model = golden
    model = _variant(model, 'sym+ecstr')
    GDMLModel(model).save(tmp_path / 'port.npz')
    jax_io.save_dict(str(tmp_path / 'jax.npz'), model)
    E, F = GDMLPredict(model, device='cpu').predict(data['R_test'])

    E_j, F_j = JaxPredict(jax_io.load_dict(str(tmp_path / 'port.npz'))).predict(data['R_test'])
    E_p, F_p = GDMLModel.load(str(tmp_path / 'jax.npz')).predictor(device='cpu').predict(
        data['R_test'])
    _assert_close(E_j, E, 1e-10)
    _assert_close(F_j, F, 1e-10)
    np.testing.assert_array_equal(E_p, E)
    np.testing.assert_array_equal(F_p, F)
    E_path, _ = GDMLPredict(str(tmp_path / 'jax.npz'), device='cpu').predict(data['R_test'])
    np.testing.assert_array_equal(E_path, E)


def test_transfer_dtype_float32(golden):
    data, model = golden
    E1, F1 = GDMLPredict(model, device='cpu').predict(data['R_test'])
    E2, F2 = GDMLPredict(model, transfer_dtype=torch.float32, device='cpu').predict(data['R_test'])
    assert F2.dtype == np.float32 and E2.dtype == np.float32
    assert np.abs(F2 - F1).max() / np.abs(F1).max() < 1e-5
    assert np.abs(E2 - E1).max() / max(np.abs(E1).max(), 1.0) < 1e-5


def test_chunking_and_descriptor_input_agree(golden):
    data, model = golden
    pred = GDMLPredict(model, batch_size=16, device='cpu')  # 20 rows -> chunks of 16 and 4
    E_all, F_all = pred.predict(data['R_test'])
    E_one, F_one = pred.predict(data['R_test'][3])
    np.testing.assert_allclose(E_one[0], E_all[3], rtol=1e-10)
    np.testing.assert_allclose(F_one[0], F_all[3], rtol=1e-9, atol=1e-12)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(data['R_test']), pred.n_atoms)
    E_d, F_d = pred.predict(R_desc=X, R_d_desc=Jc)
    np.testing.assert_allclose(E_d, E_all, rtol=1e-12)
    np.testing.assert_allclose(F_d, F_all, rtol=1e-12, atol=1e-14)
    _, F_only = pred.predict(data['R_test'], return_E=False)
    np.testing.assert_array_equal(F_only, F_all)


@pytest.mark.parametrize('with_aE', [False, True])
def test_train_mode_matches_jax(golden, with_aE):
    """set_R_desc / set_R_d_desc / set_alphas and predict_train_forces, the
    iterative solver's matvec, against the JAX engine."""
    data, model = golden
    n_atoms = model['z'].shape[0]
    R_train = data['R'][data['idxs_train']].reshape(len(data['idxs_train']), -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R_train), n_atoms)
    rng = np.random.default_rng(5)
    alphas_F = rng.normal(size=model['alphas_F'].shape)
    alphas_E = rng.normal(size=len(R_train)) if with_aE else None

    pred, pred_j = GDMLPredict(model, device='cpu'), JaxPredict(model)
    JA_orig = pred.tables.JA.clone()
    pred.set_R_desc(X)
    pred.set_R_d_desc(Jc)
    pred.set_alphas(model['alphas_F'])
    np.testing.assert_allclose(pred.tables.JA.numpy(), JA_orig.numpy(), rtol=1e-9, atol=1e-12)

    pred_j.set_R_desc(jnp.asarray(X.numpy()))
    pred_j.set_R_d_desc(jnp.asarray(Jc.numpy()))
    out = pred.predict_train_forces(alphas_F, alphas_E)
    out_j = pred_j.predict_train_forces(alphas_F, alphas_E)
    assert out.shape == out_j.shape == (alphas_F.size + (len(R_train) if with_aE else 0),)
    _assert_close(out, out_j, 1e-10)


def test_unported_options_and_device_are_explicit(golden):
    _, model = golden
    with pytest.raises(TypeError):
        GDMLPredict(model)  # no device: nothing picks one silently
    with pytest.raises(TypeError):
        GDMLPredict(42, device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        GDMLPredict(model, mesh=object(), device='cpu')
    pred = GDMLPredict(model, device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        pred.prepare_parallel()
    x = torch.zeros(1, 10, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        predict.predict_from_tables(
            x, None, pred.tables, None, 1.0, 1.0, 0.0, n_atoms=5, mm='ozaki'
        )
    assert GDMLModel(model).predictor(device='cpu').batch_size == 64


def test_float32_products_are_true_float32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        with predict._true_f32(torch.float32):
            assert torch.get_float32_matmul_precision() == 'highest'
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision(prev)
