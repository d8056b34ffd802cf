"""The port's MDEngine on the CPU against the JAX MDEngine: NVE trajectories
agree, Langevin runs are finite and reproducible from their seed."""

import pathlib

import numpy as np
import pytest
import torch

from sgdml_tpu.md import MDEngine as JaxMDEngine
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import io

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def setup():
    model = io.load_dict(str(GOLDEN / 'model_ref.npz'))
    r0 = np.load(GOLDEN / 'train_predict_ref.npz')['R_test'][0].reshape(-1, 3)
    v0 = np.random.default_rng(0).normal(size=r0.shape) * 0.05
    return model, r0, v0


def test_nve_matches_jax(setup):
    model, r0, v0 = setup
    out = MDEngine(model, device='cpu').run_nve(r0, v0, dt=0.02, n_steps=20, snapshot_every=2)
    ref = JaxMDEngine(model).run_nve(r0, v0, dt=0.02, n_steps=20, snapshot_every=2)
    for ours, theirs, name in zip(out, ref, ('R', 'V', 'E_pot', 'E_kin')):
        assert ours.shape == np.asarray(theirs).shape, name
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=name)
    assert out[0].shape == (10, 5, 3)


def test_langevin_is_finite_and_reproducible_from_seed(setup):
    model, r0, _ = setup
    eng = MDEngine(model, device='cpu')
    kw = dict(dt=0.02, n_steps=12, friction=0.1, kT=0.05, snapshot_every=3)
    a = eng.run_langevin(r0, np.zeros_like(r0), seed=4, **kw)
    b = eng.run_langevin(r0, np.zeros_like(r0), seed=4, **kw)
    c = eng.run_langevin(r0, np.zeros_like(r0), seed=5, **kw)
    assert all(np.isfinite(x).all() for x in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[1] - c[1]).max() > 0


def test_masses_and_forces_match_the_predictor(setup):
    model, r0, _ = setup
    eng = MDEngine(model, device='cpu')
    np.testing.assert_array_equal(
        eng.masses.numpy(), io.ATOMIC_MASSES[np.asarray(model['z'], dtype=np.int64)]
    )
    E1, F1 = eng.energy_forces(torch.as_tensor(r0))
    E2, F2 = GDMLPredict(model, device='cpu').predict(r0.reshape(1, -1))
    np.testing.assert_allclose(float(E1), E2[0], rtol=1e-12)
    np.testing.assert_allclose(F1.numpy().ravel(), F2[0], rtol=1e-10, atol=1e-14)
    with pytest.raises(TypeError):
        MDEngine(model)  # the device is explicit
