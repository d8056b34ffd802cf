"""The whole serving slice on the CPU: a model trained by the JAX package
is served by both packages, and importing the port loads no JAX."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sgdml_tpu.datasets.synthetic import generate_md_dataset as jax_generate
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.train import GDMLTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.predict import GDMLPredict

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def trained():
    ds = generate_md_dataset(n_atoms=6, n_frames=80, seed=2)
    trainer = GDMLTrain()
    np.random.seed(9)
    task = trainer.create_task(ds, 40, ds, 20, sig=5.0, lam=1e-10, use_sym=False, use_E=True)
    return ds, trainer.train(task, solver='analytic')


def test_synthetic_data_is_the_jax_packages(trained):
    ds, _ = trained
    ref = jax_generate(n_atoms=6, n_frames=80, seed=2)
    np.testing.assert_array_equal(ds['R'], ref['R'])
    assert ds['md5'] == ref['md5']


def test_jax_trained_model_served_by_both(trained):
    ds, model = trained
    R = ds['R'].reshape(len(ds['R']), -1)
    E, F = GDMLPredict(model, device='cpu').predict(R)
    E_j, F_j = JaxPredict(model).predict(R)
    assert E.shape == (80,) and F.shape == (80, 18)
    np.testing.assert_allclose(E, E_j, rtol=1e-10)
    np.testing.assert_allclose(F, F_j, rtol=1e-10, atol=1e-10 * np.abs(F_j).max())
    # The model really learned the field: held-in force error well under scale.
    assert np.abs(F - ds['F'].reshape(80, -1)).mean() < 0.2 * np.abs(ds['F']).mean()


def test_importing_the_port_loads_no_jax():
    code = (
        'import sys, sgdml_tpu_torch, sgdml_tpu_torch.predict, sgdml_tpu_torch.md, '
        'sgdml_tpu_torch.models, sgdml_tpu_torch.datasets.synthetic, '
        'sgdml_tpu_torch.ops.fused_predict, sgdml_tpu_torch.ops._build; '
        "assert 'jax' not in sys.modules and 'sgdml_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if 'jax' in m or m == 'sgdml_tpu')"
    )
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)
