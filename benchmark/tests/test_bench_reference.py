"""Each plain reference against the port at a tiny size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import synthetic
from benchmark.reference import gdml
from benchmark.reference import md as ref_md
from benchmark.reference import predict as ref_predict
from benchmark.reference import train as ref_train

from sgdml_tpu_torch.datasets import synthetic as port_synthetic
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.predict import GDMLPredict, desc_perm_table
from sgdml_tpu_torch.train import GDMLTrain

F64 = torch.float64


@pytest.fixture(scope='module')
def trained():
    ds = synthetic.generate_md_dataset(7, 90, molecule_seed=4, seed=5)
    trainer = GDMLTrain(device='cpu')
    task = trainer.create_task(ds, 25, ds, 10, sig=4.0, lam=1e-10, use_sym=False, rng=np.random.RandomState(3))
    return ds, task, trainer.train(task)


def test_frozen_trajectory_is_the_programs_for_one_seed():
    ours = synthetic.generate_md_dataset(8, 40, molecule_seed=9, seed=9)
    theirs = port_synthetic.generate_md_dataset(n_atoms=8, n_frames=40, seed=9)
    for key in ('z', 'R', 'E', 'F'):
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_descriptors_jacobians_and_kernel_match_the_program(trained):
    _, task, _ = trained
    R = torch.as_tensor(task['R_train'], dtype=F64)
    M, N = R.shape[:2]
    x, jc = gdml.descriptors(R)
    x_p, jc_p = desc_ops.descriptor_batch(R.reshape(M, -1), N)
    torch.testing.assert_close(x, x_p, rtol=1e-14, atol=0)
    torch.testing.assert_close(jc, jc_p, rtol=1e-13, atol=1e-15)
    v = torch.randn(M, 3 * N, dtype=F64)
    torch.testing.assert_close(gdml.jac_times(jc, v), desc_ops.jac_dot_vec(jc_p, v, N))
    g = torch.randn(M, x.shape[1], dtype=F64)
    torch.testing.assert_close(gdml.to_cartesian(jc, g, N), desc_ops.vec_dot_jac(jc_p, g, N))
    K = kernel_ops.assemble_kernel(x_p, jc_p, desc_perm_table(task['perms']), 4.0, N)
    J = gdml.full_jacobian(jc, N)
    ours = torch.cat([gdml.kernel_rows(x[i:i + 4], J[i:i + 4], x, J, 4.0) for i in range(0, M, 4)])
    torch.testing.assert_close(ours, K, rtol=1e-11, atol=1e-14)


def test_training_judge_reads_the_programs_model_as_sound(trained):
    _, task, model = trained
    got = ref_train.judge(model, task['R_train'], task['F_train'], task['E_train'], 4.0, 1e-10, 'cpu')
    assert got['resid'] < 1e-8 and got['model'] < 1e-10
    ours = ref_train.train(task['R_train'], task['F_train'], task['E_train'], 4.0, 1e-6, 'cpu', F64)
    again = ref_train.judge(ours, task['R_train'], task['F_train'], task['E_train'], 4.0, 1e-6, 'cpu')
    assert again['resid'] < 1e-8 and again['model'] < 1e-12


def test_predictions_match_the_program(trained):
    ds, task, model = trained
    R = ds['R'][-12:]
    E_p, F_p = GDMLPredict(model, batch_size=8, device='cpu').predict(R.reshape(12, -1))
    ref = ref_predict.Model(task['R_train'], model['alphas_F'], 4.0, model['std'], model['c'], 'cpu', F64)
    E, F = ref.predict(R)
    np.testing.assert_allclose(E, E_p, rtol=1e-11)
    np.testing.assert_allclose(F, F_p, rtol=1e-9, atol=1e-12 * np.abs(F).max())
    assert ref_predict.judge(ref, [(R, E_p, F_p)])['forces'] < 1e-10


def test_velocity_verlet_matches_the_program(trained):
    ds, task, model = trained
    masses = np.linspace(1.0, 16.0, 7)
    r0, v0 = ds['R'][3], np.full((7, 3), 0.01)
    R, V, E_pot, E_kin = MDEngine(model, masses=masses, device='cpu').run_nve(r0, v0, 0.01, 40, snapshot_every=20)
    ref = ref_predict.Model(task['R_train'], model['alphas_F'], 4.0, model['std'], model['c'], 'cpu', F64)
    r, v, E, ke = ref_md.integrate(ref, R[:1], V[:1], masses, 0.01, 20)
    np.testing.assert_allclose(r[0], R[1], rtol=1e-11)
    np.testing.assert_allclose(v[0], V[1], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(E[0], E_pot[1], rtol=1e-11)
    np.testing.assert_allclose(ke[0], E_kin[1], rtol=1e-9)


def test_blocked_cholesky_solves():
    A = torch.randn(50, 50, dtype=F64)
    A = A @ A.T + 50 * torch.eye(50, dtype=F64)
    y = torch.randn(50, dtype=F64)
    L = A.clone()
    assert gdml.cholesky_inplace(L, nb=16)
    torch.testing.assert_close(gdml.cho_solve(L, y, nb=16), torch.linalg.solve(A, y))
    assert not gdml.cholesky_inplace(-A.clone(), nb=16)
