"""The port's mesh engines on gloo worlds of CPU ranks against its
single-device engines and the JAX package: ``GDMLTrain(mesh=)`` analytic and
CG with symmetries and energy constraints, serving by ``GDMLPredict(mesh=)``
(models moving both ways between a JAX mesh and the port's), ``cli all
--devices 2`` against the single-device command, and ``dryrun_multichip(4)``.
Tolerances as ``tests/test_parallel.py``: the analytic mesh model's forces
within 1e-6 of the single-device model's; each CG model within 5e-4 of the
analytic truth."""

import os

import numpy as np
import pytest

from sgdml_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch import cli
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.solvers.analytic import Analytic
from sgdml_tpu_torch.solvers.iterative import Iterative
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io

from torch_mesh_worker import run_world

N_ATOMS, M = 5, 19


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The JAX test's task (N=5, M=19, sig 6, symmetries and energy
    constraints; 19 points over 2 ranks pad one), a JAX mesh model, and the
    CLI's dataset, run once through a two-rank world."""
    tmp = tmp_path_factory.mktemp('mesh_train')
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=4 * M, seed=11)
    task = GDMLTrain(device='cpu').create_task(ds, M, ds, 8, sig=6.0, use_sym=True, use_E=True, use_E_cstr=True,
                                               rng=np.random.RandomState(0))
    io.save_dict(str(tmp / 'task.npz'), task)
    Rq = ds['R'][M:M + 11].reshape(11, -1)
    np.savez(tmp / 'train_inputs.npz', Rq=Rq)
    jax_model = JaxTrain(mesh=jax_default_mesh(2)).train(task, solver='analytic')
    io.save_dict(str(tmp / 'jax_mesh_model.npz'), jax_model)
    cli_ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=60, seed=2)
    np.savez_compressed(tmp / 'cli_ds.npz', **cli_ds)
    ranks = run_world('train', 2, tmp)
    return tmp, task, Rq, jax_model, ranks


@pytest.fixture(scope='module')
def single(world):
    _, task, Rq, _, _ = world
    models = {s: GDMLTrain(device='cpu').train(task, solver=s) for s in ('analytic', 'cg')}
    return {s: GDMLPredict(m, device='cpu').predict(Rq) for s, m in models.items()}


def test_mesh_analytic_matches_single_device(world, single):
    *_, ranks = world
    E1, F1 = single['analytic']
    for out in ranks:
        assert np.abs(out['F_analytic'] - F1).max() / np.abs(F1).max() < 1e-6
        assert np.abs(out['E_analytic'] - E1).max() / np.abs(E1 - E1.mean()).max() < 1e-4
    np.testing.assert_array_equal(ranks[0]['alphas_F_analytic'], ranks[1]['alphas_F_analytic'])


def test_mesh_cg_matches_analytic_truth(world, single):
    """CG on the mesh and on one device each converge to tol 1e-4 along
    their own paths: both within 5e-4 of the analytic forces."""
    *_, ranks = world
    _, Fa = single['analytic']
    for F_cg in (single['cg'][1], ranks[0]['F_cg'], ranks[1]['F_cg']):
        assert np.abs(F_cg - Fa).max() / np.abs(Fa).max() < 5e-4
    np.testing.assert_array_equal(ranks[0]['alphas_F_cg'], ranks[1]['alphas_F_cg'])


def test_jax_mesh_model_served_by_port_mesh(world):
    """The JAX mesh model served by the port's mesh: 1e-12 from the port's
    single device (the same contraction); from the JAX package, which sums
    in another order (the port centers its tables), 1e-10 of max |F| and
    1e-8 of max |E| (the energies sum the table's terms with cancellation)."""
    _, _, Rq, jax_model, ranks = world
    E_ref, F_ref = JaxPredict(jax_model).predict(Rq)
    E1, F1 = GDMLPredict(jax_model, device='cpu').predict(Rq)
    for out in ranks:
        np.testing.assert_allclose(out['F_jax'], F1, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out['E_jax'], E1, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out['F_jax'], F_ref, rtol=0, atol=1e-10 * np.abs(F_ref).max())
        np.testing.assert_allclose(out['E_jax'], E_ref, rtol=0, atol=1e-8 * np.abs(E_ref).max())


def test_port_mesh_model_served_by_jax_mesh(world):
    tmp, _, Rq, jax_model, ranks = world
    model = io.load_dict(str(tmp / 'mesh_model.npz'))
    E, F = JaxPredict(model, mesh=jax_default_mesh(2)).predict(Rq)
    np.testing.assert_allclose(F, ranks[0]['F_analytic'], rtol=0, atol=1e-10 * np.abs(F).max())
    np.testing.assert_allclose(E, ranks[0]['E_analytic'], rtol=0, atol=1e-8 * np.abs(E).max())
    # The two packages' mesh trainings agree as the mesh and the single device do.
    _, F_jax = JaxPredict(jax_model).predict(Rq)
    assert np.abs(F - F_jax).max() / np.abs(F_jax).max() < 1e-6


def test_cli_all_devices_matches_single_device(world, tmp_path, monkeypatch):
    """``all --devices 2`` in a two-rank world: rank 0 wrote the same files
    as the single-device command, whose selected model it reproduces."""
    tmp, *_, ranks = world
    monkeypatch.chdir(tmp_path)
    np.random.seed(1)  # as the world's ranks: the split comes from numpy's global generator
    cli.main(['--device', 'cpu', 'all', str(tmp / 'cli_ds.npz'), '20', '10', '-s', '5,10', '--task_dir', 't',
              '--model_file', 'm.npz'])
    assert sorted(os.listdir('t')) == list(ranks[0]['cli_files']) == list(ranks[1]['cli_files'])
    ours, ref = io.load_dict(str(tmp / 'cli_mesh' / 'm.npz')), io.load_dict('m.npz')
    assert float(ours['sig']) == float(ref['sig'])
    np.testing.assert_array_equal(ours['idxs_train'], ref['idxs_train'])
    for key in ('f_err', 'e_err'):
        for stat in ('mae', 'rmse'):
            a, b = ours[key][stat], ref[key][stat]
            assert abs(a - b) <= 1e-6 * abs(b), (key, stat, a, b)


def test_dryrun_multichip_four_ranks(tmp_path):
    ranks = run_world('dryrun', 4, tmp_path)
    for out in ranks:
        assert float(out['df']) < 1e-6


def test_engines_take_a_device_mesh_only():
    """A ``mesh=`` that is not a DeviceMesh raises TypeError, for every
    route on a mesh: the f64 ones and the pair and slice-stack ones (which
    run on gloo worlds in tests/test_torch_meshchol.py and
    test_torch_mesh_ozaki.py)."""
    with pytest.raises(TypeError, match='DeviceMesh'):
        GDMLTrain(mesh=object(), device='cpu')
    for mode in ('auto', 'f64', 'ozaki'):
        with pytest.raises(TypeError, match='DeviceMesh'):
            Iterative(mesh=object(), factor_mode=mode, device='cpu')
    for precision in ('f64', 'pair'):
        with pytest.raises(TypeError, match='DeviceMesh'):
            Analytic(mesh=object(), mesh_precision=precision)
