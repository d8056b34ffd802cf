"""The port's sharded layer (``sgdml_tpu_torch/parallel/spmd.py``) on a gloo
world of two CPU ranks against ``sgdml_tpu.parallel.spmd`` on
``default_mesh(2)`` of the conftest's virtual CPU devices, with the same
numpy inputs (the descriptors are the port's, handed to both): the
interleaved layout, the row-sharded assembly, the masked interleaved
solve, batch-sharded serving (a lattice model too), the row-sharded Nystrom
columns and the sharded Nystrom factor, and the inducing-point budget's
device term. Each result is gathered on every rank; all ranks must agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.parallel import spmd as jax_spmd
from sgdml_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.predict import build_tables as jax_build_tables
from sgdml_tpu.solvers.iterative import Iterative as JaxIterative
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as ker
from sgdml_tpu_torch.parallel import spmd
from sgdml_tpu_torch.predict import GDMLPredict, build_tables, center_tables, desc_perm_table, predict_from_tables
from sgdml_tpu_torch.solvers.iterative import Iterative
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io

from torch_mesh_worker import run_world

N_ATOMS, M, SIG, LAM = 5, 21, 5.0, 1e-10


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The JAX test's system (N=5, M=21, two permutations; 21 points over
    2 ranks pad one), its normalized force labels, serving tables, a lattice
    model and 24 inducing columns, run once through a two-rank world."""
    tmp = tmp_path_factory.mktemp('parallel')
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=80, seed=9)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:M].reshape(M, -1)), N_ATOMS)
    dperms = desc_perm_table(np.stack([np.arange(N_ATOMS), [1, 0, 2, 3, 4]]))
    rng = np.random.default_rng(3)
    y = ds['F'][:M].ravel()
    inp = {'X': X.numpy(), 'Jc': Jc.numpy(), 'dperms': dperms, 'y': y / np.std(y),
           'JA': rng.normal(size=tuple(X.shape)), 'aE': rng.normal(size=M * 2),
           'cols': np.sort(rng.choice(M * 3 * N_ATOMS, 24, replace=False)),
           'F_whole': rng.normal(size=(3, 23))}
    lat = dict(generate_md_dataset(n_atoms=N_ATOMS, n_frames=48, seed=13))
    lat['lattice'] = np.eye(3) * 30.0
    trainer = GDMLTrain(device='cpu')
    model = trainer.train(trainer.create_task(lat, 12, lat, 6, sig=6.0, use_sym=False,
                                              rng=np.random.RandomState(0)), solver='analytic')
    io.save_dict(str(tmp / 'lattice_model.npz'), model)
    inp['Rq_lat'] = lat['R'][12:21].reshape(9, -1)
    np.savez(tmp / 'parallel_inputs.npz', **inp)
    return inp, model, run_world('parallel', 2, tmp)


@pytest.fixture(scope='module')
def jax_mesh():
    return jax_default_mesh(2)


@pytest.mark.parametrize('use_E_cstr', [False, True])
@pytest.mark.parametrize('n_dev', [1, 2, 4])
@pytest.mark.parametrize('m', [5, 19, 21])
def test_sharded_layout_matches_jax(m, n_dev, use_E_cstr):
    ours = spmd.ShardedLayout(m, N_ATOMS, n_dev, use_E_cstr)
    ref = jax_spmd.ShardedLayout(m, N_ATOMS, n_dev, use_E_cstr)
    for key in ('mloc', 'm_pad', 'rloc', 'n_rows', 'n'):
        assert getattr(ours, key) == getattr(ref, key), key
    for key in ('to_std', 'from_std', 'mask'):
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key))
    y = np.random.default_rng(m).normal(size=ours.n)
    np.testing.assert_array_equal(ours.gather_vec(ours.scatter_vec(y)), y)


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_sharded_assembly_matches_jax(world, jax_mesh, use_E_cstr):
    """Gathered strips: the JAX matrix to 1e-12, and its valid block the
    single-device assembly under the layout's permutation. The ranks
    assembled in tiles of 3 x 4 points, so each strip of 11 points (the
    energy blocks too) took several row and column tiles, the last short."""
    inp, _, ranks = world
    mloc = spmd.ShardedLayout(M, N_ATOMS, 2, use_E_cstr).mloc
    for out in ranks:
        ti, tj = out['tiles']
        assert 1 < ti < tj < mloc and mloc % ti and mloc % tj, (ti, tj, mloc)
    ref, lay = jax_spmd.assemble_kernel_sharded(jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], SIG,
                                                N_ATOMS, jax_mesh, use_E_cstr=use_E_cstr)
    for out in ranks:
        np.testing.assert_allclose(out['K_%d' % use_E_cstr], np.asarray(ref), rtol=1e-12, atol=1e-14)
    K1 = ker.assemble_kernel(torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc']), inp['dperms'], SIG, N_ATOMS,
                             use_E_cstr=use_E_cstr).numpy()
    sel = lay.from_std
    np.testing.assert_allclose(ranks[0]['K_%d' % use_E_cstr][np.ix_(sel, sel)], K1, rtol=1e-12, atol=1e-14)


def test_solve_interleaved_matches_jax(world, jax_mesh):
    """Both factor the same interleaved system in f64 for the normalized
    force labels, the blocked updates summed in different orders. At lam
    1e-10 the condition number is about 1e10, so the coefficients agree to
    about eps times that (6e-7 here; the JAX package's own mesh test holds
    them to 1e-5 of the dense solve); what they fit, ``K alpha``, agrees to
    1e-9."""
    inp, _, ranks = world
    K, lay = jax_spmd.assemble_kernel_sharded(jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], SIG,
                                              N_ATOMS, jax_mesh)
    ref = np.asarray(jax_spmd.solve_interleaved(K, inp['y'], LAM, lay))
    K1 = ranks[0]['K_0'][np.ix_(lay.from_std, lay.from_std)]
    fit_ref = K1 @ ref
    for out in ranks:
        assert np.abs(out['alphas'] - ref).max() / np.abs(ref).max() < 1e-5
        assert np.abs(K1 @ out['alphas'] - fit_ref).max() / np.abs(fit_ref).max() < 1e-9
    np.testing.assert_array_equal(ranks[0]['alphas'], ranks[1]['alphas'])


def test_predict_sharded_matches_jax_and_single(world, jax_mesh):
    """Each rank's 11 queries at once, and in chunks of 4."""
    inp, _, ranks = world
    X, Jc = jnp.asarray(inp['X']), jnp.asarray(inp['Jc'])
    Xt, JA = jax_build_tables(X, jnp.asarray(inp['JA']), inp['dperms'])
    E_ref, F_ref = jax_spmd.predict_sharded(X, Jc, Xt, JA, SIG, 1.3, -2.0, N_ATOMS, jax_mesh,
                                            alphas_E_lin=jnp.asarray(inp['aE']))
    tables = center_tables(*build_tables(torch.as_tensor(inp['X']), torch.as_tensor(inp['JA']), inp['dperms']))
    E1, F1 = predict_from_tables(torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc']), tables,
                                 torch.as_tensor(inp['aE']), SIG, 1.3, -2.0, n_atoms=N_ATOMS)
    for out in ranks:
        for ours, ref in ((out['E'], E_ref), (out['F'], F_ref), (out['E'], E1), (out['F'], F1)):
            np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-12, atol=1e-12)
        for key in ('E', 'F'):
            np.testing.assert_allclose(out[key + '_chunked'], out[key], rtol=1e-12, atol=1e-12)


def test_mesh_predict_lattice(world, jax_mesh):
    """Mesh serving of a periodic model (the lattice in the model): against
    the JAX package's mesh serving and the port's single device."""
    inp, model, ranks = world
    E_ref, F_ref = JaxPredict(model, mesh=jax_mesh).predict(inp['Rq_lat'])
    E1, F1 = GDMLPredict(model, device='cpu').predict(inp['Rq_lat'])
    for out in ranks:
        for ours, ref in ((out['E_lat'], E_ref), (out['F_lat'], F_ref), (out['E_lat'], E1), (out['F_lat'], F1)):
            np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


def test_columns_sharded_match_jax(world, jax_mesh):
    """Row-sharded Nystrom columns, rows of the padded point zero."""
    inp, _, ranks = world
    ref = np.asarray(jax_spmd.assemble_kernel_columns_sharded(
        jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], SIG, N_ATOMS, inp['cols'], jax_mesh))
    for out in ranks:
        assert out['C'].shape == ref.shape == (22 * 3 * N_ATOMS, 24)
        np.testing.assert_allclose(out['C'], ref, rtol=1e-10, atol=1e-12)
        assert not out['C'][M * 3 * N_ATOMS:].any()


def test_nystrom_factor_sharded_matches_jax(world, jax_mesh):
    """The column-sharded factor and the leverage scores, gathered: 1e-10
    (the Gram's all-reduce sums in another order than the JAX psum)."""
    inp, _, ranks = world
    C = jax_spmd.assemble_kernel_columns_sharded(jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'],
                                                 SIG, N_ATOMS, inp['cols'], jax_mesh)
    F_ref, lev_ref, ok = jax_spmd.nystrom_factor_sharded(-C, inp['cols'], LAM, 0.0, 0.0, jax_mesh)
    assert ok
    for out in ranks:
        assert bool(out['ok'])
        scale = np.abs(np.asarray(F_ref)).max()
        np.testing.assert_allclose(out['Fny'], np.asarray(F_ref), rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(out['lev'], np.asarray(lev_ref), rtol=0, atol=1e-10)


def test_mesh_factor_plan_and_shards(world):
    """On the two-rank mesh the CG solver plans its f64 factor over both
    ranks, where the build is sharded, and over one device with energy
    constraints, where every rank builds the whole one-pass factor (the JAX
    package scales that plan by the devices too). A whole factor's column
    shard is cut, then padded: (3, 23) gives two (3, 12) shards, the last
    column zero."""
    inp, _, ranks = world
    budget = 15.5 * 1024**3
    for out in ranks:
        assert list(out['plan']) == [Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=2),
                                     Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=1)]
        assert out['plan'][0] > out['plan'][1]
        assert int(out['F_shard_cols']) == 12
        np.testing.assert_array_equal(out['F_shards'], np.pad(inp['F_whole'], ((0, 0), (0, 1))))


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_mesh_inducing_budget_scales_with_devices(n_dev):
    """The (k, n) factor is column-sharded, so its linear-in-k memory terms
    scale by the device count, as in the JAX package."""
    budget = 15.5 * 1024**3
    for args in ((3000, 60, budget), (1000, 21, 79e9), (200, 9, 0.1 * 1024**3)):
        assert Iterative.max_n_inducing_pts(*args, n_dev=n_dev) == JaxIterative.max_n_inducing_pts(*args, n_dev=n_dev)
    assert Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=8) > Iterative.max_n_inducing_pts(3000, 60, budget)

