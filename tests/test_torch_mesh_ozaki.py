"""The port's column-sharded int8 slice-stack CG factor
(``parallel/spmd.nystrom_factor_sharded_streamed``, its applies and its
renormalization) and ``Iterative(mesh=, factor_mode='ozaki')`` on a gloo
world of two CPU ranks, against ``sgdml_tpu.parallel.spmd`` and
``sgdml_tpu.solvers.iterative`` on ``default_mesh(2)`` of the conftest's
virtual CPU devices, with the same numpy inputs (the descriptors and the
energy rows are the port's, handed to both): force-only and bordered by
energy constraints, at 8 slices and at 6 (where the factor is
renormalized); the mesh CG on the tasks of the JAX package's
``test_mesh_cg_ozaki_factor_matches_single`` and
``test_mesh_cg_ozaki_e_cstr_matches_single`` against the port's single
device and the JAX mesh; and the mesh plan of the slice stack.

The represented factor is held to the JAX package's within 1e-9 of
``|F^T F v|``: the two f64 builds (their ``chol(W)`` and Gram stages, whose
sums differ in order and library) give factors that differ by 2e-11 to 7e-11
of it at lam 1e-10, so the int8 slices of the two stacks differ in their
last places; both are held within the JAX test's 1e-8 of the exact f64
Woodbury apply. The CG tasks run at lam 1e-6: at the JAX tests' 1e-10 the
JAX package's first matvec rung (``mm='ozaki'``) on XLA:CPU, whose slice
scales (``jnp.exp2``) are inexact there (``ROADMAP.md`` section 3), stalls
for 600 to 1,080 iterations until the ladder climbs, where the port's
single device and mesh converge in 1 and 21-25; at 1e-6 all take 1 to 4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.parallel import spmd as jax_spmd
from sgdml_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sgdml_tpu.solvers.iterative import Iterative as JaxIterative
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops.kernel import assemble_kernel_columns, assemble_kernel_E_rows
from sgdml_tpu_torch.predict import desc_perm_table
from sgdml_tpu_torch.solvers.iterative import Iterative, _nystrom_factor_from_cols
from sgdml_tpu_torch.utils import io

from torch_mesh_worker import run_world

N_ATOMS, M, SIG, LAM = 5, 21, 6.0, 1e-10
LAM_CG = 1e-6  # the CG tasks' lam (module docstring)
# The JAX CG tests' tolerances: iterations within 10% or 3, coefficients
# within 1e-2 relative (both solves stop at tol 1e-4).
ITERS_TOL, ALPHA_TOL = (0.10, 3), 1e-2
# tests/test_parallel.py's CG tasks: (name, N, M, data seed, split seed,
# energy constraints).
CG_TASKS = (('F', 5, 24, 17, 71, False), ('E', 4, 16, 23, 77, True))


def _cg_task(n_atoms, m, seed, split, use_E_cstr):
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=4 * m, seed=seed)
    np.random.seed(split)
    task = JaxTrain().create_task(ds, m, ds, 8, sig=6.0, lam=LAM_CG, use_sym=False, use_E=True,
                                  use_E_cstr=use_E_cstr)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(task['R_train'].reshape(m, -1)), n_atoms)
    y = task['F_train'].ravel()
    if use_E_cstr:
        E = np.asarray(task['E_train']).ravel()
        y = np.hstack([y, -E + float(np.mean(E))])
    y_std = float(np.std(y))
    return task, dict(X=X.numpy(), Jc=Jc.numpy(), dperms=np.arange(desc_ops.descriptor_dim(n_atoms))[None],
                      y=y / y_std, y_std=y_std)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The JAX tests' factor system (N=5, M=21, two permutations, sig 6,
    lam 1e-10; 2 x 15 inducing columns, 11 points a rank, one padded), its
    energy rows, probe vectors and the two CG tasks, run once through a
    two-rank world."""
    tmp = tmp_path_factory.mktemp('mesh_ozaki')
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=80, seed=9)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:M].reshape(M, -1)), N_ATOMS)
    dperms = desc_perm_table(np.stack([np.arange(N_ATOMS), [1, 0, 2, 3, 4]]))
    dim_i = 3 * N_ATOMS
    cols = np.sort(np.random.default_rng(3).choice(M * dim_i, 2 * dim_i, replace=False))
    cols_e = np.sort(np.random.default_rng(5).choice(M * dim_i, 2 * dim_i, replace=False))
    rng = np.random.default_rng(11)
    inp = dict(X=X.numpy(), Jc=Jc.numpy(), dperms=dperms, cols=cols, cols_e=cols_e,
               C_E=assemble_kernel_E_rows(X, Jc, dperms, SIG, N_ATOMS, cols_e).neg_().numpy(),
               v_pad=np.concatenate([rng.standard_normal(M * dim_i), np.zeros(dim_i)]),
               v_e=rng.standard_normal(M * dim_i + M))
    np.savez(tmp / 'mesh_ozaki_inputs.npz', **inp)
    tasks = {}
    for name, *args in CG_TASKS:
        tasks[name] = _cg_task(*args)
        io.save_dict(str(tmp / ('ozaki_task_%s.npz' % name)), tasks[name][0])
        np.savez(tmp / ('ozaki_system_%s.npz' % name), **tasks[name][1])
    return inp, tasks, run_world('mesh_ozaki', 2, tmp)


@pytest.fixture(scope='module')
def jax_mesh():
    return jax_default_mesh(2)


def _jax_factor(inp, jax_mesh, ns, e):
    C_E = jnp.asarray(inp['C_E']) if e else None
    return jax_spmd.nystrom_factor_sharded_streamed(
        jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], SIG, LAM, inp['cols_e' if e else 'cols'],
        N_ATOMS, jax_mesh, n_slices=ns, C_E_psd=C_E)


@pytest.mark.parametrize('use_E_cstr', [False, True])
@pytest.mark.parametrize('n_slices', [8, 6])
def test_streamed_factor_matches_jax(world, jax_mesh, n_slices, use_E_cstr):
    """The device-major chunk scales (equal at 8 slices; renormalized at 6,
    within 1e-12), the represented ``F^T (F v)`` (1e-9 of its norm; module
    docstring), the leverage scores (``rtol=1e-8``, tests/test_parallel.py's),
    the border ``F_E`` (1e-10 of its largest entry; 6e-12 read) and the
    stack's padded width against the JAX
    package's; the apply within 1e-8 of the exact f64 Woodbury apply of the
    one-pass factor, the padded columns passed through unchanged."""
    inp, _, ranks = world
    F, lev_ref = _jax_factor(inp, jax_mesh, n_slices, use_E_cstr)
    tag = '%s%d' % ('e' if use_E_cstr else 'f', n_slices)
    if use_E_cstr:
        sF, sig_ref, F_E = F
        v = inp['v_e']
        ref = v - np.asarray(jax_spmd.ozaki_factor_apply_sharded_bordered(sF, sig_ref, F_E, jnp.asarray(v),
                                                                          mesh=jax_mesh))
    else:
        sF, sig_ref = F
        v = inp['v_pad']
        ref = v - np.asarray(jax_spmd.ozaki_factor_apply_sharded(sF, sig_ref, jnp.asarray(v), mesh=jax_mesh))
    sig_ref = np.asarray(sig_ref)
    n = M * 3 * N_ATOMS + (M if use_E_cstr else 0)
    cols = inp['cols_e' if use_E_cstr else 'cols']
    C1 = assemble_kernel_columns(torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc']), inp['dperms'], SIG, N_ATOMS,
                                 cols, use_E_cstr=use_E_cstr).neg_()
    F1 = _nystrom_factor_from_cols(C1, cols, LAM, 0.0, 0.0)[0].numpy()
    exact = F1.T @ (F1 @ v[:n])
    for out in ranks:
        if n_slices == 8:
            np.testing.assert_array_equal(out[tag + '_sig'], sig_ref)
        else:
            np.testing.assert_allclose(out[tag + '_sig'], sig_ref, rtol=1e-12, atol=0)
        ours = v - out[tag + '_apply']
        assert np.linalg.norm(ours - ref) <= 1e-9 * np.linalg.norm(ref)
        assert np.linalg.norm(ours[:n] - exact) <= 1e-8 * np.linalg.norm(v[:n] - exact)
        np.testing.assert_array_equal(out[tag + '_apply'][n:], v[n:])
        assert out[tag + '_lev'].shape == np.asarray(lev_ref).shape == (sF.shape[2] + (M if use_E_cstr else 0),)
        np.testing.assert_allclose(out[tag + '_lev'], np.asarray(lev_ref), rtol=1e-8, atol=1e-14)
        assert int(out[tag + '_stack_cols']) == sF.shape[2] // 2 + (-(sF.shape[2] // 2) % 16)
        if use_E_cstr:
            F_E = np.asarray(F_E)
            np.testing.assert_allclose(out[tag + '_FE'], F_E, rtol=0, atol=1e-10 * np.abs(F_E).max())


@pytest.fixture(scope='module')
def cg_refs(world, jax_mesh):
    """Each CG task by the port on one device and by the JAX package on one
    device and on its two-device mesh, all with the slice stack."""
    _, tasks, _ = world
    out = {}
    for name in tasks:
        task, s = tasks[name]
        args = (task, s['X'], s['Jc'], s['dperms'], s['y'], s['y_std'])
        out[name] = {
            'port': Iterative(factor_mode='ozaki', device='cpu').solve(*args),
            'jax': JaxIterative(JaxTrain(), factor_mode='ozaki').solve(*args),
            'jax_mesh': JaxIterative(JaxTrain(), factor_mode='ozaki', mesh=jax_mesh).solve(*args),
        }
    return out


@pytest.mark.parametrize('name', ['F', 'E'])
def test_mesh_cg_ozaki_matches_single_and_jax(world, cg_refs, name):
    """``Iterative(mesh=, factor_mode='ozaki')`` on the two ranks, force-only
    and with energy constraints (the bordered stack): converged, the same
    inducing points as the port's single device and the JAX package's mesh,
    iterations within 10% or 3 of each, and coefficients within the JAX
    tests' 1e-2; every rank returns the same bits."""
    *_, ranks = world
    refs = cg_refs[name]
    for out in ranks:
        assert bool(out['cg_%s_conv' % name])
        a = out['cg_%s_alphas' % name]
        for key in ('port', 'jax_mesh', 'jax'):
            ref = refs[key]
            assert ref[6], key
            np.testing.assert_array_equal(out['cg_%s_idxs' % name], np.asarray(ref[5]))
            it, it_ref = int(out['cg_%s_iters' % name]), int(ref[2])
            assert abs(it - it_ref) <= max(ITERS_TOL[0] * it_ref, ITERS_TOL[1]), (key, it, it_ref)
            a_ref = np.asarray(ref[0])
            assert np.linalg.norm(a - a_ref) / np.linalg.norm(a_ref) < ALPHA_TOL, key
    np.testing.assert_array_equal(ranks[0]['cg_%s_alphas' % name], ranks[1]['cg_%s_alphas' % name])


def test_mesh_ozaki_plan(world):
    """On the two-rank mesh the slice stack's plan is the JAX package's
    ``_factor_plan`` over two devices, with or without energy constraints,
    at the slice count both resolve (k = 24 at N=60, M=3000 and 15.5 GB)."""
    *_, ranks = world
    budget = 15.5 * 1024**3
    ref = JaxIterative(JaxTrain(), factor_mode='ozaki', max_memory=15.5)
    jax_plans = [ref._factor_plan(3000, 60, 2, use_E_cstr=e) for e in (False, True)]
    for out in ranks:
        assert int(out['plan_ns']) == ref._ns()
        caps = Iterative._streamed_caps(3000, 60, budget, ref._ns(), n_dev=2)
        assert caps['plan'] == jax_plans[0][3] == jax_plans[1][3] == min(caps.values())
        assert list(out['plan']) == [caps['plan'], caps['plan']]
        assert caps['plan'] > Iterative._streamed_caps(3000, 60, budget, ref._ns())['plan']


@pytest.mark.parametrize('n_dev', [2, 8])
def test_mesh_ozaki_budget_exceeds_f64(n_dev):
    """tests/test_parallel.py's ``test_mesh_ozaki_budget_exceeds_f64`` in the
    port: over the mesh the 9-byte streamed stack affords a larger k than
    the 16-byte f64 factor, and both caps are the JAX package's."""
    budget = 15.5 * 1024**3
    for kw in (dict(factor_bytes=16.0, streamed=False), dict(factor_bytes=9.0, streamed=True)):
        assert Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=n_dev, **kw) == \
            JaxIterative.max_n_inducing_pts(3000, 60, budget, n_dev=n_dev, **kw)
    assert Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=n_dev, factor_bytes=9.0, streamed=True) > \
        Iterative.max_n_inducing_pts(3000, 60, budget, n_dev=n_dev, factor_bytes=16.0, streamed=False)
