"""The port's pair-precision Cholesky (``ops/meshchol.py``), on one tensor and
on row strips over a gloo world of four CPU ranks, against
``sgdml_tpu.ops.meshchol`` on ``tests/test_meshchol.py``'s matrices; then the
interleaved solve with ``precision='pair'`` against the JAX package's on
``default_mesh(4)`` of the conftest's virtual CPU devices (the system of
``tests/test_torch_parallel.py``), and ``Analytic(mesh_precision='pair')``
with and without energy constraints against the dense solve.

The factors are held to the JAX package's within 1e-9 of max |L| where the
matrix's condition number is at most 1e6. At cond 1e8 two pair
factorizations that differ in the last f64 bits of any intermediate (here
the f32 panel solve and the f64 leaf of different libraries) land 3.1e-9
apart: each is about 6e-9 from the exact f64 Cholesky of the same pair
input, and the JAX factor of the input perturbed by 1e-12 moves by 7.7e-8.
There the bound is 1e-8 of max |L|, with the backward error ``L L^T - A``
held to the JAX test's 1e-8 in every case.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import meshchol as jax_meshchol
from sgdml_tpu.parallel import spmd as jax_spmd
from sgdml_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as ker
from sgdml_tpu_torch.ops import meshchol
from sgdml_tpu_torch.ops.pairchol import pair_split, pair_to_f64
from sgdml_tpu_torch.predict import desc_perm_table
from sgdml_tpu_torch.solvers.analytic import Analytic

from torch_mesh_worker import run_world

# (n, nb, cond, seed): tests/test_meshchol.py's four matrices, then a ragged
# one (blocks straddle the 4 ranks' strips of 50 rows, the last block short).
CASES = [(256, 64, 1e8, 0), (192, 64, 1e6, 1), (128, 32, 1e4, 3), (256, 32, 1e6, 5), (200, 48, 1e6, 7)]
N_ATOMS, M, SIG, LAM = 5, 21, 5.0, 1e-10


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _factor_tol(cond):
    return 1e-8 if cond > 1e6 else 1e-9


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The matrices and right-hand sides, the kernel system (N=5, M=21, two
    permutations) with force labels and energy-constrained labels, run once
    through a four-rank world."""
    tmp = tmp_path_factory.mktemp('meshchol')
    inp = {'n_cases': len(CASES)}
    for i, (n, nb, cond, seed) in enumerate(CASES):
        inp['A%d' % i], inp['nb%d' % i] = _spd(n, cond, seed), nb
        inp['B%d' % i] = np.random.default_rng(100 + i).standard_normal((n, 5))
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=80, seed=9)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:M].reshape(M, -1)), N_ATOMS)
    y = ds['F'][:M].ravel()
    e = ds['E'][:M] - np.mean(ds['E'][:M])
    inp.update(X=X.numpy(), Jc=Jc.numpy(), dperms=desc_perm_table(np.stack([np.arange(N_ATOMS), [1, 0, 2, 3, 4]])),
               y=y / np.std(y), y_E=np.concatenate([y, -e]) / np.std(np.concatenate([y, -e])))
    np.savez(tmp / 'meshchol_inputs.npz', **inp)
    return inp, run_world('meshchol', 4, tmp)


@pytest.fixture(scope='module')
def single():
    """The port's factor of each matrix on one tensor, joined to f64."""
    out = []
    for n, nb, cond, seed in CASES:
        Lh, Ll, info = meshchol.blocked_cholesky_pair(*pair_split(torch.as_tensor(_spd(n, cond, seed))), nb)
        assert info == 0
        out.append((Lh, Ll))
    return out


def _jax_factor(A, nb):
    hi, lo = jax_meshchol._split(jnp.asarray(A))
    Lh, Ll = jax_meshchol.blocked_cholesky_pair(hi, lo, nb=nb)
    return Lh, Ll, np.tril(np.asarray(jax_meshchol._join(Lh, Ll)))


@pytest.mark.parametrize('case', range(4))
def test_factor_matches_jax(world, single, case):
    """The joined factor, on one tensor and gathered from the strips, against
    the JAX package's (module docstring); ``L L^T - A`` within 1e-8."""
    n, nb, cond, seed = CASES[case]
    A = _spd(n, cond, seed)
    _, _, ref = _jax_factor(A, nb)
    ours = [pair_to_f64(*single[case]).numpy(), world[1][0]['L%d' % case]]
    for L in ours:
        assert np.isfinite(L).all() and not np.triu(L, 1).any()
        assert np.abs(L - ref).max() <= _factor_tol(cond) * np.abs(ref).max()
        assert np.abs(L @ L.T - A).max() / np.abs(A).max() < 1e-8
    for out in world[1]:
        assert int(out['info%d' % case]) == 0
        np.testing.assert_array_equal(out['L%d' % case], world[1][0]['L%d' % case])


@pytest.mark.parametrize('case', range(len(CASES)))
def test_strips_match_one_tensor(world, single, case):
    """The factor on four ranks' strips equals the one-tensor factor (the
    ragged case's blocks straddle the strips): the same f64 leaf, panel and
    exact Ozaki update a row, summed in the same order."""
    n, nb, cond, seed = CASES[case]
    ref = pair_to_f64(*single[case]).numpy()
    np.testing.assert_allclose(world[1][0]['L%d' % case], ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    A = _spd(n, cond, seed)
    assert np.abs(ref @ ref.T - A).max() / np.abs(A).max() < 1e-8


@pytest.mark.parametrize('case', range(len(CASES)))
def test_cho_solve_pair(world, single, case):
    """``(L L^T) x = b`` on the strips: the residual through the joined
    factor below 1e-8 of |b|, within 1e-10 of the dense solve with the same
    factor (tests/test_meshchol.py's bound), and within 1e-12 of the
    one-tensor solve."""
    n, nb, cond, seed = CASES[case]
    b = world[0]['B%d' % case][:, 0]
    L = world[1][0]['L%d' % case]
    want = np.linalg.solve(L.T, np.linalg.solve(L, b))
    one = meshchol.cho_solve_pair(*single[case], torch.as_tensor(b), nb).numpy()
    for out in world[1]:
        x = out['x%d' % case]
        assert np.linalg.norm(L @ (L.T @ x) - b) / np.linalg.norm(b) < 1e-8
        assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-10
        np.testing.assert_allclose(x, one, rtol=0, atol=1e-12 * np.abs(one).max())


@pytest.mark.parametrize('case', range(len(CASES)))
def test_tri_solves_matrix_rhs(world, case):
    """``L Y = B`` and ``L^T Z = B`` for five right-hand sides on the strips
    (tests/test_meshchol.py:62-66: 1e-9)."""
    L = world[1][0]['L%d' % case]
    B = world[0]['B%d' % case]
    scale = max(1.0, np.abs(L).max())
    for out in world[1]:
        np.testing.assert_allclose(L @ out['Y%d' % case], B, atol=1e-9 * scale)
        np.testing.assert_allclose(L.T @ out['Z%d' % case], B, atol=1e-9 * scale)


def test_no_mesh_leaves_inputs_and_reports_failure():
    """Without a mesh the inputs stay as they are; an indefinite matrix
    stops at the block column of its first non-positive leading minor and
    reports its order, as ``pairchol.chol_grid_pair`` does."""
    A = _spd(96, 1e4, 2)
    hi, lo = pair_split(torch.as_tensor(A))
    hi0, lo0 = hi.clone(), lo.clone()
    meshchol.blocked_cholesky_pair(hi, lo, 32)
    assert torch.equal(hi, hi0) and torch.equal(lo, lo0)
    A[40, 40] = -1.0
    *_, info = meshchol.blocked_cholesky_pair(*pair_split(torch.as_tensor(A)), 32)
    assert info == 41


@pytest.fixture(scope='module')
def jax_pair(world):
    """The JAX package's pair solve of the same system on four virtual
    devices at each block size, with the rung it logged."""
    inp = world[0]
    mesh = jax_default_mesh(4)
    out = {}
    log = logging.getLogger('sgdml_tpu.parallel.spmd')
    for nb in (1024, 45):
        K, lay = jax_spmd.assemble_kernel_sharded(jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], SIG,
                                                  N_ATOMS, mesh)
        lmax = float(np.abs(np.asarray(K)).sum(1).max()) + LAM
        msgs = []
        handler = logging.Handler()
        handler.emit = lambda rec: msgs.append(rec.getMessage())
        level = log.level
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        try:
            alphas = np.asarray(jax_spmd.solve_interleaved(K, inp['y'], LAM, lay, nb=jax_spmd._largest_divisor(
                lay.n_rows, nb), precision='pair'))
        finally:
            log.removeHandler(handler)
            log.setLevel(level)
        lam_p = float(re.search(r"lam'=([0-9.e+-]+)", [m for m in msgs if 'Mesh pair solve' in m][-1]).group(1))
        out[nb] = dict(alphas=alphas, lmax=lmax, shift=lam_p / lmax, K=np.asarray(K), lay=lay)
    return out


@pytest.mark.parametrize('nb', [1024, 45])
def test_solve_interleaved_pair_matches_jax(world, jax_pair, nb):
    """``precision='pair'`` at the JAX block size (``spmd.NB`` = 1024: one
    block here) and with ``spmd.NB`` at 45 (8 blocks over 4 ranks): the same lmax and rung as the JAX package, no
    f64 fallback, the fit's residual within the JAX test's 1e-4 of |y|
    (``tests/test_parallel.py:98``), and the training forces ``K alpha``
    within 1e-6 of max |F| of the JAX pair solve's."""
    inp, ranks = world
    ref = jax_pair[nb]
    lay = ref['lay']
    K1 = ref['K'][np.ix_(lay.from_std, lay.from_std)]
    F_ref = K1 @ ref['alphas']
    key = 'pair_%s' % nb
    for out in ranks:
        assert not bool(out[key + '_fallback'])
        assert abs(float(out[key + '_lmax']) - ref['lmax']) <= 1e-12 * ref['lmax']
        assert abs(float(out[key + '_rung']) - ref['shift']) <= 1e-5 * ref['shift']  # the log's 6 digits
        a = out[key]
        r = (-K1 + LAM * np.eye(K1.shape[0])) @ (-a) - inp['y']
        assert np.linalg.norm(r) / np.linalg.norm(inp['y']) < 1e-4
        assert np.abs(K1 @ a - F_ref).max() <= 1e-6 * np.abs(F_ref).max()
    np.testing.assert_array_equal(ranks[0][key], ranks[-1][key])


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_analytic_mesh_pair_matches_dense(world, use_E_cstr):
    """``Analytic(mesh=, mesh_precision='pair')`` at lam 1e-8 on the four
    ranks, with and without energy constraints: one rung, CG iterations, and
    the fit ``K alpha`` within 1e-7 of the single-device dense solve's."""
    inp, ranks = world
    X, Jc = torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc'])
    y = inp['y_E'] if use_E_cstr else inp['y']
    ref = Analytic().solve({'sig': SIG, 'lam': 1e-8, 'use_E_cstr': use_E_cstr}, X, Jc, inp['dperms'], y).numpy()
    K = ker.assemble_kernel(X, Jc, inp['dperms'], SIG, N_ATOMS, use_E_cstr=use_E_cstr).numpy()
    fit = K @ ref
    for out in ranks:
        key = 'analytic_%d' % use_E_cstr
        assert int(out[key + '_rungs']) == 1 and int(out[key + '_iters']) > 0
        assert np.abs(K @ out[key] - fit).max() <= 1e-7 * np.abs(fit).max()
