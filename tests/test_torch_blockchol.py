"""The port's block-grid packed Cholesky (ops/blockchol.py) and its grid
assembly (ops/kernel.assemble_kernel_grid) on the CPU against the JAX
package's (tests/test_blockchol.py's inputs): packing, the factor in f64 and
f32, the solves and the matvec with one and many right-hand sides, the
block spec, failure through ``info`` and the assembly at ragged tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import blockchol as jbc
from sgdml_tpu.ops.descriptor import descriptor_batch as jax_descriptor_batch
from sgdml_tpu.ops.kernel import assemble_kernel_grid as jax_assemble_kernel_grid
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import blockchol as bc
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops.kernel import assemble_kernel, assemble_kernel_grid
from sgdml_tpu_torch.predict import desc_perm_table

DTYPES = {'f64': (torch.float64, jnp.float64), 'f32': (torch.float32, jnp.float32)}


def _spd(n, seed=0, cond=1e4):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return (q * eigs) @ q.T


def _from_jax(G):
    """A JAX grid carried across block by block."""
    return [[torch.as_tensor(np.array(blk)) for blk in row] for row in G]


def _both(a, spec, name='f64'):
    """The lower-triangle grids of ``a`` in both packages, in one dtype."""
    tdt, jdt = DTYPES[name]
    return (bc.grid_from_dense(torch.as_tensor(a, dtype=tdt), spec),
            jbc.grid_from_dense(jnp.asarray(a, dtype=jdt), spec))


@pytest.mark.parametrize('n,k', [(24, 2), (60, 5), (63, 3), (128, 4)])
def test_pack_roundtrip(n, k):
    spec = bc.GridSpec(n, k)
    a = _spd(n, seed=1)
    g, jg = _both(a, spec)
    back = bc.grid_to_dense(g, spec, full=True)
    np.testing.assert_array_equal(back, jbc.grid_to_dense(jg, spec, full=True))
    np.testing.assert_allclose(back, np.tril(a) + np.tril(a, -1).T)
    np.testing.assert_array_equal(bc.grid_to_dense(_from_jax(jg), spec), jbc.grid_to_dense(jg, spec))
    assert all(blk.shape == (spec.b, spec.b) and blk.is_contiguous() for row in g for blk in row)


@pytest.mark.parametrize('name', ['f64', 'f32'])
@pytest.mark.parametrize('n,k', [(24, 2), (60, 5), (63, 3), (120, 4)])
def test_chol_grid_matches_jax(n, k, name):
    """f64: rtol 1e-10 (atol 1e-12); f32: 1e-4 of max |L| (the two f32
    LAPACK paths round differently)."""
    spec = bc.GridSpec(n, k)
    a = _spd(n, seed=2)
    g, jg = _both(a, spec, name)
    L, info = bc.chol_grid(g)
    assert info == 0 and L is g and bc.grid_isfinite(L)
    ours, ref = bc.grid_to_dense(L, spec), jbc.grid_to_dense(jbc.chol_grid(jg), spec)
    if name == 'f64':
        np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ours, np.linalg.cholesky(a), rtol=1e-10, atol=1e-12)
    else:
        assert ours.dtype == np.float32
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize('rhs', [None, 3])
def test_solve_grid_matches_jax(rhs):
    """One and many right-hand sides through the same (JAX) factor, f64."""
    n, k = 90, 3
    spec = bc.GridSpec(n, k)
    a = _spd(n, seed=3)
    y = np.random.default_rng(4).normal(size=n if rhs is None else (n, rhs))
    _, jg = _both(a, spec)
    jl = jbc.chol_grid(jg)
    x = bc.solve_grid(_from_jax(jl), torch.as_tensor(y))
    assert x.shape == y.shape
    np.testing.assert_allclose(x.numpy(), np.asarray(jbc.solve_grid(jl, jnp.asarray(y))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, y), rtol=1e-8, atol=1e-10)
    # The port's own factor solves the same system.
    L, _ = bc.chol_grid(bc.grid_from_dense(torch.as_tensor(a), spec))
    np.testing.assert_allclose(bc.solve_grid(L, torch.as_tensor(y)).numpy(), x.numpy(), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize('rhs', [None, 3])
def test_matvec_grid_matches_jax(rhs):
    n, k = 64, 4
    spec = bc.GridSpec(n, k)
    a = _spd(n, seed=5)
    v = np.random.default_rng(6).normal(size=n if rhs is None else (n, rhs))
    g, jg = _both(a, spec)
    out = bc.matvec_grid(g, torch.as_tensor(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jbc.matvec_grid(jg, jnp.asarray(v))), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(out.numpy(), a @ v, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('n,target,align', [(63 * 24, 200, 63), (27 * 1000, 8192, 27), (63 * 1000, 8192, 63),
                                            (15 * 24, 6 * 15, 15)])
def test_grid_spec_alignment(n, target, align):
    spec, ref = bc.grid_spec(n, target_block=target, align=align), jbc.grid_spec(n, target_block=target, align=align)
    assert (spec.n, spec.k, spec.b) == (ref.n, ref.k, ref.b)
    assert spec.b % align == 0 and spec.k * spec.b == spec.n
    with pytest.raises(ValueError):
        bc.grid_spec(n + 1, align=align)


@pytest.mark.parametrize('name', ['f64', 'f32'])
def test_diag_add_and_failure_through_info(name):
    """An indefinite grid: the JAX factor fills with NaNs, the port's stops
    at the first leaf whose ``info`` is not 0 and says where; the shifted
    grid factors in both."""
    n, k = 32, 2
    spec = bc.GridSpec(n, k)
    a = _spd(n, seed=9) - 0.5 * np.eye(n)
    g, jg = _both(a, spec, name)
    L, info = bc.chol_grid(g)
    assert not bool(jbc.grid_isfinite(jbc.chol_grid(jg)))
    # LAPACK's order of the first minor that is not positive definite.
    assert info == int(torch.linalg.cholesky_ex(torch.as_tensor(a))[1]) > 0
    assert bc.grid_isfinite(L)  # cholesky_ex leaves a finite partial factor
    g, jg = _both(a, spec, name)
    assert bc.grid_diag_add(g, 1.0) is g
    L, info = bc.chol_grid(g)
    assert info == 0 and bool(jbc.grid_isfinite(jbc.chol_grid(jbc.grid_diag_add(jg, 1.0))))
    ref = np.linalg.cholesky(a + np.eye(n))
    assert np.abs(bc.grid_to_dense(L, spec) - ref).max() <= (1e-12 if name == 'f64' else 1e-5) * np.abs(ref).max()
    L[1][0][3, 2] = float('nan')
    assert not bc.grid_isfinite(L)


def _setup(m, n_atoms, seed=3):
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=m + 4, seed=seed)
    R = ds['R'][:m].reshape(m, -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R), n_atoms)
    jX, jJc = jax_descriptor_batch(jnp.asarray(R), n_atoms)
    return X, Jc, jX, jJc


@pytest.mark.parametrize('n_perms', [1, 2])
def test_assemble_grid_matches_jax(n_perms):
    """Ragged tiles (5 x 7 points into blocks of 6) past the padded point
    count, against the JAX grid and the port's dense assembly: f64 1e-12
    of max |K|; padded rows and columns zero, padded diagonal 1."""
    n_atoms, m, sig = 5, 20, 4.0
    X, Jc, jX, jJc = _setup(m, n_atoms)
    perms = np.stack([np.arange(n_atoms), np.r_[1, 0, 2, 3, 4]])[:n_perms]
    dperms = desc_perm_table(perms)
    dim_i = 3 * n_atoms
    spec = bc.grid_spec(24 * dim_i, target_block=6 * dim_i, align=dim_i)
    G = assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, spec, dtype=torch.float64, tile_i=5, tile_j=7)
    assert len(G) == spec.k == 4 and all(blk.dtype == torch.float64 for row in G for blk in row)
    A = bc.grid_to_dense(G, spec, full=True)
    ref = jbc.grid_to_dense(jax_assemble_kernel_grid(jX, jJc, dperms, sig, n_atoms, spec, dtype=jnp.float64,
                                                     tile_i=5, tile_j=7), spec, full=True)
    K = assemble_kernel(X, Jc, dperms, sig, n_atoms).numpy()
    n = m * dim_i
    assert np.abs(A - ref).max() <= 1e-12 * np.abs(K).max()
    np.testing.assert_allclose(A[:n, :n], -K, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(A[n:, n:], np.eye(spec.n - n))
    assert np.all(A[n:, :n] == 0)


def test_assemble_grid_f32_and_default_tiles():
    """float32 blocks from float32 descriptors at the default tiles (capped
    at a block's points) against the JAX package's f32 grid, 1e-5 of max
    |K|; with ``mm='ozaki'`` in float64 against the JAX package's, 1e-12."""
    n_atoms, m, sig = 5, 14, 4.0
    X, Jc, jX, jJc = _setup(m, n_atoms)
    dperms = desc_perm_table(np.arange(n_atoms)[None])
    spec = bc.GridSpec(16 * 3 * n_atoms, 4)
    G = assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, spec)
    assert G[0][0].dtype == torch.float32
    A = bc.grid_to_dense(G, spec, full=True)
    ref = jbc.grid_to_dense(jax_assemble_kernel_grid(jX, jJc, dperms, sig, n_atoms, spec), spec, full=True)
    assert np.abs(A - ref).max() <= 1e-5 * np.abs(ref).max()
    # mm='ozaki' (the pair route's assembly) takes float64 blocks, as the
    # JAX package's does (its float32 scan fails on the float64 products).
    with pytest.raises(ValueError, match='float64'):
        assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, spec, mm='ozaki')
    G64 = assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, spec, dtype=torch.float64, mm='ozaki')
    ref64 = jbc.grid_to_dense(jax_assemble_kernel_grid(jX, jJc, dperms, sig, n_atoms, spec, dtype=jnp.float64,
                                                       mm='ozaki'), spec, full=True)
    assert np.abs(bc.grid_to_dense(G64, spec, full=True) - ref64).max() <= 1e-12 * np.abs(ref64).max()
    with pytest.raises(ValueError, match='aligned'):
        assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, bc.GridSpec(16 * 3 * n_atoms, 5))
