"""The port's dense kernel assembly (ops/kernel.py) on the CPU against the
JAX package and the reference's golden kernels: Hessian tiles, the
assembled matrix with and without energy constraints, with permutations and
with periodic descriptors, tiling invariance with ragged tiles, and the
static tables."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import descriptor as jax_desc
from sgdml_tpu.ops import kernel as jax_kernel
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel
from sgdml_tpu_torch.predict import desc_perm_table

GOLDEN = pathlib.Path(__file__).parent / 'golden'
PERMS = {1: [[0, 1, 2, 3, 4]], 2: [[0, 1, 2, 3, 4], [1, 0, 2, 4, 3]]}


def _inputs(n_atoms=5, m=7, seed=0, lattice=None):
    """Descriptors of m jittered copies of one geometry, from both packages."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_atoms, 3)) * 1.5 + np.arange(n_atoms)[:, None] * 0.7
    R = (base[None] + rng.normal(size=(m, n_atoms, 3)) * 0.1).reshape(m, -1)
    lat_t = lat_j = None
    if lattice is not None:
        lat_t = (torch.as_tensor(lattice), torch.as_tensor(np.linalg.inv(lattice)))
        lat_j = (jnp.asarray(lattice), jnp.asarray(np.linalg.inv(lattice)))
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R), n_atoms, lat_t)
    Xj, Jcj = jax_desc.descriptor_batch(jnp.asarray(R), n_atoms, lat_j)
    return X, Jc, Xj, Jcj


def _close(ours, ref, rtol=1e-12):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


def test_hessian_tile_matches_jax():
    X, Jc, Xj, Jcj = _inputs(n_atoms=4, m=5)
    J, Jj = desc_ops.jacobian_full(Jc, 4), jax_desc.jacobian_full(Jcj, 4)
    ours = kernel.hessian_tile(X[:2], J[:2], X[2:], J[2:], 1.7)
    _close(ours, jax_kernel.hessian_tile(Xj[:2], Jj[:2], Xj[2:], Jj[2:], 1.7))
    assert ours.shape == (2, 12, 3, 12)


@pytest.mark.parametrize('n_perms', [1, 2])
def test_hessian_tile_compressed_matches_jax(n_perms):
    n_atoms = 5
    X, Jc, Xj, Jcj = _inputs(n_atoms=n_atoms, m=6)
    dperms = desc_perm_table(np.array(PERMS[n_perms]))
    key = kernel._perms_key(dperms)
    consts = kernel._tile_constants(key, n_atoms, torch.device('cpu'), torch.float64)
    Xp, Jcp = kernel.perm_tables(X, Jc, dperms)
    ours = kernel.hessian_tile_compressed(X[:3], Jc[:3], Xp[3:], Jcp[3:], 4.0, *consts)

    g_idx, sgn, a_diag, diag_col = jax_kernel._gram_maps_cached(key, n_atoms)
    Xpj, Jcpj = jax_kernel.perm_tables(Xj, Jcj, dperms)
    ref = jax_kernel.hessian_tile_compressed(
        Xj[:3], Jcj[:3], Xpj[3:], Jcpj[3:], 4.0, jnp.asarray(jax_desc.incidence(n_atoms)),
        jnp.asarray(jax_kernel.perm_incidence(dperms, n_atoms)), jnp.asarray(g_idx),
        jnp.asarray(sgn), jnp.asarray(a_diag), jnp.asarray(diag_col))
    _close(ours, ref)
    # mm='ozaki': the three D-contractions as 7-slice int8 products, against
    # the JAX package's (its slices are equal bit for bit; the f64 sums
    # around them differ in order) and within the slices' truncation of the
    # f64 tile.
    oz = kernel.hessian_tile_compressed(X[:3], Jc[:3], Xp[3:], Jcp[3:], 4.0, *consts, mm='ozaki')
    oz_j = jax_kernel.hessian_tile_compressed(
        Xj[:3], Jcj[:3], Xpj[3:], Jcpj[3:], 4.0, jnp.asarray(jax_desc.incidence(n_atoms)),
        jnp.asarray(jax_kernel.perm_incidence(dperms, n_atoms)), jnp.asarray(g_idx),
        jnp.asarray(sgn), jnp.asarray(a_diag), jnp.asarray(diag_col), mm='ozaki')
    _close(oz, oz_j)
    _close(oz, ref, 1e-9)
    with pytest.raises(ValueError, match='float64'):
        kernel.hessian_tile_compressed(X[:3].float(), Jc[:3], Xp[3:], Jcp[3:], 4.0, *consts, mm='ozaki')


@pytest.mark.parametrize('case', ['plain', 'ecstr', 'sym', 'sym+ecstr', 'pbc+sym+ecstr'])
def test_assemble_kernel_matches_jax(case):
    lattice = np.diag([4.1, 4.4, 4.7]) if 'pbc' in case else None
    X, Jc, Xj, Jcj = _inputs(n_atoms=5, m=7, seed=1, lattice=lattice)
    dperms = desc_perm_table(np.array(PERMS[2 if 'sym' in case else 1]))
    use_E_cstr = 'ecstr' in case
    K = kernel.assemble_kernel(X, Jc, dperms, 3.0, 5, use_E_cstr=use_E_cstr, tile_i=3, tile_j=4)
    K_j = jax_kernel.assemble_kernel(Xj, Jcj, dperms, 3.0, 5, use_E_cstr=use_E_cstr, tile_i=3, tile_j=4)
    assert K.shape == (7 * 15 + (7 if use_E_cstr else 0),) * 2 and K.dtype == torch.float64
    _close(K, K_j)
    np.testing.assert_allclose(K.numpy(), K.numpy().T, rtol=1e-10, atol=1e-12 * K.abs().max().item())


@pytest.mark.parametrize('tiles', [(None, None), (4, 2), (3, 5)])
@pytest.mark.parametrize('fixture', ['kernel_ref.npz', 'kernel_ecstr_ref.npz'])
def test_golden_parity_with_reference(fixture, tiles):
    data = np.load(GOLDEN / fixture)
    perms = data['perms']
    K = kernel.assemble_kernel(
        torch.as_tensor(data['R_desc']), torch.as_tensor(data['R_d_desc']), desc_perm_table(perms),
        float(data['sig']), perms.shape[1], use_E_cstr='ecstr' in fixture, tile_i=tiles[0], tile_j=tiles[1])
    np.testing.assert_allclose(K.numpy(), data['K'], rtol=1e-8, atol=1e-10)


def test_tiling_invariance_with_ragged_tiles():
    X, Jc, _, _ = _inputs(n_atoms=5, m=7, seed=2)
    dperms = desc_perm_table(np.array(PERMS[2]))
    K = kernel.assemble_kernel(X, Jc, dperms, 2.5, 5, use_E_cstr=True, tile_i=7, tile_j=7)
    for ti, tj in [(2, 3), (3, 2), (1, 4), (5, 6)]:
        K2 = kernel.assemble_kernel(X, Jc, dperms, 2.5, 5, use_E_cstr=True, tile_i=ti, tile_j=tj)
        np.testing.assert_allclose(K2.numpy(), K.numpy(), rtol=1e-12, atol=1e-14)


def test_static_tables_match_jax():
    n_atoms = 5
    X, Jc, _, _ = _inputs(n_atoms=n_atoms, m=3)
    Xj, Jcj = jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy())
    dperms = desc_perm_table(np.array(PERMS[2]))
    for ours, ref in zip(kernel.gram_maps(dperms, n_atoms), jax_kernel.gram_maps(dperms, n_atoms)):
        np.testing.assert_array_equal(ours, ref)
    s_perm = kernel.perm_incidence(dperms, n_atoms)
    np.testing.assert_array_equal(s_perm, jax_kernel.perm_incidence(dperms, n_atoms))
    Xp, Jcp = kernel.perm_tables(X, Jc, dperms)
    Xpj, Jcpj = jax_kernel.perm_tables(Xj, Jcj, dperms)
    np.testing.assert_array_equal(Xp.numpy(), np.asarray(Xpj))
    np.testing.assert_array_equal(Jcp.numpy(), np.asarray(Jcpj))
    full = kernel.expand_perm_jacobian(Jcp, torch.as_tensor(s_perm))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jax_kernel.expand_perm_jacobian(Jcpj, s_perm)))


@pytest.mark.parametrize('m, n_atoms', [(1000, 9), (200, 21), (3000, 60), (3, 5)])
def test_tile_sizes(m, n_atoms):
    """The formula is the JAX package's at its 64 MB budget; the default
    uses the port's budget, and a tile's five planes stay within it."""
    old = kernel._tile_sizes(m, n_atoms, 64 * 1024**2, 8)
    assert old == jax_kernel.default_tile_sizes(m, n_atoms, 1)
    ti, tj = kernel.default_tile_sizes(m, n_atoms, 3)
    assert 1 <= ti <= m and 1 <= tj <= m and ti >= old[0] and tj >= old[1]
    per_pair = (5 * 9 * n_atoms**2 + 8 * desc_ops.descriptor_dim(n_atoms)) * 8
    assert ti * tj * per_pair <= max(kernel.TILE_BUDGET_BYTES, per_pair)
