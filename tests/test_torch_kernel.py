"""The port's dense kernel assembly (ops/kernel.py) on the CPU against the
JAX package and the reference's golden kernels: Hessian tiles, the
assembled matrix with and without energy constraints, with permutations and
with periodic descriptors, tiling invariance with ragged tiles, the static
tables, and the plain path of ``perm_summed_block_`` against the tile and
its permuted copy.

The tests marked ``card`` hold the permutation-summed Hessian kernel
(``csrc/perm_hessian.cu``) to its plain version on a CUDA card; run them
there with ``python3 -m pytest --noconftest tests/test_torch_kernel.py -m
card``. That machine has no JAX, so this file imports the JAX package only
where it is installed; the card tests do not use it."""

import pathlib
import sys

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from sgdml_tpu.ops import descriptor as jax_desc
    from sgdml_tpu.ops import kernel as jax_kernel
except ImportError:  # the card's machine: only the card tests run there
    jnp = jax_desc = jax_kernel = None

from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel
from sgdml_tpu_torch.predict import desc_perm_table

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from benchmark import synthetic_sym  # noqa: E402

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


# -- perm_summed_block_ -------------------------------------------------------


def _sym_inputs(n_atoms, m, n_perms, dtype=torch.float64, device='cpu', seed=4):
    """Descriptors of m seeded displacements of the C3v molecule of
    ``benchmark/synthetic_sym.py`` with its group of 6, or of a seeded random
    geometry with the identity alone; the permuted tables and the static
    tables."""
    if n_perms == 6:
        pos = synthetic_sym.make_molecule(n_atoms, seed=3)[0]
        perms = synthetic_sym.group_perms(pos)
    else:
        pos = np.random.default_rng(1).normal(size=(n_atoms, 3)) * 0.8 * n_atoms ** (1 / 3)
        perms = np.arange(n_atoms)[None]
    R = pos[None] + 0.1 * np.random.default_rng(seed).normal(size=(m, n_atoms, 3))
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R.reshape(m, -1), dtype=dtype, device=device), n_atoms)
    dperms = desc_perm_table(perms)
    Xp, Jcp = kernel.perm_tables(X, Jc, dperms)
    consts = kernel._tile_constants(kernel._perms_key(dperms), n_atoms, X.device, dtype)
    return X, Jc, Xp, Jcp, dperms, consts


def _old_copy(big, r0, c0, X, Jc, Xp, Jcp, sig, consts, scale, tile_i, tile_j):
    """What the callers wrote before the wrapper: ``_perm_summed_tile`` tile
    by tile, copied through the permuted view (and negated for ``-K``)."""
    n_atoms = consts[0].shape[1]
    n3 = 3 * n_atoms
    for i0 in range(0, X.shape[0], tile_i):
        i1 = min(X.shape[0], i0 + tile_i)
        for j0 in range(0, Xp.shape[0], tile_j):
            j1 = min(Xp.shape[0], j0 + tile_j)
            blk = kernel._perm_summed_tile(X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], sig, *consts)
            view = big[r0 + i0 * n3:r0 + i1 * n3, c0 + j0 * n3:c0 + j1 * n3].view(
                i1 - i0, n_atoms, 3, j1 - j0, n_atoms, 3).copy_(blk.permute(0, 2, 3, 1, 4, 5))
            if scale == -1.0:
                view.neg_()


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('scale', [1.0, -1.0])
@pytest.mark.parametrize('n_perms', [1, 6])
@pytest.mark.parametrize('ranges', [((1, 6), (2, 7), 2, 3), ((0, 7), (0, 7), 7, 7), ((3, 4), (1, 6), 1, 4)])
def test_the_plain_block_is_the_tile_and_its_permuted_copy_bit_for_bit(ranges, n_perms, scale, dtype):
    """Ragged row and column ranges and tiles, written into a strided view
    of a larger matrix: the same bits as the tile loop the callers ran
    before, and nothing outside the view touched."""
    (i0, i1), (j0, j1), tile_i, tile_j = ranges
    n_atoms = 9
    X, Jc, Xp, Jcp, _, consts = _sym_inputs(n_atoms, 7, n_perms, dtype)
    n3 = 3 * n_atoms
    r0, c0 = 5, 11
    shape = (r0 + (i1 - i0) * n3 + 4, c0 + (j1 - j0) * n3 + 3)
    got = torch.full(shape, float('nan'), dtype=dtype)
    want = got.clone()
    view = got[r0:r0 + (i1 - i0) * n3, c0:c0 + (j1 - j0) * n3]
    out = kernel.perm_summed_block_(view, X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], 2.5, consts, scale=scale,
                                    tile_i=tile_i, tile_j=tile_j)
    assert out is view
    _old_copy(want, r0, c0, X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], 2.5, consts, scale, tile_i, tile_j)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == got.numel() - view.numel()
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize('case', ['shape', 'dtype', 'stride', 'ozaki_f32'])
def test_the_block_refuses_what_it_cannot_write(case):
    X, Jc, Xp, Jcp, _, consts = _sym_inputs(6, 4, 1)
    out = torch.zeros(2 * 18, 3 * 18, dtype=torch.float64)
    args = [out, X[:2], Jc[:2], Xp[:3], Jcp[:3], 2.0, consts]
    kw = {}
    if case == 'shape':
        args[0] = torch.zeros(2 * 18, 2 * 18, dtype=torch.float64)
    elif case == 'dtype':
        args[3] = Xp[:3].float()
    elif case == 'stride':
        args[0] = torch.zeros(3 * 18, 2 * 18, dtype=torch.float64).T
    else:
        args[1:5] = [a.float() for a in args[1:5]]
        args[0] = out.float()
        kw['mm'] = 'ozaki'
    with pytest.raises(ValueError):
        kernel.perm_summed_block_(*args, **kw)


def test_the_plain_block_launches_nothing_and_counts_no_kernel_blocks():
    from sgdml_tpu_torch.utils import profiling

    X, Jc, Xp, Jcp, dperms, consts = _sym_inputs(9, 5, 6)
    before = kernel.LAUNCHES
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        kernel.assemble_kernel(X, Jc, dperms, 3.0, 9, tile_i=2, tile_j=3)
        assert profiling.counter('assembly.perm_blocks') == 5 * 5 * 6
        assert profiling.counter('assembly.kernel_blocks') == 0
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_assemble_kernel_with_the_group_of_six_matches_jax(use_E_cstr):
    X, Jc, _, _, dperms, _ = _sym_inputs(9, 6, 6)
    Xj, Jcj = jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy())
    K = kernel.assemble_kernel(X, Jc, dperms, 3.0, 9, use_E_cstr=use_E_cstr, tile_i=4, tile_j=5)
    _close(K, jax_kernel.assemble_kernel(Xj, Jcj, dperms, 3.0, 9, use_E_cstr=use_E_cstr, tile_i=4, tile_j=5))


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


# (label, N, P, M, row range, column range): the aspirin width with and
# without its group of 6, the AT-AT width, and ragged ranges of each.
CARD_CASES = [
    ('aspirin P=1', 21, 1, 24, (0, 24), (0, 24)),
    ('aspirin P=6', 21, 6, 24, (0, 24), (0, 24)),
    ('aspirin P=6 ragged', 21, 6, 24, (3, 20), (5, 22)),
    ('AT-AT P=1', 60, 1, 12, (0, 12), (0, 12)),
    ('AT-AT P=1 ragged', 60, 1, 12, (1, 10), (2, 11)),
    ('N=9 P=6 ragged', 9, 6, 30, (7, 29), (1, 30)),
]
CARD_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_the_kernel_matches_its_plain_version_and_repeats_its_bits(card, case, dtype):
    """f64 within 1e-13 of max |K|, f32 within 1e-5 (the plain version
    runs on the CPU in the same precision; sums differ in order), written
    into a strided view with nothing outside it touched, the same bits on
    a second launch."""
    _, n_atoms, n_perms, m, (i0, i1), (j0, j1) = case
    n3 = 3 * n_atoms
    want = None
    for device in ('cpu', card):
        X, Jc, Xp, Jcp, _, consts = _sym_inputs(n_atoms, m, n_perms, dtype, device)
        big = torch.full((2 + (i1 - i0) * n3, 5 + (j1 - j0) * n3), float('nan'), dtype=dtype, device=device)
        view = big[1:1 + (i1 - i0) * n3, 3:3 + (j1 - j0) * n3]
        before = kernel.LAUNCHES
        kernel.perm_summed_block_(view, X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], 20.0, consts, scale=-1.0)
        if want is None:
            want = big
            continue
        assert kernel.LAUNCHES == before + 1
        again = big.clone()
        kernel.perm_summed_block_(again[1:1 + (i1 - i0) * n3, 3:3 + (j1 - j0) * n3], X[i0:i1], Jc[i0:i1],
                                  Xp[j0:j1], Jcp[j0:j1], 20.0, consts, scale=-1.0)
        torch.cuda.synchronize(card)
        got = big.cpu()
        assert torch.equal(got.isnan(), want.isnan())
        err = float((torch.nan_to_num(got) - torch.nan_to_num(want)).abs().max())
        assert err <= CARD_TOL[dtype] * float(torch.nan_to_num(want).abs().max()), err
        assert torch.equal(torch.nan_to_num(again.cpu()), torch.nan_to_num(got))


@pytest.mark.card
def test_a_native_cuda_call_never_reaches_the_torch_tile(card, monkeypatch):
    """assemble_kernel (with and without energy constraints), the grid and
    pair routes' blocks and a one-rank mesh strip on the card: all through
    the kernel; the mesh strip's force block is the single device's bit for
    bit."""
    from sgdml_tpu_torch.ops.blockchol import GridSpec
    from sgdml_tpu_torch.parallel import mesh as mesh_mod
    from sgdml_tpu_torch.parallel import spmd

    def refuse(*args, **kwargs):
        raise AssertionError('_perm_summed_tile reached on a native CUDA call')

    n_atoms, m = 9, 10
    X, Jc, _, _, dperms, _ = _sym_inputs(n_atoms, m, 6, torch.float64, card)
    monkeypatch.setattr(kernel, '_perm_summed_tile', refuse)
    before = kernel.LAUNCHES
    K = kernel.assemble_kernel(X, Jc, dperms, 3.0, n_atoms)
    K_e = kernel.assemble_kernel(X, Jc, dperms, 3.0, n_atoms, use_E_cstr=True, tile_i=3, tile_j=4)
    n_f = m * 3 * n_atoms
    assert torch.equal(K_e[:n_f, :n_f], K)
    spec = GridSpec(16 * 3 * n_atoms, 4)  # blocks of 4 points; the last block row all padding
    grid = kernel.assemble_kernel_grid(X, Jc, dperms, 3.0, n_atoms, spec, dtype=torch.float32)
    hi, _ = kernel.assemble_kernel_grid_pair(X, Jc, dperms, 3.0, n_atoms, spec)
    assert len(grid) == 4 and len(hi) == 4
    mesh_mod.init_distributed(world_size=1, rank=0, device='cuda')
    try:
        K_loc, _ = spmd.assemble_kernel_sharded(X, Jc, dperms, 3.0, n_atoms, mesh_mod.default_mesh(1, device='cuda'))
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(K_loc[:n_f, :n_f], K)
    # 2 assemblies, the 6 grid blocks of real points each for f32 and pair
    # (the 4 of padding alone launch nothing), one strip.
    assert kernel.LAUNCHES - before == 2 + 6 + 6 + 1
