"""The port's pair-precision block Cholesky (ops/pairchol.py) and its pair
assembly (ops/kernel.assemble_kernel_grid_pair) on the CPU against the JAX
package's, on tests/test_pairchol.py's inputs: n=256, k=4 at cond 1e8 for
the factor, 5 atoms and 16 points for the assembly.

The JAX results are computed once a module (a JAX factor and its int8
repack take several seconds). The JAX package's ``split_global_int8`` scale
is ``jnp.exp2`` of an f32 exponent, which XLA:CPU computes exactly only for
exponents in about [-12, 12] (2^26 comes out as 67,108,928); the port's is
the exponent's bits. Where the JAX scale is exact the slices agree bit for
bit; the solve's vectors reach 4.5e7 at cond 1e8, so the solve is held to
the JAX package with its scale made exact (as tests/test_torch_ozaki.py
does for the row scale), and as shipped within the JAX test's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import ozaki as jax_ozaki
from sgdml_tpu.ops import pairchol as jpc
from sgdml_tpu.ops.blockchol import GridSpec as JaxGridSpec
from sgdml_tpu.ops.blockchol import grid_spec as jax_grid_spec
from sgdml_tpu.ops.descriptor import descriptor_batch as jax_descriptor_batch
from sgdml_tpu.ops.kernel import assemble_kernel as jax_assemble_kernel
from sgdml_tpu.ops.kernel import assemble_kernel_grid_pair as jax_assemble_kernel_grid_pair
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import blockchol as bc
from sgdml_tpu_torch.ops import pairchol as pc
from sgdml_tpu_torch.ops.kernel import assemble_kernel_grid_pair

N, K = 256, 4


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Two torch threads while this module runs (the count restored after):
    the suite's workers share the machine's cores, and its CG tests keep
    wall budgets."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _np(x):
    return np.asarray(x, dtype=np.float64) if not torch.is_tensor(x) else x.double().numpy()


def _dense(hi, lo, spec):
    """The lower-triangle factor of a pair grid (either package) in f64."""
    b = spec.b
    L = np.zeros((spec.n, spec.n))
    for i in range(spec.k):
        for j in range(i + 1):
            blk = _np(hi[i][j]) + _np(lo[i][j])
            L[i * b:(i + 1) * b, j * b:(j + 1) * b] = np.tril(blk) if i == j else blk
    return L


def _to_torch(Lh, Ll):
    return ([[torch.as_tensor(np.array(x)) for x in row] for row in Lh],
            [[torch.as_tensor(np.asarray(x, dtype=np.float32)).to(torch.bfloat16) for x in row] for row in Ll])


def _stacks_equal(ours, theirs):
    """A SliceStack against the JAX ``(slices, sigma)``: the slices bit for
    bit, the padding zero, the same scale."""
    s = ours.slices
    assert s.shape[1] % 16 == 0 and s.shape[2] % 16 == 0
    assert not s[:, ours.rows:].any() and not s[:, :, ours.cols:].any()
    np.testing.assert_array_equal(s[:, :ours.rows, :ours.cols].numpy(), np.asarray(theirs[0]))
    assert float(ours.sigma) == float(theirs[1])


def _exact_split_global_int8(x64, n_slices=8, q=jax_ozaki.Q_BITS):
    """The JAX package's split_global_int8 with its scale as exponent bits."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    _, e = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(hi)), jnp.finfo(jnp.float32).tiny))
    sigma = jax.lax.bitcast_convert_type((e.astype(jnp.int32) + 127) << 23, jnp.float32)
    t = hi / sigma
    slices, t = jax_ozaki._extract_slices(t, 4, q)
    if n_slices > 4:
        t = t + (lo / sigma) * jnp.float32(2.0 ** (q * 4))
        more, _ = jax_ozaki._extract_slices(t, n_slices - 4, q)
        slices += more
    return jnp.stack(slices), sigma


@pytest.fixture(scope='module')
def ref():
    """The cond-1e8 system, the JAX factor, its leaf inverses, its int8
    repack and the port's factor of the same matrix."""
    A = _spd(N, 1e8, 0)
    spec = JaxGridSpec(N, K)
    jh, jl = jpc.chol_grid_pair(*jpc.grid_pair_from_dense64(A, spec))
    assert bool(jpc.grid_pair_isfinite(jh))
    jD = jpc.leaf_inverses(jh, jl)
    js = jpc.int8_strips(jpc.strips_from_grid([list(r) for r in jh], [list(r) for r in jl]))
    jsl = jpc.slice_leaf_inverses(list(jD))
    th, tl, info = pc.chol_grid_pair(*pc.grid_pair_from_dense64(A, bc.GridSpec(N, K)))
    return dict(A=A, spec=spec, jh=jh, jl=jl, jD=jD, js=js, jsl=jsl, th=th, tl=tl, info=info,
                L=_dense(jh, jl, spec))


def test_pair_split_at_rounding_ties():
    """``hi`` and ``lo`` of f64 values whose ``x - hi`` sits on, just above
    and just below a bf16 rounding tie (by less than an f32 ulp, so f32 and
    direct rounding differ) equal the JAX package's bit for bit: both round
    f64 to bf16 through f32."""
    rng = np.random.default_rng(0)
    e = rng.integers(-40, 5, 20_000)
    tie = 1.0 + (2 * rng.integers(0, 128, e.size) + 1) * 2.0**-8  # halfway between two bf16 values
    nudge = rng.choice([0.0, 1.0, -1.0], e.size) * 2.0 ** -rng.integers(25, 52, e.size)
    lo_part = tie * (1 + nudge) * 2.0 ** (e - 30.0)
    hi_part = np.float32(rng.standard_normal(e.size) * 2.0 ** e).astype(np.float64)
    x = np.concatenate([hi_part + lo_part, rng.standard_normal(5000) * 10.0 ** rng.integers(-6, 6, 5000)])
    hi, lo = pc.pair_split(torch.as_tensor(x))
    jhi, jlo = jpc.pair_split(jnp.asarray(x))
    assert hi.dtype == torch.float32 and lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.double().numpy(), np.asarray(jlo, dtype=np.float64))
    np.testing.assert_array_equal(pc.pair_to_f64(hi, lo).numpy(), np.asarray(jpc.pair_to_f64(jhi, jlo)))


def test_grid_pair_helpers_match_jax():
    """``grid_pair_from_dense64``, ``grid_pair_diag_add`` (at a shift below
    f32 resolution of the diagonal) and ``grid_pair_from_f32``: bit for
    bit."""
    A = _spd(96, 1e4, 5)
    spec = bc.GridSpec(96, 3)
    hi, lo = pc.grid_pair_diag_add(*pc.grid_pair_from_dense64(A, spec), 3e-9)
    jhi, jlo = jpc.grid_pair_diag_add(*jpc.grid_pair_from_dense64(A, JaxGridSpec(96, 3)), 3e-9)
    for i in range(3):
        for j in range(i + 1):
            np.testing.assert_array_equal(hi[i][j].numpy(), np.asarray(jhi[i][j]))
            np.testing.assert_array_equal(lo[i][j].double().numpy(), np.asarray(jlo[i][j], dtype=np.float64))
    assert np.abs(_dense(hi, lo, spec) - np.tril(A + 3e-9 * np.eye(96))).max() <= 2.0**-32 * np.abs(A).max()
    g32 = [[torch.as_tensor(np.float32(A[:32, :32]))]]
    h, l = pc.grid_pair_from_f32(g32)
    assert h[0][0] is g32[0][0] and l[0][0].dtype == torch.bfloat16 and not l[0][0].any()
    assert pc.grid_pair_isfinite(hi) and not pc.grid_pair_isfinite([[torch.full((2, 2), float('nan'))]])


def test_chol_grid_pair_matches_jax(ref):
    """The port's factor against the JAX factor of the same matrix: 1e-7 of
    max |L| (the panel solves' f32 substitutions round differently before
    the pair refinement); ``L L^T - A`` below 1e-8 of max |A|, the JAX
    bound, and no further from A than the JAX factor's within 10%."""
    assert ref['info'] == 0
    L = _dense(ref['th'], ref['tl'], ref['spec'])
    assert np.abs(L - ref['L']).max() <= 1e-7 * np.abs(ref['L']).max()
    A = ref['A']
    resid = np.abs(L @ L.T - A).max() / np.abs(A).max()
    resid_jax = np.abs(ref['L'] @ ref['L'].T - A).max() / np.abs(A).max()
    assert resid < 1e-8 and resid <= 1.1 * resid_jax, (resid, resid_jax)
    assert all(blk.dtype == torch.float32 for row in ref['th'] for blk in row)
    assert all(blk.dtype == torch.bfloat16 for row in ref['tl'] for blk in row)


@pytest.mark.parametrize('where', ['first leaf', 'second leaf'])
def test_indefinite(where):
    """A matrix that is not positive definite: the JAX factor is NaN, the
    port's ``info`` the order of the first failed minor, in the block column
    of the failed leaf (the port stops there)."""
    n, k = 128, 2
    A = _spd(n, 10, 3)
    at = 0 if where == 'first leaf' else 70
    A[at, at] = -5.0
    jh, _ = jpc.chol_grid_pair(*jpc.grid_pair_from_dense64(A, JaxGridSpec(n, k)))
    assert not bool(jpc.grid_pair_isfinite(jh))
    _, _, info = pc.chol_grid_pair(*pc.grid_pair_from_dense64(A, bc.GridSpec(n, k)))
    assert (0 < info <= 64) if where == 'first leaf' else (64 < info <= 71), info


def test_int8_repack_matches_jax_bit_for_bit(ref):
    """On the JAX factor: the leaf inverses (1e-12 of max |value|), the
    8-slice leaf stacks and the 7-slice strip stacks (slices and scales bit
    for bit; the scales here are exact in both packages)."""
    th, tl = _to_torch(ref['jh'], ref['jl'])
    D = pc.leaf_inverses(th, tl)
    for d, jd in zip(D, ref['jD']):
        assert np.abs(d.numpy() - np.asarray(jd)).max() <= 1e-12 * np.abs(np.asarray(jd)).max()
    leaves = pc.slice_leaf_inverses([torch.as_tensor(np.asarray(d)) for d in ref['jD']])
    for ours, theirs in zip(leaves, ref['jsl']):
        _stacks_equal(ours, theirs)
    strips = pc.int8_strips(pc.strips_from_grid(*_to_torch(ref['jh'], ref['jl'])))
    assert strips[-1] is None and ref['js'][-1] is None
    for ours, theirs in zip(strips[:-1], ref['js'][:-1]):
        _stacks_equal(ours, theirs)
        assert 2.0**-12 <= float(ours.sigma) <= 2.0**12


def test_strips_from_grid_consumes_the_grid(ref):
    th, tl = _to_torch(ref['jh'], ref['jl'])
    strips = pc.strips_from_grid(th, tl)
    b = ref['spec'].b
    assert [s[0].shape for s in strips[:-1]] == [((K - 1 - j) * b, b) for j in range(K - 1)]
    assert all(th[i][j] is None and tl[i][j] is None for i in range(K) for j in range(i))
    assert all(th[j][j] is not None for j in range(K))


def _port_repack(ref):
    th, tl = _to_torch(ref['jh'], ref['jl'])
    D = [torch.as_tensor(np.asarray(d)) for d in ref['jD']]
    return th, tl, D, pc.strips_from_grid(*_to_torch(ref['jh'], ref['jl']))


@pytest.mark.parametrize('rhs', [None, 3])
def test_solves_match_jax_and_the_dense_solve(ref, rhs):
    """Every solve on the JAX factor: ``solve_grid_pair`` and the pair-form
    ``solve_strips`` (f64 and sliced leaves) against the JAX package's and
    against the dense f64 solve with the same factor (1e-12, 1e-12 and
    1e-9 relative); ``solve_strips_int8`` against that dense solve (1e-9:
    its 2^-36 operand truncation amplified by cond 1e8; the JAX package's,
    with its inexact scales, ~1e-7) and against the JAX package's within
    the JAX test's bound (1e-5)."""
    y = np.random.default_rng(8).standard_normal(N if rhs is None else (N, rhs))
    L = ref['L']
    want = np.linalg.solve(L.T, np.linalg.solve(L, y))
    th, tl, D, strips = _port_repack(ref)
    yt = torch.as_tensor(y)

    def rel(a, c):
        return np.linalg.norm(_np(a) - _np(c)) / np.linalg.norm(_np(c))

    jg = jpc.solve_grid_pair(ref['jh'], ref['jl'], ref['jD'], jnp.asarray(y))
    g = pc.solve_grid_pair(th, tl, D, yt)
    assert g.shape == yt.shape and rel(g, jg) < 1e-12 and rel(g, want) < 1e-12
    jst = jpc.solve_strips(jpc.strips_from_grid([list(r) for r in ref['jh']], [list(r) for r in ref['jl']]),
                           ref['jD'], jnp.asarray(y))
    assert rel(pc.solve_strips(strips, D, yt), jst) < 1e-12
    leaves = pc.slice_leaf_inverses(list(D))
    assert rel(pc.solve_strips(strips, leaves, yt), want) < 1e-9
    x8 = pc.solve_strips_int8(pc.int8_strips(strips), leaves, yt)
    assert x8.shape == yt.shape and x8.dtype == torch.float64
    assert rel(x8, want) < 1e-9
    assert rel(x8, jpc.solve_strips_int8(ref['js'], ref['jsl'], jnp.asarray(y))) < 1e-5


@pytest.mark.parametrize('n,rhs', [(250, None), (N, 3)])
def test_solve_strips_int8_matches_jax_with_exact_scales(ref, monkeypatch, n, rhs):
    """With the JAX package's vector scale made exact, its int8 strip solve
    and the port's take the same slices of every vector and differ only in
    the order of f64 sums: 1e-12 relative, for a vector of 250 rows
    (zero-padded to the grid's 256) and a 3-column right-hand side."""
    monkeypatch.setattr(jax_ozaki, 'split_global_int8', _exact_split_global_int8)
    _, _, D, strips = _port_repack(ref)
    sstrips, leaves = pc.int8_strips(strips), pc.slice_leaf_inverses(D)
    y = np.random.default_rng(9).standard_normal(n if rhs is None else (n, rhs))
    x = pc.solve_strips_int8(sstrips, leaves, torch.as_tensor(y)).numpy()
    want = np.asarray(jpc.solve_strips_int8(ref['js'], ref['jsl'], jnp.asarray(y)))
    assert x.shape == y.shape
    assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-12


def test_strip_products_chunk_columns(ref, monkeypatch):
    """A many-column right-hand side in column chunks (a chunk budget of a
    few columns) gives the one-chunk result bit for bit."""
    _, _, D, strips = _port_repack(ref)
    sstrips, leaves = pc.int8_strips(strips), pc.slice_leaf_inverses(D)
    Y = torch.as_tensor(np.random.default_rng(10).standard_normal((N, 7)))
    whole = pc.solve_strips_int8(sstrips, leaves, Y)
    monkeypatch.setattr(pc, 'STRIP_CHUNK_BYTES', 200_000)
    assert pc._col_chunks(7, 150_000) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7)]
    np.testing.assert_array_equal(pc.solve_strips_int8(sstrips, leaves, Y).numpy(), whole.numpy())


@pytest.mark.parametrize('mm', ['native', 'ozaki'])
def test_assemble_kernel_grid_pair_matches_jax(mm):
    """The pair assembly at 5 atoms and 16 points (k=2, then 3 blocks that
    leave 3 padded points): against the JAX package's pair grid at the same
    ``mm`` (1e-12 of max |A|, f64 sums in another order) and against the
    dense JAX kernel below the pair-storage floor (2^-32 of max |K|); the lo
    parts carry sub-f32 information."""
    n_atoms, m, sig = 5, 16, 4.0
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=m + 2, seed=6)
    R = ds['R'][:m].reshape(m, -1)
    jX, jJc = jax_descriptor_batch(jnp.asarray(R), n_atoms)
    X, Jc = torch.as_tensor(np.asarray(jX)), torch.as_tensor(np.asarray(jJc))
    dperms = np.arange((n_atoms * (n_atoms - 1)) // 2)[None, :]
    dim_i = 3 * n_atoms
    K_ref = np.asarray(jax_assemble_kernel(jX, jJc, dperms, sig, n_atoms))
    scale = np.abs(K_ref).max()
    for k, m_pad in ((2, 16), (3, 18)):
        spec = bc.GridSpec(m_pad * dim_i, k)
        hi, lo = assemble_kernel_grid_pair(X, Jc, dperms, sig, n_atoms, spec, mm=mm)
        jhi, jlo = jax_assemble_kernel_grid_pair(np.asarray(jX), np.asarray(jJc), dperms, sig, n_atoms,
                                                 jax_grid_spec(m_pad * dim_i, spec.b, dim_i), mm=mm)
        assert all(h.dtype == torch.float32 and l.dtype == torch.bfloat16 for r, s in zip(hi, lo)
                   for h, l in zip(r, s))
        ours, theirs = _dense(hi, lo, spec), _dense(jhi, jlo, spec)
        assert np.abs(ours - theirs).max() <= 1e-12 * scale
        n = m * dim_i
        assert np.abs(ours[:n, :n] - np.tril(-K_ref)).max() < 2.0**-32 * scale
        assert np.array_equal(np.diag(ours)[n:], np.ones(spec.n - n))
        assert max(float(blk.abs().max()) for row in lo for blk in row) > 0
