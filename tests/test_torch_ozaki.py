"""The port's Ozaki int8 products (sgdml_tpu_torch/ops/ozaki.py) on the CPU
against the JAX package's (tests/test_ozaki.py's operands): slices and
scales bit for bit, the products within 1e-14 relative of the JAX package's
and within the truncation bound of float64, shapes that need the padding of
``_int8_mm``, and the contraction guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import ozaki as jax_ozaki
from sgdml_tpu_torch.ops import ozaki


def _rand(m, k, seed, scale_spread=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)) * np.exp(scale_spread * rng.standard_normal((m, 1)))


def _pair(x):
    hi = np.float32(x)
    return hi, np.float32(x - np.float64(hi))


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('n_slices', [4, 6, 7, 8, 10])
@pytest.mark.parametrize('with_lo', [False, True])
def test_split_pair_matches_jax_bit_for_bit(n_slices, with_lo):
    hi, lo = _pair(_rand(64, 96, 0, scale_spread=2.0))
    lo = lo if with_lo else None
    s, sig = ozaki.split_pair_int8(_t(hi), None if lo is None else _t(lo), n_slices)
    s_j, sig_j = jax_ozaki.split_pair_int8(jnp.asarray(hi), None if lo is None else jnp.asarray(lo), n_slices)
    assert s.dtype == torch.int8 and s.shape == (n_slices, 64, 96) and sig.shape == (64, 1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_j))


def test_split_reconstructs_to_row_scale():
    """tests/test_ozaki.py:25-54: 4 slices reproduce f32 to 2^-25 of the row
    scale; 6 slices of a pair to 2^-35."""
    a64 = _rand(32, 48, 1)
    hi, lo = _pair(a64)
    for n, target, lo_t, bound in ((4, np.float64(hi), None, 2.0 ** -25), (6, a64, _t(lo), 2.0 ** -35)):
        s, sig = ozaki.split_pair_int8(_t(hi), lo_t, n)
        rec = sum(s[i].double().numpy() * 2.0 ** (-ozaki.Q_BITS * (i + 1)) for i in range(n)) * sig.double().numpy()
        assert (np.abs(rec - target) / sig.double().numpy()).max() <= bound


def test_split_global_matches_jax_bit_for_bit():
    x = _rand(96, 64, 11) * 3.0
    for n in (6, 8):
        s, sig = ozaki.split_global_int8(_t(x), n)
        s_j, sig_j = jax_ozaki.split_global_int8(jnp.asarray(x), n)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
        assert sig.dim() == 0 and float(sig) == float(sig_j) == 4.0 * 2.0 ** int(np.log2(np.abs(x).max() / 4) + 1)


def test_scales_are_exact_powers_of_two(monkeypatch):
    """Every row scale is 2^e with 2^(e-1) <= max |row| < 2^e, across 60
    binades, and the slices then equal the JAX package's given exact scales.
    (Its own ``jnp.exp2`` is not exact on XLA:CPU past |e| ~ 12, so there
    its scales are no powers of two.)"""
    e = np.arange(-30, 30)
    a = _rand(60, 40, 2, 0.0)
    hi = np.float32(a / np.abs(a).max(1, keepdims=True) * 0.75 * 2.0 ** e[:, None])
    s, sig = ozaki.split_pair_int8(_t(hi), None, 7)
    np.testing.assert_array_equal(sig.numpy()[:, 0], np.float32(2.0 ** e))

    def exact_row_scale(h):
        _, ex = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(h), axis=1, keepdims=True), jnp.finfo(jnp.float32).tiny))
        return jax.lax.bitcast_convert_type((ex.astype(jnp.int32) + 127) << 23, jnp.float32)

    monkeypatch.setattr(jax_ozaki, '_row_scale', exact_row_scale)
    s_j, sig_j = jax_ozaki.split_pair_int8(jnp.asarray(hi), None, 7)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize('shape', [(48, 56, 96), (48, 56, 1024), (5, 3, 1770), (17, 24, 33), (40, 9, 210)])
def test_gemm_matches_jax_and_f64(shape):
    """ozaki_gemm_nt on pair operands (tests/test_ozaki.py:57-80) against the
    JAX package's (1e-14 relative) and float64 (its truncation bound and
    1e-8 relative), at shapes that need every padding of ``_int8_mm``: 5 rows,
    an inner 1,770 and 33, 3 and 9 outer columns."""
    m, n, k = shape
    a64, b64 = _rand(m, k, 2, scale_spread=2.0), _rand(n, k, 3, scale_spread=2.0)
    (ah, al), (bh, bl) = _pair(a64), _pair(b64)
    got = ozaki.ozaki_gemm_nt(_t(ah), _t(bh), lo_a=_t(al), lo_b=_t(bl)).numpy()
    ref = np.asarray(jax_ozaki.ozaki_gemm_nt(jnp.asarray(ah), jnp.asarray(bh), lo_a=jnp.asarray(al),
                                             lo_b=jnp.asarray(bl)))
    assert _rel(got, ref) <= 1e-14
    want = a64 @ b64.T
    sa = 2.0 ** np.ceil(np.log2(np.abs(a64).max(1, keepdims=True)))
    sb = 2.0 ** np.ceil(np.log2(np.abs(b64).max(1, keepdims=True)))
    assert np.all(np.abs(got - want) <= 8.0 * k * 2.0 ** (-ozaki.Q_BITS * ozaki.DEFAULT_SLICES) * (sa * sb.T))
    assert _rel(got, want) < 1e-8


def test_gemm_no_sqrt_k_growth():
    """f32 operands over a long contraction: the product of the stored values
    is exact to the truncation bound, whatever the accumulation order."""
    k = 4096
    rng = np.random.default_rng(7)
    a, b = np.float32(rng.standard_normal((16, k))), np.float32(rng.standard_normal((16, k)))
    got = ozaki.ozaki_gemm_nt(_t(a), _t(b)).numpy()
    want = np.float64(a) @ np.float64(b).T
    assert np.abs(got - want).max() < k * 2.0 ** (-42) * 16
    assert _rel(got, want) < 1e-9


def test_contraction_dim_guard():
    for n in (6, 7, 8, 10):
        assert ozaki.max_contraction_dim(n) == jax_ozaki.max_contraction_dim(n)
    a = torch.zeros(4, 2**19)
    with pytest.raises(ValueError, match='contraction dim'):
        ozaki.ozaki_gemm_nt(a, a)
    stack = torch.zeros(8, 4, 2 * 30000, dtype=torch.int8)
    with pytest.raises(ValueError, match='chunk overflows'):
        ozaki.matvec_sliced_long(stack, torch.tensor(1.0), torch.zeros(60000, dtype=torch.float64), chunk=30000)
    with pytest.raises(ValueError, match='row dim'):
        ozaki.matvec_sliced_long_t(torch.zeros(8, 30000, 16, dtype=torch.int8), torch.tensor(1.0),
                                   torch.zeros(30000, dtype=torch.float64), chunk=16)
    with pytest.raises(ValueError, match='chunk multiple'):
        ozaki.matvec_sliced_long(stack, torch.tensor(1.0), torch.zeros(60000, dtype=torch.float64), chunk=7)


@pytest.mark.parametrize('rows,cols', [(96, 64), (5, 33)])
def test_matvec_sliced_matches_jax(rows, cols):
    """A v and A^T V from one global-scale stack (tests/test_ozaki.py:105-118)
    against the JAX package's (1e-14 relative) and float64 (1e-11)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((rows, cols))
    v1, v2 = rng.standard_normal(cols), rng.standard_normal((rows, 3))
    sa, sig = ozaki.split_global_int8(_t(A))
    sa_j, sig_j = jax_ozaki.split_global_int8(jnp.asarray(A))
    for v, transpose, want in ((v1, False, A @ v1), (v2, True, A.T @ v2)):
        got = ozaki.matvec_sliced(sa, sig, _t(v), transpose=transpose).numpy()
        ref = np.asarray(jax_ozaki.matvec_sliced(sa_j, sig_j, jnp.asarray(v), transpose=transpose))
        assert _rel(got, ref) <= 1e-14 and _rel(got, want) <= 1e-11


@pytest.mark.parametrize('k,chunk', [(37, 250), (48, 256)])
@pytest.mark.parametrize('per_chunk', [True, False])
def test_matvec_sliced_long_matches_jax(k, chunk, per_chunk):
    """The chunked long-contraction products and their transpose
    (tests/test_ozaki.py:121-161) with per-chunk and global scales, against
    the JAX package's (1e-14 relative) and float64 (1e-10): a 250-column
    chunk of 37 rows is padded by ``_int8_mm``, a 256-column chunk of 48 rows
    is read in place."""
    rng = np.random.default_rng(5)
    n = 5 * chunk
    A = rng.normal(size=(k, n)) * np.exp(rng.normal(size=(k, 1)))
    v, w = rng.normal(size=n), rng.normal(size=k)
    if per_chunk:
        parts = [ozaki.split_global_int8(_t(A[:, c:c + chunk])) for c in range(0, n, chunk)]
        parts_j = [jax_ozaki.split_global_int8(jnp.asarray(A[:, c:c + chunk])) for c in range(0, n, chunk)]
        sa, sig = torch.cat([p[0] for p in parts], 2), torch.stack([p[1] for p in parts])
        sa_j, sig_j = jnp.concatenate([p[0] for p in parts_j], 2), jnp.stack([p[1] for p in parts_j])
    else:
        sa, sig = ozaki.split_global_int8(_t(A))
        sa_j, sig_j = jax_ozaki.split_global_int8(jnp.asarray(A))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(sa_j))
    got = ozaki.matvec_sliced_long(sa, sig, _t(v), chunk=chunk).numpy()
    ref = np.asarray(jax_ozaki.matvec_sliced_long(sa_j, sig_j, jnp.asarray(v), chunk=chunk))
    assert _rel(got, ref) <= 1e-14 and _rel(got, A @ v) < 1e-10
    got_t = ozaki.matvec_sliced_long_t(sa, sig, _t(w), chunk=chunk).numpy()
    ref_t = np.asarray(jax_ozaki.matvec_sliced_long_t(sa_j, sig_j, jnp.asarray(w), chunk=chunk))
    assert _rel(got_t, ref_t) <= 1e-14 and _rel(got_t, A.T @ w) < 1e-10


@pytest.mark.parametrize('m,k,n,b_layout', [(5, 1770, 3, 'rows'), (24, 16, 8, 'cols'), (40, 100, 9, 'rows'),
                                            (17, 33, 16, 'cols'), (64, 48, 24, 'strided'), (96, 48, 8, 'a^T'),
                                            (90, 40, 8, 'a^T')])
def test_int8_mm_is_exact(m, k, n, b_layout):
    """``_int8_mm`` on shapes the card's product refuses as they are (few
    rows, ragged inner and outer sizes, strided and column-major operands,
    an unaligned column-major ``a``) equals the exact integer product."""
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.integers(-96, 97, size=(m, k)), dtype=torch.int8)
    if b_layout == 'a^T':  # the transposed stack product: a column chunk of a slice, read as A^T
        a = torch.as_tensor(rng.integers(-96, 97, size=(k, 2 * m)), dtype=torch.int8)[:, m:].T
        b = torch.as_tensor(rng.integers(-96, 97, size=(n, k)), dtype=torch.int8).T
    elif b_layout == 'cols':
        b = torch.as_tensor(rng.integers(-96, 97, size=(n, k)), dtype=torch.int8).T
    elif b_layout == 'strided':
        b = torch.as_tensor(rng.integers(-96, 97, size=(k, 3 * n)), dtype=torch.int8)[:, 5:5 + n]
        a = torch.as_tensor(rng.integers(-96, 97, size=(m, 2 * k)), dtype=torch.int8)[:, 3:3 + k]
    else:
        b = torch.as_tensor(rng.integers(-96, 97, size=(k, n)), dtype=torch.int8)
    out = ozaki._int8_mm(a, b)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out.long(), a.long() @ b.long())
