"""Ozaki-scheme exact-accumulation products on int8 tensor cores.

Each operand is split into power-of-two-scaled int8 mantissa slices; slice
pairs are multiplied with int32 accumulation, which is exact; the level
sums are recombined with their scales in float64. The result is a product
with ``~q * n_slices``-bit effective mantissas whose only error is the
a-priori-bounded slice truncation: no accumulation-order noise, no
``sqrt(K)`` error growth. Same functions, arguments and results as
``sgdml_tpu.ops.ozaki`` (slices and scales bit for bit).

Operands are "pair floats": ``(hi, lo)`` with ``hi`` float32 and ``lo`` a
lower-precision correction (float32 or None), representing ``hi + lo`` at up
to ~47 significant bits.

Every int8 product is :func:`_int8_mm`, over ``torch._int_mm`` (cuBLASLt on a
card, an exact int32 product on the CPU). It zero-pads its operands to what
the CUDA product takes on every device, so the CPU runs the same padding
code; zero rows and columns add nothing to an exact sum. Where the JAX
package multiplies slice pairs one at a time, the products here take several
slices at once (the vector's 8 slices as 8 columns; a stack's slices as one
tall operand), and the level sums are formed from the batched results.
"""

from __future__ import annotations

import torch

__all__ = [
    'DEFAULT_SLICES',
    'Q_BITS',
    'max_contraction_dim',
    'matvec_sliced',
    'matvec_sliced_long',
    'matvec_sliced_long_t',
    'ozaki_gemm_nt',
    'ozaki_gemm_nt_f64',
    'split_global_int8',
    'split_pair_int8',
]

# q bits of mantissa per int8 slice. q=6 keeps |first slice| <= 64 and
# |later slices| <= 32, so any slice-pair product is <= 2^12 and an int32
# level accumulation over K terms stays exact for K <= 2^18.
Q_BITS = 6
# 7 slices = 42-bit coverage below the row scale: elements down to 2^-9 of
# their row max keep every bit an (f32, f32) pair carries.
DEFAULT_SLICES = 7

_INT32_MAX = 2**31
# Bytes of int32 products, level sums and float64 partials that one row
# block of :func:`_gemm_from_slices` may hold; the rows of a product are
# taken in blocks of that size (a (k, k) Gram at k ~ 15,000 would otherwise
# hold ~10 int32 planes of k^2 at once).
_GEMM_BLOCK_BYTES = 2 << 30


def max_contraction_dim(n_slices: int = DEFAULT_SLICES, q: int = Q_BITS):
    """Largest inner dimension with provably exact int32 level sums.

    Slice values are bounded by ``2^q`` except the first lo-continuation
    slice, which carries the folded-in lo part and can reach ``1.5 * 2^q``;
    the guard uses the worst product ``(1.5 * 2^q)^2``."""
    worst = int(1.5 * 2**q) ** 2
    return _INT32_MAX // (n_slices * worst)


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def _aligned(x, ld: int) -> bool:
    """16-byte aligned start and leading dimension."""
    return x.data_ptr() % 16 == 0 and ld % 16 == 0


def _int8_mm(a, b):
    """``a (m, k) @ b (k, n)`` of int8 tensors, exact in int32.

    ``torch._int_mm`` on a card takes ``m > 16`` and ``k`` and ``n``
    multiples of 8, each operand row- or column-major (the column-major
    ``a`` checked on the H100 with torch 2.11: ``chip_smoke.py
    --stack-apply``).
    Operands that miss these (or a 16-byte aligned start and leading
    dimension) are copied into zero-padded row-major ones (``m`` to 24 when
    at most 16, ``k`` and ``n`` to multiples of 16) on every device, and the
    result is cut back to ``(m, n)``. A product the library refuses raises:
    there is no other route.
    """
    m, k = a.shape
    n = b.shape[1]
    kp = _ceil(k, 16)
    a_rows = a.stride(1) == 1 and _aligned(a, a.stride(0))
    a_cols = a.stride(0) == 1 and _aligned(a, a.stride(1))
    if not (m > 16 and k == kp and (a_rows or a_cols)):
        pad = a.new_zeros((m if m > 16 else 24, kp))
        pad[:m, :k] = a
        a = pad
    b_rows = b.stride(1) == 1 and _aligned(b, b.stride(0))
    b_cols = b.stride(0) == 1 and _aligned(b, b.stride(1))
    if not (k == kp and n % 8 == 0 and (b_rows or b_cols)):
        pad = b.new_zeros((_ceil(n, 16), kp))
        pad[:n, :k] = b.T
        b = pad.T
    out = torch._int_mm(a, b)
    return out if out.shape == (m, n) else out[:m, :n]


def _pow2(e):
    """``2^e`` in float32 for int32 exponents, exact: the exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _row_scale(hi):
    """Per-row power-of-two scale sigma >= max|row| (exact in f32)."""
    rowmax = torch.amax(torch.abs(hi), dim=1, keepdim=True)
    _, e = torch.frexp(torch.clamp_min(rowmax, torch.finfo(torch.float32).tiny))
    return _pow2(e)  # 2^e >= rowmax, power of two


def _extract_slices(t, n, q):
    """n int8 slices of t in [-1, 1]; slice s has weight 2^-q(s+1).

    All arithmetic is exact in f32: t * 2^q is a power-of-two scaling, the
    rounded value (half to even, as ``jnp.round``) is a small integer, and
    their difference fits the mantissa.
    """
    out = []
    two_q = 2.0**q
    for _ in range(n):
        v = torch.round(t * two_q)
        out.append(v.to(torch.int8))
        t = t * two_q - v
    return out, t


def _split(hi, lo, sigma, n_slices, q):
    """Slices of ``(hi + lo) / sigma``: four from ``hi``, the rest from the
    residual stream with ``lo`` folded in."""
    t = hi / sigma
    n_hi = min(n_slices, 4)
    slices, t = _extract_slices(t, n_hi, q)
    if n_slices > n_hi:
        if lo is not None:
            # The residual stream is pre-scaled by 2^{q n_hi}; bring lo to
            # the same scale before folding it in (|lo| <= ulp(hi)/2, so the
            # sum stays within [-1.5, 1.5]).
            t = t + (lo.to(torch.float32) / sigma) * float(2.0 ** (q * n_hi))
        more, _ = _extract_slices(t, n_slices - n_hi, q)
        slices += more
    return torch.stack(slices)


def split_pair_int8(hi, lo=None, n_slices: int = DEFAULT_SLICES, q: int = Q_BITS):
    """Slice a pair-float matrix ``(m, k)`` along its last (contraction)
    axis into ``n_slices`` row-scaled int8 mantissa planes.

    Returns ``(slices, sigma)``: ``slices`` is ``(n_slices, m, k)`` int8,
    ``sigma`` is ``(m, 1)`` f32 powers of two, and

        hi + lo  ~=  sigma * sum_s slices[s] * 2^{-q (s+1)}

    with truncation error below ``sigma * 2^{-q * n_slices}`` per entry. The
    first four slices (q=6) reproduce an f32 ``hi`` exactly.
    """
    hi = hi.to(torch.float32)
    sigma = _row_scale(hi)
    return _split(hi, lo, sigma, n_slices, q), sigma


def split_global_int8(x64, n_slices: int = 8, q: int = Q_BITS):
    """Globally-scaled int8 slice decomposition of an f64 matrix.

    One power-of-two scale for the whole array (instead of per-row) makes
    the slices valid for contraction along EITHER axis: one stored
    decomposition serves both ``A v`` and ``A^T v``. Truncation is
    ``2^{-q n_slices}`` of the global max. Returns ``(slices (S, m, k) int8,
    sigma scalar f32)``.
    """
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    _, e = torch.frexp(torch.clamp_min(torch.amax(torch.abs(hi)), torch.finfo(torch.float32).tiny))
    sigma = _pow2(e)
    return _split(hi, lo, sigma, n_slices, q), sigma


def _level_sums(P, lead: int, keep: int):
    """Exact int32 level sums of batched pair products.

    ``P (*L, n_a, n_b, *rest)`` holds slice pair ``(i, j)`` at ``[..., i, j,
    ...]`` (``lead = len(L)``). Returns ``(*L, keep, *rest)``: level ``lv``
    sums the pairs with ``i + j = lv``; pairs at ``lv >= keep`` are dropped.
    """
    n_a, n_b = P.shape[lead], P.shape[lead + 1]
    out = P.new_zeros(P.shape[:lead] + (keep,) + P.shape[lead + 2:])
    for i in range(min(n_a, keep)):
        nj = min(n_b, keep - i)
        out.narrow(lead, i, nj).add_(P.select(lead, i).narrow(lead, 0, nj))
    return out


def _recombine(levels, axis: int, q: int):
    """f64 sum of int32 level sums along ``axis``, each at its weight
    ``2^{-q (lv + 2)}``, the highest level first (the JAX package's order,
    so the bits agree)."""
    acc = torch.zeros(levels.select(axis, 0).shape, dtype=torch.float64, device=levels.device)
    for lv in reversed(range(levels.shape[axis])):
        acc = acc + levels.select(axis, lv).to(torch.float64) * (2.0 ** (-q * (lv + 2)))
    return acc


def _pad_last(x, mult=16):
    """Zero-pad the last axis to a multiple of ``mult`` (a no-op when it is)."""
    k = x.shape[-1]
    return x if k % mult == 0 else torch.nn.functional.pad(x, (0, _ceil(k, mult) - k))


def _gemm_from_slices(sa, siga, sb, sigb, *, q, out_dtype, precision_levels):
    """``sum_{i + j < levels} (sa_i sb_j^T) 2^{-q (i + j + 2)}``, scaled by
    ``siga sigb^T``. Per row block of ``sa`` and per slice ``i``, one product
    takes every ``sb_j`` it needs as columns."""
    S, m, k = sa.shape
    n = sb.shape[1]
    sa = _pad_last(sa).contiguous()
    sb = _pad_last(_pad_last(sb.transpose(1, 2)).transpose(1, 2)).contiguous()  # (S, np, kp)
    n_pad, kp = sb.shape[1], sb.shape[2]
    P = precision_levels
    out = torch.empty((m, n), dtype=out_dtype, device=sa.device)
    rb = max(1, min(m, _GEMM_BLOCK_BYTES // (n_pad * (4 * S + 4 * P + 24))))
    for r0 in range(0, m, rb):
        r1 = min(m, r0 + rb)
        levels = torch.zeros((P, r1 - r0, n_pad), dtype=torch.int32, device=sa.device)
        for i in range(min(S, P)):
            nj = min(S, P - i)
            p = _int8_mm(sa[i, r0:r1], sb[:nj].reshape(nj * n_pad, kp).T)
            levels[i:i + nj].add_(p.reshape(r1 - r0, nj, n_pad).transpose(0, 1))
        acc = _recombine(levels[:, :, :n], 0, q)
        del levels
        out[r0:r1] = acc * siga[r0:r1].to(torch.float64) * sigb.to(torch.float64).T
    return out


def matvec_sliced(sa, sigma, v, *, q: int = Q_BITS, transpose: bool = False):
    """``A @ v`` (or ``A^T @ v``) from a global-scale slice stack.

    v: f64 ``(k,)`` or ``(k, m)``; sliced on the fly (8 slices, global
    scale). All slice products accumulate exactly in int32; level sums
    recombine in f64.
    """
    n_a, rows, cols = sa.shape
    was_vec = v.dim() == 1
    if was_vec:
        v = v[:, None]
    sv, sigv = split_global_int8(v, n_slices=8, q=q)  # (8, len, c)
    n_v, _, c = sv.shape
    keep = max(n_a, n_v)
    if transpose:
        # (v^T A)^T: the vector slices as rows, one product per stack slice.
        a = sv.transpose(1, 2).reshape(n_v * c, rows)
        P = torch.stack([_int8_mm(a, sa[i]).view(n_v, c, cols) for i in range(n_a)])
        acc = _recombine(_level_sums(P, 0, keep), 0, q).T  # (cols, c)
    else:
        b = sv.permute(1, 0, 2).reshape(cols, n_v * c)
        P = _int8_mm(sa.reshape(n_a * rows, cols), b).view(n_a, rows, n_v, c).transpose(1, 2)
        acc = _recombine(_level_sums(P, 0, keep), 0, q)  # (rows, c)
    out = acc * sigma.to(torch.float64) * sigv.to(torch.float64)
    return out[:, 0] if was_vec else out


def _chunks(sa, chunk, q):
    S, m, n = sa.shape
    if n % chunk != 0:
        raise ValueError('slice stack columns must be a chunk multiple')
    if chunk > max_contraction_dim(8, q):
        raise ValueError('chunk overflows exact int32 accumulation')
    return n // chunk


def matvec_sliced_long(sa, sigma, v, *, q: int = Q_BITS, chunk: int = 16384):
    """``A @ v`` from a global- or per-chunk-scale slice stack whose
    contraction axis exceeds the exact-int32 bound (~29k at 8 slices): the
    contraction is split into ``chunk``-wide pieces, each piece's int32
    level sums are exact, and the pieces accumulate in f64 in order.

    ``sa``: ``(S, m, n)`` int8 with ``n`` a multiple of ``chunk`` (zero
    columns contribute nothing). ``sigma``: scalar, or ``(n_chunks,)`` when
    each column chunk was sliced with its own scale. ``v``: f64 ``(n,)``.
    One product a chunk takes every stack slice as rows and the vector's 8
    slices as columns; it reads the stack's chunk in place when ``sa`` is
    contiguous with ``m``, ``n`` and ``chunk`` multiples of 16.
    """
    S, m, n = sa.shape
    n_ch = _chunks(sa, chunk, q)
    sv, sigv = split_global_int8(v[:, None], n_slices=8, q=q)  # (8, n, 1)
    # The 8 slices and 8 zero rows: chunk c's columns are a column-major
    # (chunk, 16), which the H100's product takes 1.6x faster than 8 columns
    # (``chip_smoke.py --stack-apply``, PERF.md §6).
    svt = sv.new_zeros((16, n))
    svt[:8] = sv[:, :, 0]
    keep = max(S, 8)
    a = sa.reshape(S * m, n)
    P = torch.stack([_int8_mm(a[:, c * chunk:(c + 1) * chunk], svt[:, c * chunk:(c + 1) * chunk].T)[:, :8]
                     for c in range(n_ch)])  # (n_ch, S m, 8)
    P = P.view(n_ch, S, m, 8).transpose(2, 3)
    parts = _recombine(_level_sums(P, 1, keep), 1, q)  # (n_ch, m)
    per_chunk = sigma.dim() > 0
    if per_chunk:
        parts = parts * sigma.to(torch.float64)[:, None]
    acc = torch.zeros(m, dtype=torch.float64, device=sa.device)
    for c in range(n_ch):
        acc = acc + parts[c]
    if not per_chunk:
        acc = acc * sigma.to(torch.float64)
    return acc * sigv.to(torch.float64)


def matvec_sliced_long_t(sa, sigma, w, *, q: int = Q_BITS, chunk: int = 16384):
    """``A^T @ w`` for the same stack layout as :func:`matvec_sliced_long`.

    The contraction runs over the short ``m`` axis (exact without
    chunking), so one product a stack slice takes its whole width:
    ``A_i^T (n, m)``, the slice read in place as a column-major operand,
    against the vector's 8 slices as columns. Per-chunk scales apply to the
    OUTPUT column blocks. ``w``: f64 ``(m,)``. Returns f64 ``(n,)``.
    """
    S, m, n = sa.shape
    if m > max_contraction_dim(8, q):
        raise ValueError('row dim overflows exact int32 accumulation')
    n_ch = _chunks(sa, chunk, q)
    sv, sigv = split_global_int8(w[:, None], n_slices=8, q=q)  # (8, m, 1)
    svt = sv[:, :, 0]  # (8, m): its transpose is a column-major (m, 8)
    P = torch.stack([_int8_mm(sa[i].T, svt.T) for i in range(S)]).transpose(1, 2)  # (S, 8, n)
    out = _recombine(_level_sums(P, 0, max(S, 8)), 0, q).view(n_ch, chunk)
    per_chunk = sigma.dim() > 0
    if per_chunk:
        out = out * sigma.to(torch.float64)[:, None]
    out = out.reshape(n) * sigv.to(torch.float64)
    if not per_chunk:
        out = out * sigma.to(torch.float64)
    return out


def ozaki_gemm_nt(a, b, *, n_slices: int = DEFAULT_SLICES, q: int = Q_BITS,
                  out_dtype=torch.float64, lo_a=None, lo_b=None):
    """``(a + lo_a) @ (b + lo_b).T`` via exact int8 slice products.

    a, b: ``(m, k)`` / ``(n, k)`` f32 (or f64, rounded to pair form by the
    caller). Keeps product levels ``i + j < n_slices``: truncation error
    ~``2^{-q(n_slices+1)} * sigma_a * sigma_b`` per entry. The int8 products
    accumulate exactly in int32 (requires ``k <= max_contraction_dim()``,
    ~= 33k at the defaults).
    """
    k = a.shape[1]
    if k > max_contraction_dim(n_slices, q):
        raise ValueError('contraction dim %d overflows exact int32 accumulation' % k)
    sa, siga = split_pair_int8(a, lo_a, n_slices, q)
    sb, sigb = split_pair_int8(b, lo_b, n_slices, q)
    return _gemm_from_slices(sa, siga, sb, sigb, q=q, out_dtype=out_dtype, precision_levels=n_slices)


def ozaki_gemm_nt_f64(a, b, n_slices: int = DEFAULT_SLICES):
    """``a @ b.T`` of float64 operands, each split into an (f32, f32) pair
    (``hi = f32(x)``, ``lo = f32(x - hi)``) for :func:`ozaki_gemm_nt`: the
    Ozaki products of ``predict_from_tables`` and the Hessian tile."""
    a_hi, b_hi = a.to(torch.float32), b.to(torch.float32)
    return ozaki_gemm_nt(a_hi, b_hi, n_slices=n_slices, lo_a=(a - a_hi.to(torch.float64)).to(torch.float32),
                         lo_b=(b - b_hi.to(torch.float64)).to(torch.float32))
