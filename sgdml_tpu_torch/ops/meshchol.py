"""Pair-precision (f32 + bf16) blocked Cholesky, on one tensor or over a mesh.

Counterpart of ``sgdml_tpu/ops/meshchol.py``: the matrix is held flat as a
pair ``hi (f32) + lo (bf16)``, 6 bytes an element, and factored by a
right-looking blocked Cholesky whose errors sit at the pair-storage floor
(~2^-33 relative), so the analytic solver's lam' ladder can start about 100x
below the f32 floor. Over a mesh each rank holds a row strip ``(rloc, n)`` of
both, as ``ops/linalg.py`` holds its f64 strip, and a block column costs

* the diagonal block joined to f64, one all-reduce (each row from the rank
  that owns it), factored in f64 on every rank (:func:`_diag_factor`);
* each rank's panel rows by an f32 triangular solve refined ``N_REFINE``
  times by Ozaki residuals (:func:`_panel`, ``pairchol._panel_solve_pair``);
* one all-gather of the f64 panel, sliced once into 7 row-scaled int8
  slices (the scale is per row, so these are the slices each rank would
  make of its own rows);
* each rank's trailing update of its own rows as exact Ozaki products,
  written back in pair form (:func:`_trailing_update`).

Where the two differ:

* The JAX program updates the masked full width every step: it forms an
  ``(n, n)`` f64 product and re-splits the whole matrix (about 3x the
  flops, and at n = 63,000 31.75 GB of transient). Here each strip updates
  only its lower trapezoid, a row block at a time, and splits only what it
  wrote. One int8 product makes each of the 7 level sums: level ``l`` is
  ``[A_0 | .. | A_l] [B_l | .. | B_0]^T``, the panel's slices laid out once
  a block column side by side (and in reverse order for the right operand),
  so the contraction of ``(l + 1) nb`` terms stays exact in int32 for ``nb``
  up to ``ozaki.max_contraction_dim(7)``. The int32 sums are those of the
  JAX product; they are recombined in its order, so the update is its bits.
* The JAX factor's upper triangle holds stale values that the solves mask;
  here it is zeroed once at the end.
* A failed factorization shows as ``info > 0`` from the diagonal block's
  ``cholesky_ex`` (XLA fills the factor with NaNs): the functions return
  ``(Lhi, Llo, info)`` and stop in the failed block column, as
  ``pairchol.chol_grid_pair`` does. Over a mesh ``info`` is rank 0's.
* Blocks need not divide ``n``: the last one is smaller.

The triangular solves are ``linalg.blocked_tri_solve``'s block
substitution on a replicated right-hand side, one all-reduce a block, with
each block of the pair factor joined to f64 as it is read: no f64 copy of
the factor exists.

Reference counterpart: scipy ``cho_factor/cho_solve`` on a dense f64 host
matrix (sgdml/solvers/analytic.py:94-99); the reference has no distributed
equivalent.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import agree, all_gather_rows, all_reduce_
from . import linalg, ozaki
from .linalg import _rows_of, _strip
from .pairchol import _panel_solve_pair, _split7, _write_pair, pair_split, pair_to_f64

__all__ = ['blocked_cholesky_pair', 'tri_solve_pair', 'cho_solve_pair']

SLICES = ozaki.DEFAULT_SLICES  # the Ozaki products' slices and levels (7)

_F32, _F64 = torch.float32, torch.float64


def _diag_factor(hi, lo, r0, k0, k1, info):
    """``(L_kk, info)``: the diagonal block ``[k0, k1)^2`` joined to f64 from
    the rows this strip owns, summed over the mesh, and its f64 Cholesky
    factor (``cholesky_ex``), the same bits on every rank."""
    Akk, a, b = _rows_of(hi, r0, k0, k1, k1 - k0, dtype=_F64)
    if a < b:
        Akk[a - k0:b - k0] = pair_to_f64(hi[a - r0:b - r0, k0:k1], lo[a - r0:b - r0, k0:k1])
    if info is not None:
        all_reduce_(Akk, info)
    return torch.linalg.cholesky_ex(Akk)


def _panel(Lkk, hi_p, lo_p):
    """This strip's panel rows ``C L_kk^{-T}`` in f64 at pair accuracy: the
    f32 solve of ``hi`` and ``N_REFINE`` Ozaki-residual refinements against
    ``L_kk`` split as an (f32, f32) pair, as the JAX package's
    ``_ozaki_nt_64`` splits it."""
    return _panel_solve_pair(Lkk.to(_F32), _split7(*pair_split(Lkk, _F32)), hi_p, lo_p)


def _panel_operands(P64):
    """The 7 row-scaled slices of an f64 panel ``(R, b)`` (as
    ``ozaki.ozaki_gemm_nt`` makes them of its (f32, f32) split) laid out for
    the level products: ``fwd (R, 7 bp)`` holds slice ``i`` in columns ``[i
    bp, (i + 1) bp)``, ``rev`` the same in reverse slice order, ``bp`` the
    block side rounded up to 16 (zero columns); and the ``(R, 1)`` scales."""
    R, b = P64.shape
    s, sig = ozaki.split_pair_int8(*pair_split(P64, _F32), n_slices=SLICES)
    bp = -(-b // 16) * 16
    fwd = s.new_zeros((R, SLICES, bp))
    fwd[:, :, :b] = s.permute(1, 0, 2)
    return fwd.view(R, SLICES * bp), fwd.flip(1).reshape(R, SLICES * bp), sig, bp


def _level_product(fwd_rows, rev_cols, bp):
    """``sum_{i + j < 7} (A_i B_j^T) 2^{-q (i + j + 2)}`` in f64 (the
    scales not yet applied), one exact int8 product a level, recombined from
    the highest level down as ``ozaki._recombine`` does."""
    acc = None
    for lv in reversed(range(SLICES)):
        k = (lv + 1) * bp
        p = ozaki._int8_mm(fwd_rows[:, :k], rev_cols[:, (SLICES - 1 - lv) * bp:].T)
        w = 2.0 ** (-ozaki.Q_BITS * (lv + 2))
        if acc is None:
            acc = p.to(_F64).mul_(w)
        else:
            acc.add_(p, alpha=w)
    return acc


def _trailing_update(hi, lo, r0, k1, nb, fwd, rev, sig, bp):
    """``A <- A - P P^T`` on this strip's rows at or below ``k1``, lower
    trapezoid only, a row block of ``nb`` at a time, from
    :func:`_panel_operands` of the panel's rows from ``k1``."""
    rloc = hi.shape[0]
    sig64 = sig.to(_F64)
    for i0 in range(max(k1, r0), r0 + rloc, nb):
        i1 = min(r0 + rloc, i0 + nb)
        cols = i1 - k1
        upd = _level_product(fwd[i0 - k1:i1 - k1], rev[:cols], bp)
        upd.mul_(sig64[i0 - k1:i1 - k1]).mul_(sig64[:cols].T)
        h, l = hi[i0 - r0:i1 - r0, k1:i1], lo[i0 - r0:i1 - r0, k1:i1]
        _write_pair(h, l, pair_to_f64(h, l).sub_(upd))


def _factor_pair_(hi, lo, nb: int, mesh=None):
    """Factor in place; returns ``(hi, lo, info)`` (see
    :func:`blocked_cholesky_pair`)."""
    info, r0 = _strip(hi, mesh)
    rloc, n = hi.shape
    if nb > ozaki.max_contraction_dim(SLICES):
        raise ValueError('block %d overflows exact int32 accumulation' % nb)
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        Lkk, bad = _diag_factor(hi, lo, r0, k0, k1, info)
        bad = int(bad) if info is None else int(agree([int(bad)], info)[0])
        if bad:
            return hi, lo, k0 + bad
        a, b = max(k0, r0), min(k1, r0 + rloc)  # the strip's rows of the block
        if a < b:
            _write_pair(hi[a - r0:b - r0, k0:k1], lo[a - r0:b - r0, k0:k1], Lkk[a - k0:b - k0])
        p0 = max(k1, r0) - r0  # this strip's first row below the block
        x64 = None
        if p0 < rloc:
            x64 = _panel(Lkk, hi[p0:, k0:k1], lo[p0:, k0:k1])
            _write_pair(hi[p0:, k0:k1], lo[p0:, k0:k1], x64)
        if k1 == n:
            break
        if info is None:
            panel = x64
        else:
            mine = hi.new_zeros((rloc, k1 - k0), dtype=_F64)
            if x64 is not None:
                mine[p0:] = x64
            panel = all_gather_rows(mine, info)[k1:]
        del x64
        fwd, rev, sig, bp = _panel_operands(panel)
        del panel
        _trailing_update(hi, lo, r0, k1, nb, fwd, rev, sig, bp)
        del fwd, rev, sig
    hi.tril_(r0)
    lo.tril_(r0)
    return hi, lo, 0


def blocked_cholesky_pair(Ahi, Alo, nb: int, mesh=None):
    """Pair-precision blocked Cholesky of SPD ``A = Ahi + Alo`` (f32, bf16).

    Returns ``(Lhi, Llo, info)``: the lower factor in the same pair form
    (zeros above the diagonal) and ``info``, 0 on success, else the order of
    the first leading minor that is not positive definite in f64 (the
    factorization stops in that block column). Without a mesh the inputs are
    left as they are. With one, ``Ahi``/``Alo`` are this rank's row strips
    ``(rloc, n)`` (``n = rloc * ranks``), every rank calls it, the strips are
    factored in place and ``info`` is rank 0's.
    """
    if mesh is None:
        Ahi, Alo = Ahi.clone(), Alo.clone()
    return _factor_pair_(Ahi, Alo, nb, mesh)


def tri_solve_pair(Lhi, Llo, b, nb: int, trans: bool = False, mesh=None):
    """``L y = b`` (``L^T y = b`` with ``trans``) at pair accuracy, ``b``
    ``(n,)`` or ``(n, K)``, in f64 (``linalg.blocked_tri_solve`` of the pair).
    With a ``mesh``, ``Lhi``/``Llo`` are this rank's row strips, ``b`` is
    whole on every rank, and so is ``y``."""
    return linalg.blocked_tri_solve((Lhi, Llo), b.to(_F64), nb, trans=trans, mesh=mesh)


def cho_solve_pair(Lhi, Llo, b, nb: int, mesh=None):
    """Solve ``(L L^T) x = b`` from the pair factor (strips with a mesh)."""
    return tri_solve_pair(Lhi, Llo, tri_solve_pair(Lhi, Llo, b, nb, mesh=mesh), nb, trans=True, mesh=mesh)
