"""Blocked dense Cholesky and triangular solves, on one tensor or over a mesh.

Right-looking blocked Cholesky (``sgdml_tpu/ops/linalg.py``): per block
column of ``nb``, factor the diagonal block, solve the panel below it
against that factor, and subtract the panel's rank-``nb`` product from the
trailing matrix. Over a mesh the matrix is held as row strips, rank ``g``
owning rows ``[g rloc, (g + 1) rloc)`` of all ``n`` columns, and a block
column costs

* one all-reduce of the diagonal block (each row from the rank that owns
  it; a block may straddle two ranks), which every rank then factors
  redundantly, so every rank holds the same bits;
* each rank's triangular solve of its own panel rows;
* one all-gather of the panel;
* each rank's in-place ``addmm_`` on its own strip.

The JAX program updates the masked full width at every step (about 3x the
least flops) because XLA needs static shapes. Here each strip updates only
the lower trapezoid, row block by row block (columns up to the block's last
row): about ``n^3 / 3`` flops in all, the same result to rounding. The upper
triangle is zeroed once at the end. Blocks need not divide ``n``: the last
one is smaller.

The triangular solves substitute block by block on a replicated right-hand
side, with one all-reduce a block (the diagonal block and the strips'
partial products); the factor may be one f64 tensor or an (f32, bf16)
pair (``ops/meshchol.py``), each block of a pair joined to f64 as it is
read. Without a mesh every function works on one tensor, and
:func:`cho_solve_blocked` pads to a multiple of ``nb`` with an identity
extension, as the JAX package does; :func:`cholesky_` factors one tensor in
place (the single-card analytic solve's in-place route).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_gather_rows, all_reduce_, mesh_info
from .pairchol import pair_to_f64

__all__ = ['NotPositiveDefiniteError', 'blocked_cholesky', 'blocked_tri_solve', 'cho_solve_blocked', 'cholesky_']


class NotPositiveDefiniteError(RuntimeError):
    """A leading diagonal block of the blocked Cholesky is not positive
    definite: what a caller may catch without catching every
    ``RuntimeError`` (an out-of-memory error among them)."""


def _strip(A, mesh):
    """``(info, r0)``: the mesh's info and the strip's first global row
    (``(None, 0)`` without a mesh, where ``A`` is the whole matrix)."""
    if mesh is None:
        if A.shape[0] != A.shape[1]:
            raise ValueError('expected a square matrix, got %s' % (tuple(A.shape),))
        return None, 0
    info = mesh_info(mesh)
    rloc, n = A.shape
    if rloc * info.size != n:
        raise ValueError('a row strip of %d rows over %d ranks cannot hold %d columns' % (rloc, info.size, n))
    if A.device != info.device:
        raise ValueError('the strip lies on %s, the mesh on %s' % (A.device, info.device))
    return info, info.rank * rloc


def _rows_of(A, r0, k0, k1, width, extra=0, dtype=None):
    """A ``(k1 - k0, width + extra)`` zero buffer (of ``A``'s dtype unless
    given) for this strip's rows of ``[k0, k1)``, and the global range of
    the rows the strip holds."""
    lo, hi = max(k0, r0), min(k1, r0 + A.shape[0])
    buf = A.new_zeros((k1 - k0, width + extra), dtype=dtype)
    return buf, lo, hi


def _block(L, rows, cols):
    """``L[rows, cols]`` of a factor held as one tensor or as a ``(hi, lo)``
    pair, joined to f64."""
    if isinstance(L, tuple):
        return pair_to_f64(L[0][rows, cols], L[1][rows, cols])
    return L[rows, cols]


def _factor_(A, nb: int, mesh=None):
    """Factor SPD ``A = L L^T`` in place, block column by block column;
    returns ``A``, which then holds ``L`` (zeros above the diagonal).

    With a ``mesh``, ``A`` is this rank's row strip ``(rloc, n)`` (``n =
    rloc * ranks``) and every rank of the mesh calls it. Raises
    ``RuntimeError`` where a diagonal block is not positive definite (the
    same block on every rank): :class:`NotPositiveDefiniteError`.
    """
    info, r0 = _strip(A, mesh)
    rloc, n = A.shape
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        Akk, lo, hi = _rows_of(A, r0, k0, k1, k1 - k0)
        if lo < hi:
            Akk[lo - k0:hi - k0] = A[lo - r0:hi - r0, k0:k1]
        if info is not None:
            all_reduce_(Akk, info)
        Lkk, bad = torch.linalg.cholesky_ex(Akk)
        if int(bad):
            raise NotPositiveDefiniteError(
                'blocked Cholesky: the matrix is not positive definite (leading minor of order %d)' % (k0 + int(bad)))
        if lo < hi:
            A[lo - r0:hi - r0, k0:k1] = Lkk[lo - k0:hi - k0]
        p0 = max(k1, r0) - r0  # this strip's first row below the block
        if p0 < rloc:
            P = A[p0:, k0:k1]
            P.copy_(torch.linalg.solve_triangular(Lkk.T, P, upper=True, left=False))
        if k1 == n:
            break
        if info is None:
            panel = A[k1:, k0:k1]
        else:
            mine = A.new_zeros((rloc, k1 - k0))
            if p0 < rloc:
                mine[p0:] = A[p0:, k0:k1]
            panel = all_gather_rows(mine, info)[k1:]
        # Lower trapezoid of this strip's trailing rows, a row block at a time.
        for i0 in range(max(k1, r0), r0 + rloc, nb):
            i1 = min(r0 + rloc, i0 + nb)
            A[i0 - r0:i1 - r0, k1:i1].addmm_(panel[i0 - k1:i1 - k1], panel[:i1 - k1].T, alpha=-1.0)
    return A.tril_(r0)


def blocked_cholesky(A, nb: int, mesh=None):
    """Lower Cholesky factor of SPD ``A``, block column by block column
    (``sgdml_tpu.ops.linalg.blocked_cholesky``). Without a mesh ``A`` is
    left as it is. With one, ``A`` is this rank's row strip ``(rloc, n)``
    (``n = rloc * ranks``), every rank of the mesh calls it, and the strip
    is factored in place (no copy of it is made). Raises ``RuntimeError``
    where a diagonal block is not positive definite (the same block on
    every rank)."""
    return _factor_(A if mesh is not None else A.clone(), nb, mesh)


def cholesky_(A, nb: int):
    """Factor the square SPD ``A = L L^T`` in place, block column by block
    column; returns ``A``, which then holds ``L`` (zeros above the
    diagonal). Besides ``A`` it holds the panel solve's fresh ``(n - nb,
    nb)`` output and the ``(nb, nb)`` diagonal block and its factor at once.
    Raises :class:`NotPositiveDefiniteError` at the first diagonal block that
    is not positive definite, with ``A`` consumed up to that block."""
    return _factor_(A, nb)


def blocked_tri_solve(L, b, nb: int, trans: bool = False, mesh=None):
    """Solve ``L y = b`` (``L^T y = b`` with ``trans``) by block substitution;
    ``L`` lower triangular, one tensor or an ``(hi, lo)`` pair (then ``b``
    is f64), ``b`` ``(n,)`` or ``(n, K)``. With a ``mesh``, ``L`` is this
    rank's row strip, ``b`` is whole on every rank, and so is the result."""
    Ls = L[0] if isinstance(L, tuple) else L
    info, r0 = _strip(Ls, mesh)
    rloc, n = Ls.shape
    vec = b.ndim == 1
    b = b[:, None] if vec else b
    kk = b.shape[1]
    y = torch.zeros_like(b)
    starts = list(range(0, n, nb))
    for k0 in reversed(starts) if trans else starts:
        k1 = min(n, k0 + nb)
        bk = k1 - k0
        # [Lkk | partial sums of the known part], each strip's rows summed.
        buf, lo, hi = _rows_of(Ls, r0, k0, k1, bk, kk, dtype=b.dtype)
        if lo < hi:
            buf[lo - k0:hi - k0, :bk] = _block(L, slice(lo - r0, hi - r0), slice(k0, k1))
        if not trans:
            if lo < hi and k0 > 0:
                buf[lo - k0:hi - k0, bk:] = _block(L, slice(lo - r0, hi - r0), slice(0, k0)) @ y[:k0]
        else:
            a = max(k1, r0)
            if a < r0 + rloc:
                buf[:, bk:] += _block(L, slice(a - r0, rloc), slice(k0, k1)).T @ y[a:r0 + rloc]
        if info is not None:
            all_reduce_(buf, info)
        Lkk, s = buf[:, :bk], buf[:, bk:]
        if trans:
            y[k0:k1] = torch.linalg.solve_triangular(Lkk.T, b[k0:k1] - s, upper=True)
        else:
            y[k0:k1] = torch.linalg.solve_triangular(Lkk, b[k0:k1] - s, upper=False)
    return y[:, 0] if vec else y


def cho_solve_blocked(A, b, nb: int = 1024, mesh=None):
    """Solve SPD ``A x = b`` through the blocked Cholesky factor.

    Without a mesh ``A`` is padded to a multiple of ``nb`` with an identity
    extension and left as it is. With a ``mesh``, ``A`` is this rank's row
    strip and is overwritten by its factor (no copy of it is made); ``b`` is
    whole on every rank, and so is ``x``.
    """
    n = A.shape[1]
    nb = min(nb, n)
    if mesh is None:
        n_pad = -(-n // nb) * nb
        if n_pad != n:
            A = torch.nn.functional.pad(A, (0, n_pad - n, 0, n_pad - n))
            A.diagonal()[n:] = 1.0
            b = torch.nn.functional.pad(b, (0, 0) * (b.ndim - 1) + (0, n_pad - n))
        L = _factor_(A if n_pad != n else A.clone(), nb)
    else:
        L = _factor_(A, nb, mesh)
    y = blocked_tri_solve(L, b, nb, mesh=mesh)
    return blocked_tri_solve(L, y, nb, trans=True, mesh=mesh)[:n]
