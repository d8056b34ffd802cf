"""Block-cyclic (ScaLAPACK-style) distributed Cholesky with shrinking updates.

Counterpart of ``sgdml_tpu/ops/cyclic.py``. The JAX package introduced the
module to leave the masked full-width updates of its mesh factorizations
(about 3x the least flops); the port's row-strip Cholesky (``ops/linalg.py``)
already updates only the lower trapezoid, about ``n^3 / 3`` flops. What the
cyclic layout adds here is **balance**: with contiguous strips the shrinking
trailing matrix sits on the highest ranks and the others wait; with logical
block row ``l`` on rank ``l % ranks`` every rank's share of it stays within
one block of even at every step.

* The contiguous row strips (rank ``g`` holding rows ``[g rloc, (g + 1)
  rloc)``, as ``parallel/spmd.py`` assembles them) are redistributed into
  cyclic block rows by one ``all_to_all_single`` of rows, not by gathering
  the matrix; identity rows pad ``n`` to a multiple of ``nb * ranks`` (as
  ``cho_solve_cyclic`` pads in the JAX package). Rank ``d`` stores its
  block rows ``d, d + ranks, ...`` in that order, all ``n_pad`` columns in
  logical order (:func:`cyclic_row_perm`).
* A step ``k``: the diagonal block, one all-reduce (its owner contributes
  it), factored in f64 on every rank; each rank's panel solve of its own
  trailing block rows; one all-gather of the panels; each rank's update of
  the lower part of its own trailing block rows (block row ``l`` up to
  column block ``l``).
* The factor goes back to contiguous strips by a second all-to-all, and the
  triangular solves are ``linalg.blocked_tri_solve``'s.

At one rank the layout is the identity: no row moves, and the strip (when
``n`` needs no padding) is factored in place. With more ranks the
redistribution holds a send buffer and the received rows beside the strip.
Without a mesh every function works on one tensor and leaves it as it is.

Reference counterpart: none; the reference solves on one host with scipy
``cho_factor`` (sgdml/solvers/analytic.py:94-99).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import all_gather_rows, all_reduce_, mesh_info
from ..utils.profiling import PhaseTimer
from . import linalg

__all__ = ['cyclic_row_perm', 'blocked_cholesky_cyclic', 'cho_solve_cyclic']


def cyclic_row_perm(n_blocks: int, nb: int, n_dev: int) -> np.ndarray:
    """Row permutation: storage row -> logical row.

    Storage enumerates (device, slot): device ``d`` holds logical block rows
    ``{d, d + n_dev, d + 2 n_dev, ...}`` in its contiguous shard.
    """
    assert n_blocks % n_dev == 0
    bpd = n_blocks // n_dev
    perm = np.empty(n_blocks * nb, dtype=np.int64)
    q = 0
    for d in range(n_dev):
        for s in range(bpd):
            l = s * n_dev + d
            perm[q * nb:(q + 1) * nb] = np.arange(l * nb, (l + 1) * nb)
            q += 1
    return perm


def _u_start(k: int, n_dev: int) -> int:
    """First local slot any device must process at step ``k`` (the minimum
    over devices of the first slot owning a trailing block)."""
    return max(0, -(-(k + 2 - n_dev) // n_dev))


def _rank_size(info):
    return (0, 1) if info is None else (info.rank, info.size)


def _my_rows(n_pad, nb, d, D):
    """The logical rows of rank ``d``'s cyclic storage, in storage order."""
    perm = cyclic_row_perm(n_pad // nb, nb, D)
    rows = n_pad // D
    return perm[d * rows:(d + 1) * rows]


def _exchange(send, in_counts, out, out_counts, info):
    dist.all_to_all_single(out, send, output_split_sizes=[int(c) for c in out_counts],
                           input_split_sizes=[int(c) for c in in_counts], group=info.group)


def _to_cyclic(A, n_pad, nb, info):
    """This rank's cyclic block rows ``(n_pad / ranks, n_pad)`` of the
    identity-padded matrix, from the contiguous strips ``A`` of every rank
    (``(n / ranks, n)`` each). At one rank without padding this is ``A``."""
    d, D = _rank_size(info)
    rloc, n = A.shape
    if D == 1 and n_pad == n:
        return A
    rows = _my_rows(n_pad, nb, d, D)
    out = A.new_zeros((rows.size, n_pad))
    n_real = int(np.sum(rows < n))
    if D == 1:
        out[:n, :n] = A
    else:
        # Rows go out grouped by destination, each group ascending; every
        # source holds a contiguous ascending range, so the rows that arrive
        # (grouped by source) are ascending: the storage order of the real
        # rows, which precede the identity rows.
        g = np.arange(d * rloc, (d + 1) * rloc)
        dest = (g // nb) % D
        order = np.argsort(dest, kind='stable')
        send = A.new_zeros((rloc, n_pad))
        send[:, :n] = A[torch.as_tensor(order, device=A.device)]
        src = np.arange(n) // rloc
        mine = ((np.arange(n) // nb) % D) == d
        _exchange(send, np.bincount(dest, minlength=D), out[:n_real],
                  np.bincount(src[mine], minlength=D), info)
        del send
    pad = np.nonzero(rows >= n)[0]
    if pad.size:
        out[torch.as_tensor(pad, device=A.device), torch.as_tensor(rows[pad], device=A.device)] = 1.0
    return out


def _from_cyclic(L, n_pad, nb, info):
    """The contiguous strips ``(n_pad / ranks, n_pad)`` of the factor held in
    cyclic block rows ``L``."""
    d, D = _rank_size(info)
    if D == 1:
        return L
    rp = n_pad // D
    rows = _my_rows(n_pad, nb, d, D)
    dest = rows // rp  # ascending with the rows: already grouped
    g = np.arange(d * rp, (d + 1) * rp)
    src = (g // nb) % D
    recv = torch.empty((rp, n_pad), dtype=L.dtype, device=L.device)
    _exchange(L, np.bincount(dest, minlength=D), recv, np.bincount(src, minlength=D), info)
    out = torch.empty_like(recv)
    out[torch.as_tensor(np.argsort(src, kind='stable'), device=L.device)] = recv
    return out


def _factor_cyclic_(A, nb, info):
    """Factor the cyclic block rows ``A`` in place (see the module
    docstring); the rows then hold ``L`` with zeros above the diagonal.
    Raises ``RuntimeError`` where a diagonal block is not positive
    definite (the same block on every rank)."""
    d, D = _rank_size(info)
    n_pad = A.shape[1]
    n_blocks = n_pad // nb
    bpd = n_blocks // D
    for k in range(n_blocks):
        d_k, s_k, c0 = k % D, k // D, k * nb
        u = _u_start(k, D)
        # Diagonal block: its owner contributes it, one all-reduce shares it.
        if d == d_k:
            Akk = A[s_k * nb:(s_k + 1) * nb, c0:c0 + nb].clone()
        else:
            Akk = A.new_zeros((nb, nb))
        if D > 1:
            all_reduce_(Akk, info)
        Lkk, bad = torch.linalg.cholesky_ex(Akk)
        if int(bad):
            raise RuntimeError('cyclic Cholesky: the matrix is not positive definite (leading minor of order %d)'
                               % (c0 + int(bad)))
        # Panel: this rank's block rows below the diagonal, from slot s0.
        s0 = max(u, -(-(k + 1 - d) // D))
        P_loc = A.new_zeros(((bpd - u) * nb, nb))
        if s0 < bpd:
            P = A[s0 * nb:, c0:c0 + nb]
            P.copy_(torch.linalg.solve_triangular(Lkk.T, P, upper=True, left=False))
            P_loc[(s0 - u) * nb:] = P
        if d == d_k:
            A[s_k * nb:(s_k + 1) * nb, c0:c0 + nb] = Lkk
            A[s_k * nb:(s_k + 1) * nb, c0 + nb:] = 0.0  # right of the diagonal
        if k + 1 == n_blocks:
            break
        # One all-gather; the trailing blocks' panel rows in logical order.
        if D == 1:
            S_t = P_loc
        else:
            P_all = all_gather_rows(P_loc, info).view(D, (bpd - u) * nb, nb)
            S_t = torch.cat([P_all[l % D, (l // D - u) * nb:(l // D - u + 1) * nb] for l in range(k + 1, n_blocks)])
        for s in range(s0, bpd):
            l = s * D + d
            A[s * nb:(s + 1) * nb, c0 + nb:(l + 1) * nb].addmm_(
                P_loc[(s - u) * nb:(s - u + 1) * nb], S_t[:(l - k) * nb].T, alpha=-1.0)
    return A


def _factor_padded(A, nb, mesh):
    """``(L, n_pad)``: the factor of ``A`` padded with identity rows to a
    multiple of ``nb * ranks``, as contiguous strips (the whole factor
    without a mesh)."""
    info = None if mesh is None else mesh_info(mesh)
    D = _rank_size(info)[1]
    if mesh is None:
        if A.shape[0] != A.shape[1]:
            raise ValueError('expected a square matrix, got %s' % (tuple(A.shape),))
        A = A.clone()
    elif A.shape[0] * D != A.shape[1]:
        raise ValueError('a row strip of %d rows over %d ranks cannot hold %d columns' % (A.shape[0], D, A.shape[1]))
    n = A.shape[1]
    n_pad = -(-n // (nb * D)) * nb * D
    return _from_cyclic(_factor_cyclic_(_to_cyclic(A, n_pad, nb, info), nb, info), n_pad, nb, info), n_pad


def blocked_cholesky_cyclic(A, nb: int, mesh=None):
    """Lower Cholesky factor of SPD ``A (n, n)`` by the block-cyclic
    factorization; ``n`` must be a multiple of ``nb * ranks`` (use
    :func:`cho_solve_cyclic` for automatic identity padding). With a mesh,
    ``A`` is this rank's contiguous row strip ``(n / ranks, n)`` and the
    result is its strip of ``L`` in logical row order (at one rank ``A``
    itself, factored in place); without one, the whole factor (``A`` left
    as it is)."""
    D = 1 if mesh is None else mesh_info(mesh).size
    n = A.shape[1]
    if n % (nb * D):
        raise ValueError('n=%d must tile into nb=%d blocks divisible over %d devices' % (n, nb, D))
    return _factor_padded(A, nb, mesh)[0]


def cho_solve_cyclic(A, b, nb: int, mesh=None, timer=None):
    """Solve SPD ``A x = b`` by the block-cyclic factorization, padded with
    an identity extension to a multiple of ``nb * ranks``; the triangular
    solves are ``linalg.blocked_tri_solve``'s. ``A`` as in
    :func:`blocked_cholesky_cyclic` (consumed with a mesh); ``b`` whole on
    every rank, and so is ``x``. ``timer``: a ``PhaseTimer`` charged
    ``'factor'`` and ``'solve'``."""
    timer = timer or PhaseTimer(A.device)
    with timer.phase('factor'):
        L, n_pad = _factor_padded(A, nb, mesh)
    with timer.phase('solve'):
        n = b.shape[0]
        bp = torch.nn.functional.pad(b, (0, 0) * (b.ndim - 1) + (0, n_pad - n))
        y = linalg.blocked_tri_solve(L, bp, nb, mesh=mesh)
        x = linalg.blocked_tri_solve(L, y, nb, trans=True, mesh=mesh)
    return x[:n]
