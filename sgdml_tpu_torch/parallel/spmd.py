"""Sharded kernel assembly, solves, Nystrom factor and serving over a mesh.

Counterpart of ``sgdml_tpu/parallel/spmd.py`` with one process per device
(``parallel/mesh.py``). Every rank calls each function with the same
inputs and gets the whole result back; in between it holds only its share:

* **Assembly** (:func:`assemble_kernel_sharded`): kernel *rows* are sharded.
  Rank ``g`` computes the rows of its strip of training points -- their
  force rows and, with energy constraints, their energy rows -- against all
  column points, with the single-device tiles of ``ops/kernel.py``. No
  communication.
* **Row layout**: device-major *interleaved*, rank ``g`` owning rows ``[g
  rloc, (g + 1) rloc) = [3N force rows per local point | local energy
  rows]``, so that every row family stays on its rank. A symmetric
  permutation of an SPD system is SPD, so the blocked Cholesky runs on the
  interleaved matrix directly. :class:`ShardedLayout` maps vectors between
  the standard order (forces point-major, then energies) and this one.
* **Solve** (:func:`solve_interleaved`): the strip is negated, masked and
  shifted in place (the masked copy the JAX program makes is never made),
  then factored in f64 by the distributed blocked Cholesky of
  ``ops/linalg.py`` (``layout='masked'``) or of ``ops/cyclic.py``
  (``'cyclic'``, block rows redistributed for balance); or, with
  ``precision='pair'``, by the pair-precision Cholesky of
  ``ops/meshchol.py`` of a lam'-shifted pair copy, the preconditioner of CG
  on the kept f64 strip, along a lam' ladder with an f64 fallback.
* **Serving** (:func:`predict_sharded`): each rank predicts its shard of
  the query batch against the whole tables (on a GPU the fused kernel), then
  one all-gather.
* **Nystrom factor** (:func:`nystrom_factor_sharded`): row-sharded kernel
  columns, rank-local triangular solves and one all-reduce of the ``(k,
  k)`` Gram; the factor comes back column-sharded. The int8 slice stack
  (:func:`nystrom_factor_sharded_streamed`): each rank streams its own
  points' assembly chunks into its column block of the stack
  (:class:`ShardedSliceFactor`), applied by
  :func:`ozaki_factor_apply_sharded` (``_bordered`` with energy
  constraints).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cyclic, linalg, meshchol
from ..ops.pairchol import _write_pair
from ..ops.kernel import (
    _grad_row_tile, _perm_summed_tile, _perms_key, _tile_constants, _value_tile, assemble_kernel_columns_range,
    column_force_tile, column_tables, column_tile_rows, default_tile_sizes, expand_perm_jacobian, perm_tables,
)
from ..utils.profiling import PhaseTimer
from .mesh import MeshInfo, agree, all_gather_rows, all_reduce_, check_device, mesh_info

__all__ = [
    'ShardedLayout',
    'ShardedSliceFactor',
    'assemble_kernel_columns_sharded',
    'assemble_kernel_sharded',
    'nystrom_factor_sharded',
    'nystrom_factor_sharded_streamed',
    'ozaki_factor_apply_sharded',
    'ozaki_factor_apply_sharded_bordered',
    'predict_sharded',
    'shard_batch',
    'solve_interleaved',
]

log = logging.getLogger(__name__)

# The masked f64 route's block size (its last block may be short); the pair
# and cyclic routes take the largest divisor of n_rows up to it, as the JAX
# package picks its block size.
NB = 1024
# The pair route's lam' ladder in units of lmax, its CG's iteration cap and
# tolerance, and the relative residual a rung must reach to be taken
# (``sgdml_tpu/parallel/spmd.py:420-440``).
PAIR_LAM_P_SHIFTS = (3e-9, 3e-8, 3e-7, 3e-6)
PAIR_CG_ITERS, PAIR_CG_RTOL, PAIR_CG_GATE = 2000, 1e-9, 1e-8


def _shard_bounds(n: int, info: MeshInfo):
    loc = -(-n // info.size)
    return loc, info.rank * loc


def shard_batch(x, mesh):
    """This rank's shard of the batch ``x`` (its leading axis split evenly by
    rank), zero-padded on the rank where the batch runs out, so that every
    shard has ``ceil(B / ranks)`` rows. Every rank holds its inputs whole,
    so nothing needs replicating (the JAX package's ``replicate``)."""
    info = mesh_info(mesh)
    x = torch.as_tensor(x, device=info.device)
    loc, b0 = _shard_bounds(x.shape[0], info)
    part = x[b0:b0 + loc]
    if part.shape[0] < loc:
        part = torch.cat([part, part.new_zeros((loc - part.shape[0],) + tuple(x.shape[1:]))])
    return part


class ShardedLayout:
    """Host-side bookkeeping for the device-major interleaved row layout.

    Standard order (reference layout): ``[m 3N force dofs (point-major) | m
    energy rows]``, ``n = m 3N (+ m)`` in all. Interleaved order: points
    padded to ``m_pad = n_dev mloc``; rank ``g`` owns rows ``[g rloc, (g +
    1) rloc) = [mloc 3N force rows | mloc energy rows]``. Same arrays as
    ``sgdml_tpu.parallel.spmd.ShardedLayout``.
    """

    def __init__(self, m: int, n_atoms: int, n_dev: int, use_E_cstr: bool):
        self.m = m
        self.n_atoms = n_atoms
        self.n_dev = n_dev
        self.use_E_cstr = bool(use_E_cstr)
        dim_i = 3 * n_atoms
        self.dim_i = dim_i
        self.mloc = -(-m // n_dev)
        self.m_pad = self.mloc * n_dev
        self.rloc = self.mloc * dim_i + (self.mloc if use_E_cstr else 0)
        self.n_rows = self.rloc * n_dev
        self.n = m * dim_i + (m if use_E_cstr else 0)

        # to_std[i_int] = index into the standard-order vector, or -1.
        rows = np.arange(self.n_rows)
        g = rows // self.rloc
        r = rows % self.rloc
        is_force = r < self.mloc * dim_i
        j = np.where(is_force, g * self.mloc + r // dim_i, g * self.mloc + (r - self.mloc * dim_i))
        std = np.where(is_force, j * dim_i + r % dim_i, m * dim_i + j)
        self.to_std = np.where(j < m, std, -1)
        self.mask = self.to_std >= 0
        # from_std[std_idx] = interleaved index (valid rows only).
        self.from_std = np.empty(self.n, dtype=np.int64)
        self.from_std[self.to_std[self.mask]] = rows[self.mask]

    def scatter_vec(self, y_std):
        """Standard-order vector (n,) -> interleaved (n_rows,), zero-padded."""
        out = np.zeros(self.n_rows, dtype=np.asarray(y_std).dtype)
        out[self.from_std] = np.asarray(y_std)
        return out

    def gather_vec(self, x_int):
        """Interleaved vector (n_rows,) -> standard order (n,)."""
        return np.asarray(x_int)[self.from_std]


def _pad_rows(a, rows):
    """``a`` with zero rows appended up to ``rows``."""
    if a.shape[0] == rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))])


def assemble_kernel_sharded(R_desc, R_d_desc, desc_perms, sig, n_atoms, mesh, use_E_cstr: bool = False):
    """This rank's strip of the interleaved kernel matrix.

    R_desc ``(M, D)``, R_d_desc ``(M, D, 3)``: all training points, whole on
    every rank, on the mesh's device. Returns ``(K_loc, layout)``: the
    ``(rloc, n_rows)`` strip of rows ``[g rloc, (g + 1) rloc)`` and the
    :class:`ShardedLayout`. Gathered over the ranks, the strips equal the
    JAX package's ``assemble_kernel_sharded`` (padded points included: their
    descriptors are zero), and their valid block the single-device
    ``assemble_kernel`` under the layout's permutation.

    Row and column tiles come from the port's tile budget
    (``ops/kernel.default_tile_sizes``). No communication.
    """
    info = mesh_info(mesh)
    check_device(info, R_desc, R_d_desc)
    m, dim_d = R_desc.shape
    lay = ShardedLayout(m, n_atoms, info.size, use_E_cstr)
    mloc, dim_i, rloc = lay.mloc, lay.dim_i, lay.rloc
    X, Jc = _pad_rows(R_desc, lay.m_pad), _pad_rows(R_d_desc, lay.m_pad)
    key = _perms_key(desc_perms)
    n_perms = key[1][0]
    consts = _tile_constants(key, n_atoms, X.device, X.dtype)
    s_perm = consts[1]
    Xp, Jcp = perm_tables(X, Jc, desc_perms)  # (m_pad, P, D), (m_pad, P, D, 3)
    ti, tj = default_tile_sizes(lay.m_pad, n_atoms, n_perms, X.element_size())
    tile_i, tile_j = min(ti, mloc), min(tj, mloc)

    p0 = info.rank * mloc  # this strip's first point
    n_f = mloc * dim_i  # its force rows
    K = torch.empty((rloc, lay.n_rows), dtype=X.dtype, device=X.device)
    for i0 in range(0, mloc, tile_i):
        i1 = min(mloc, i0 + tile_i)
        pi = slice(p0 + i0, p0 + i1)
        rows = slice(i0 * dim_i, i1 * dim_i)
        if use_E_cstr:
            # Row-side permuted Jacobians, for the force rows under energy
            # columns (there the permutations act on the row side).
            Jit = expand_perm_jacobian(Jcp[pi], s_perm).reshape(-1, dim_d, dim_i)
            Xit = Xp[pi].reshape(-1, dim_d)
        for h in range(info.size):
            for t0 in range(0, mloc, tile_j):
                t1 = min(mloc, t0 + tile_j)
                pj = slice(h * mloc + t0, h * mloc + t1)
                cf = h * rloc + t0 * dim_i  # interleaved column of the tile's first force dof
                cols = slice(cf, cf + (t1 - t0) * dim_i)
                blk = _perm_summed_tile(X[pi], Jc[pi], Xp[pj], Jcp[pj], sig, *consts)
                K[rows, cols].view(i1 - i0, n_atoms, 3, t1 - t0, n_atoms, 3).copy_(blk.permute(0, 2, 3, 1, 4, 5))
                if not use_E_cstr:
                    continue
                ce = slice(h * rloc + mloc * dim_i + t0, h * rloc + mloc * dim_i + t1)
                # Energy rows under force columns: -grad_x k(x_i, x_t)^T J_t.
                Jt = expand_perm_jacobian(Jcp[pj], s_perm).reshape(-1, dim_d, dim_i)
                fe = _grad_row_tile(X[pi], Xp[pj].reshape(-1, dim_d), Jt, sig)
                K[n_f + i0:n_f + i1, cols] = fe.reshape(i1 - i0, t1 - t0, n_perms, dim_i).sum(2).reshape(i1 - i0, -1)
                # Force rows under energy columns.
                ef = _grad_row_tile(X[pj], Xit, Jit, sig).reshape(t1 - t0, i1 - i0, n_perms, dim_i).sum(2)
                K[rows, ce] = ef.permute(1, 2, 0).reshape(-1, t1 - t0)
                # Energy-energy block: -sum_p k(x_j, x_i^p).
                ee = _value_tile(X[pj], Xit, sig).reshape(t1 - t0, i1 - i0, n_perms).sum(2)
                K[n_f + i0:n_f + i1, ce] = ee.T
    return K, lay


def _largest_divisor(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _prep_strip_(K_loc, lam, lay: ShardedLayout, info: MeshInfo):
    """``K_loc <- -K_loc`` with its padded rows and columns zeroed and
    ``lam`` (1 on padded rows, which then solve to exactly 0) on its
    diagonal, in place: this rank's strip of the SPD system. Returns the
    strip's row mask (False on padded rows)."""
    r0 = info.rank * lay.rloc
    mask_loc = torch.as_tensor(lay.mask[r0:r0 + lay.rloc], device=K_loc.device)
    K_loc.neg_()
    pad_cols = np.nonzero(~lay.mask)[0]
    if pad_cols.size:
        K_loc.index_fill_(1, torch.as_tensor(pad_cols, device=K_loc.device), 0.0)
        K_loc.index_fill_(0, torch.nonzero(~mask_loc)[:, 0], 0.0)
    diag = K_loc.diagonal(offset=r0)
    diag.copy_(torch.where(mask_loc, diag + lam, torch.ones_like(diag)))
    return mask_loc


def _pair_copy(A_loc, mask_loc, r0, shift, nb):
    """The (f32, bf16) pair of the strip ``A_loc`` with ``shift`` added to
    its valid diagonal in f64 before the split (an f32 add would round it
    against O(1) entries), a row block of ``nb`` at a time: no second f64
    strip is made."""
    hi = torch.empty(A_loc.shape, dtype=torch.float32, device=A_loc.device)
    lo = torch.empty(A_loc.shape, dtype=torch.bfloat16, device=A_loc.device)
    d = torch.where(mask_loc, shift, 0.0).to(A_loc.dtype)
    for i0 in range(0, A_loc.shape[0], nb):
        i1 = min(A_loc.shape[0], i0 + nb)
        x = A_loc[i0:i1].clone()
        x.diagonal(offset=r0 + i0).add_(d[i0:i1])
        _write_pair(hi[i0:i1], lo[i0:i1], x)
    return hi, lo


def _pair_cg(A_apply, M_apply, b, info: MeshInfo, max_iters: int):
    """CG on ``A x = b`` preconditioned by ``M_apply`` from ``x = 0``, to
    ``PAIR_CG_RTOL |b|`` or ``max_iters``: the JAX package's ``while_loop``
    (``spmd.py:360-384``) as host-driven chunks of ``analytic._pcg_chol``,
    each chunk's stop and count taken from rank 0. Returns ``(x, rel,
    iters)``, ``rel`` the recursive residual over ``|b|``."""
    from ..solvers.analytic import PCG_CHUNK_ITERS, _pcg_chol

    def flag(t):
        return bool(agree([float(bool(t))], info)[0])

    b_norm = float(torch.linalg.vector_norm(b))
    z0 = M_apply(b)
    state = (torch.zeros_like(b), b, z0, z0, b @ z0, None)
    iters, rel = 0, np.inf
    while iters < max_iters:
        chunk = min(PCG_CHUNK_ITERS, max_iters - iters)
        state, resid = _pcg_chol(state, A_apply, M_apply, b_norm, PAIR_CG_RTOL, max_iters=chunk, flag=flag)
        head = agree(torch.stack([state[5].to(torch.float64), resid]).cpu().numpy(), info)
        iters += int(head[0])
        rel = float(head[1]) / b_norm
        if not np.isfinite(rel) or rel <= PAIR_CG_RTOL or int(head[0]) < chunk:
            break
    return state[0], rel, iters


def _solve_pair(A_loc, mask_loc, y, lam, lmax, mesh, nb, timer, stats):
    """The pair route's lam' ladder on the prepared strip ``A_loc`` (kept:
    it is the CG's f64 system; ``mask_loc`` its row mask): per rung a
    shifted pair copy, its pair-precision factor (``ops/meshchol.py``) and
    CG on the f64 system preconditioned by it
    (``sgdml_tpu/parallel/spmd.py:327-451``). Returns the interleaved
    solution, or None where every rung failed; each rung's pair factor is
    freed before the next."""
    info = mesh_info(mesh)
    r0 = info.rank * A_loc.shape[0]

    def A_apply(p):
        return all_gather_rows(A_loc @ p, info)

    for shift in PAIR_LAM_P_SHIFTS:
        lam_p = max(lam, shift * lmax)
        with timer.phase('factor'):
            hi, lo = _pair_copy(A_loc, mask_loc, r0, lam_p - lam, nb)
            hi, lo, bad = meshchol.blocked_cholesky_pair(hi, lo, nb, mesh)
        x, rel, iters = None, np.nan, 0
        if not bad:
            with timer.phase('solve'):
                x, rel, iters = _pair_cg(A_apply, lambda v: meshchol.cho_solve_pair(hi, lo, v, nb, mesh), y, info,
                                         PAIR_CG_ITERS)
        del hi, lo
        stats['rungs'].append((lam_p, bad, iters, rel))
        timer.counts['rungs'] = timer.counts.get('rungs', 0) + 1
        if not bad and np.isfinite(rel) and rel <= PAIR_CG_GATE:
            stats.update(lam_p=lam_p, iters=iters, rel=rel)
            log.info("Mesh pair solve: lam'=%g (%g lmax), %d CG iterations, relative residual %.2e.",
                     lam_p, shift, iters, rel)
            return x
        if not bad:
            log.warning("Mesh pair solve at lam'=%g did not converge (relative residual %.2e after %d CG "
                        'iterations); trying the next rung.', lam_p, rel, iters)
        else:
            log.debug("Mesh pair rung lam'=%g: the factorization failed at order %d.", lam_p, bad)
    return None


def solve_interleaved(K_loc, y_std, lam, lay: ShardedLayout, mesh, precision: str = 'f64', layout: str = 'masked',
                      timer=None, stats=None):
    """Solve the sharded interleaved system; returns the standard-order
    ``alphas = -(-K + lam I)^{-1} y`` as a float64 tensor, whole on every
    rank (the analytic solver's sign convention).

    ``K_loc`` (this rank's strip from :func:`assemble_kernel_sharded`) is
    consumed: negated, its padded rows and columns zeroed and ``lam`` (1 on
    padded rows, which then solve to exactly 0) put on its diagonal in
    place, then

    * ``precision='f64'``, ``layout='masked'``: factored in place by the
      blocked Cholesky of ``ops/linalg.py`` in blocks of :data:`NB`
      (``n_rows`` when fewer);
    * ``layout='cyclic'``: factored by ``ops/cyclic.py``'s block-cyclic
      Cholesky in blocks of the largest divisor of ``n_rows`` up to
      :data:`NB` (as the JAX package picks its block size);
    * ``precision='pair'``: kept as the f64 system of CG, preconditioned by
      the pair-precision factor of a lam'-shifted pair copy
      (``ops/meshchol.py``, the same block size), along the lam' ladder
      :data:`PAIR_LAM_P_SHIFTS` of the Gershgorin bound ``lmax`` (the
      largest row sum of ``|K|`` over the ranks, plus ``lam``). A rung is
      taken where the factor holds and CG reaches :data:`PAIR_CG_GATE`;
      where none is, the f64 factorization of ``layout`` runs, with a
      warning (the JAX package's fallback).

    ``y_std``: the ``(n,)`` labels in standard order. ``timer``: a
    ``PhaseTimer`` charged ``'factor'`` and ``'solve'`` (the pair route's
    CG), with the pair route's rungs counted in ``timer.counts['rungs']``.
    ``stats``: a dict that the pair route fills with ``lmax``, ``rungs``
    (``(lam', info, CG iterations, relative residual)`` a rung), ``lam_p``,
    ``iters``, ``rel`` and ``fallback``.
    """
    if precision not in ('f64', 'pair') or layout not in ('masked', 'cyclic'):
        raise ValueError("precision must be 'f64' or 'pair' and layout 'masked' or 'cyclic', got %r, %r"
                         % (precision, layout))
    info = mesh_info(mesh)
    check_device(info, K_loc)
    timer = timer or PhaseTimer(K_loc.device)
    stats = {} if stats is None else stats
    if isinstance(y_std, torch.Tensor):
        y_std = y_std.cpu().numpy()
    y = torch.as_tensor(lay.scatter_vec(np.asarray(y_std, dtype=np.float64)), device=K_loc.device)
    nb_div = _largest_divisor(lay.n_rows, NB)
    x = None
    if precision == 'pair':
        # Gershgorin: lmax <= the largest row sum of |A|, of the raw kernel.
        rows = torch.linalg.vector_norm(K_loc, ord=1, dim=1).max()
        lmax = float(all_gather_rows(rows[None], info).max()) + lam
        stats.update(lmax=lmax, rungs=[], fallback=False)
        x = _solve_pair(K_loc, _prep_strip_(K_loc, lam, lay, info), y, lam, lmax, mesh, nb_div, timer, stats)
        if x is None:
            stats['fallback'] = True
            log.warning('Pair solve failed at every rung (factorization or CG); falling back to f64.')
    else:
        _prep_strip_(K_loc, lam, lay, info)
    if x is None and layout == 'cyclic':
        x = cyclic.cho_solve_cyclic(K_loc, y, nb_div, mesh, timer=timer)
    elif x is None:
        nb = min(NB, lay.n_rows)
        with timer.phase('factor'):
            L = linalg.blocked_cholesky(K_loc, nb, mesh)
        with timer.phase('solve'):
            x = linalg.blocked_tri_solve(L, linalg.blocked_tri_solve(L, y, nb, mesh=mesh), nb, trans=True, mesh=mesh)
    return -x[torch.as_tensor(lay.from_std, device=x.device)]


def assemble_kernel_columns_sharded(R_desc, R_d_desc, desc_perms, sig, n_atoms, col_3n_idxs, mesh,
                                    tile_i: int | None = None):
    """This rank's rows of the Nystrom columns ``K[:, cols]`` (force block
    only): the ``(mloc 3N, C)`` rows of its strip of points, ``mloc =
    ceil(M / ranks)``; rows of padded points are zero. Gathered over the
    ranks: the JAX package's ``(m_pad 3N, C)`` array. ``col_3n_idxs`` index
    the ``M 3N`` force axis; row tiles of ``tile_i`` points (default
    ``ops/kernel.column_tile_rows``). No communication.
    """
    info = mesh_info(mesh)
    check_device(info, R_desc, R_d_desc)
    m = R_desc.shape[0]
    dim_i = 3 * n_atoms
    mloc, p0 = _shard_bounds(m, info)
    n_cols = int(np.asarray(col_3n_idxs).shape[0])
    key = _perms_key(desc_perms)
    if tile_i is None:
        tile_i = column_tile_rows(mloc, n_cols, n_atoms, key[1][0], R_desc.element_size())
    s_id, s_perm = _tile_constants(key, n_atoms, R_desc.device, R_desc.dtype)[:2]
    Xjp, Jt_col = column_tables(R_desc, R_d_desc, desc_perms, col_3n_idxs, n_atoms, s_perm)
    C = R_desc.new_zeros((mloc * dim_i, n_cols))
    for i0 in range(p0, min(m, p0 + mloc), tile_i):
        i1 = min(m, p0 + mloc, i0 + tile_i)
        C[(i0 - p0) * dim_i:(i1 - p0) * dim_i] = column_force_tile(
            R_desc[i0:i1], R_d_desc[i0:i1], Xjp, Jt_col, s_id, sig)[0]
    return C


def nystrom_factor_sharded(C_loc, cols, lam, reg_w, reg_i, mesh):
    """Woodbury factor ``F (k, n_pad)`` from row-sharded PSD columns.

    The distributed twin of ``solvers/iterative._nystrom_factor_from_cols``:
    ``W = C[cols]`` is gathered by one all-reduce (each row from its rank),
    the two ``(k, k)`` Cholesky stages run on every rank alike, the long
    triangular solves on each rank's rows, and the Gram ``Y Y^T`` reduces
    with one all-reduce; so a rank holds ``k n / ranks`` of the factor. As
    on one device, both passes go over column chunks, so that the columns,
    then the ``Y`` chunks and the factor, take 16 bytes an element at most.
    ``C_loc`` (this rank's ``(nloc, k)`` rows, consumed) and ``cols``
    (host indices into the padded force axis). Returns ``(F_loc, lev, ok)``:
    this rank's ``(k, nloc)`` columns of the factor, the ``(n_pad,)``
    leverage scores whole, and whether both stages held (the same on every
    rank). ``(None, None, False)`` when a stage fails.
    """
    from ..solvers.iterative import _SOLVE_CHUNK, _chol_reg, _solve_chunk

    info = mesh_info(mesh)
    check_device(info, C_loc)
    nloc, k = C_loc.shape
    cols = np.asarray(cols, dtype=np.int64)
    r0 = info.rank * nloc
    W = C_loc.new_zeros((k, k))
    mine = np.nonzero((cols >= r0) & (cols < r0 + nloc))[0]
    if mine.size:
        W[torch.as_tensor(mine, device=W.device)] = C_loc[torch.as_tensor(cols[mine] - r0, device=W.device)]
    all_reduce_(W, info)
    Lw, ok_w = _chol_reg(W, reg_w)
    del W
    if not ok_w:
        return None, None, False
    chunk = min(_SOLVE_CHUNK, nloc)
    gram = C_loc.new_zeros((k, k))
    y_chunks = [_solve_chunk(Lw, C_loc[c0:c0 + chunk].T, gram) for c0 in range(0, nloc, chunk)]
    del C_loc, Lw
    all_reduce_(gram, info)
    L, ok_i = _chol_reg(gram, lam + reg_i)
    del gram
    if not ok_i:
        return None, None, False
    F = L.new_empty((k, nloc))
    lev = L.new_empty(nloc)
    y_chunks.reverse()
    for c0 in range(0, nloc, chunk):
        Fc = torch.linalg.solve_triangular(L, y_chunks.pop(), upper=False)
        F[:, c0:c0 + chunk] = Fc
        lev[c0:c0 + chunk] = torch.sum(Fc * Fc, dim=0)
    return F, all_gather_rows(lev, info), True


class ShardedSliceFactor(NamedTuple):
    """The int8 slice-stack Woodbury factor column-sharded over a mesh.

    Rank ``g`` holds ``F``, a ``solvers.iterative.SliceFactor`` over its
    ``n_ch_loc`` column chunks: the force columns of training points ``[g
    m_loc, (g + 1) m_loc)``, device-major, padded only past point ``M``. So
    a standard-order force vector zero-padded at its tail to ``ranks *
    _factor_ncols(F)`` is already in the stack's column order. ``F_E``: the
    replicated ``(k, M)`` f64 energy-constraint border, or None."""

    F: object
    F_E: object
    info: object  # parallel.mesh.MeshInfo


def _stack_part(F: ShardedSliceFactor, v):
    """This rank's part of a whole vector over the padded force columns."""
    from ..solvers.iterative import _factor_ncols

    nloc = _factor_ncols(F.F)
    return v[F.info.rank * nloc:(F.info.rank + 1) * nloc]


def _sharded_fv(F: ShardedSliceFactor, v_loc):
    """``F v`` over the stack's padded rows: each rank's partial product from
    its column block, then one all-reduce."""
    from ..solvers.iterative import _stack_matvec

    return all_reduce_(_stack_matvec(F.F, v_loc), F.info)


def ozaki_factor_apply_sharded(F: ShardedSliceFactor, v):
    """``v - F^T (F v)`` from a column-sharded slice stack, ``v`` whole over
    the padded force columns (``ranks * _factor_ncols(F.F)``) on every rank:
    ``F v`` by one all-reduce of the ranks' ``ozaki.matvec_sliced_long``,
    ``F^T w`` by ``matvec_sliced_long_t`` on each rank's block, one
    all-gather (``sgdml_tpu/parallel/spmd.py:660-696``). No f64 product of
    the factor runs anywhere."""
    from ..solvers.iterative import _stack_matvec_t

    v_loc = _stack_part(F, v)
    return all_gather_rows(v_loc - _stack_matvec_t(F.F, _sharded_fv(F, v_loc)), F.info)


def ozaki_factor_apply_sharded_bordered(F: ShardedSliceFactor, v):
    """``v - F^T (F v)`` for the energy-bordered factor ``[F_F | F_E]``:
    ``v`` is the standard-order ``[forces | energies]`` vector, whose force
    part is zero-padded here to the stack's columns; the replicated f64
    border ``F_E`` joins ``F v`` after the all-reduce, and its part of the
    result is computed on every rank (``sgdml_tpu/parallel/spmd.py:698-745``)."""
    from ..solvers.iterative import _factor_ncols, _stack_matvec_t

    k, m = F.F_E.shape
    n_F = v.shape[0] - m
    v_F = torch.nn.functional.pad(v[:n_F], (0, F.info.size * _factor_ncols(F.F) - n_F))
    v_E = v[n_F:]
    v_loc = _stack_part(F, v_F)
    w = _sharded_fv(F, v_loc)
    w[:k] += F.F_E @ v_E
    out_F = all_gather_rows(v_loc - _stack_matvec_t(F.F, w), F.info)[:n_F]
    return torch.cat([out_F, v_E - F.F_E.T @ w[:k]])


def _gram_apply_sharded(F: ShardedSliceFactor, v):
    """``F^T (F v)`` of the represented force-only factor for a whole ``v``
    (the power step of :func:`_renorm_sliced_factor_sharded`)."""
    from ..solvers.iterative import _stack_matvec_t

    return all_gather_rows(_stack_matvec_t(F.F, _sharded_fv(F, _stack_part(F, v))), F.info)


def _renorm_sliced_factor_sharded(F: ShardedSliceFactor, n_slices: int, iters: int = 40):
    """The sharded twin of ``iterative._renorm_sliced_factor``: the
    represented ``||F||`` by power iteration on the same sharded products
    the CG apply uses, from ``np.random.default_rng(12345)``'s vector drawn
    whole on every rank (the JAX package's numbers); where it exceeds ``1 -
    eps``, the chunk scales shrink, and with them the border ``F_E``, whose
    combined operator ``[F_F | F_E]`` is iterated through the bordered apply
    (``sgdml_tpu/parallel/spmd.py:1092-1151``). The decision is rank 0's."""
    from ..ops import ozaki
    from ..solvers.iterative import _factor_ncols

    info = F.info
    k, ncols = F.F.rows, info.size * _factor_ncols(F.F)
    m_e = 0 if F.F_E is None else F.F_E.shape[1]
    dev = F.F.s.device
    v = torch.as_tensor(np.random.default_rng(12345).standard_normal(ncols + m_e), device=dev)
    v = v / torch.linalg.vector_norm(v)
    nrm = None
    for _ in range(iters):
        u = _gram_apply_sharded(F, v) if F.F_E is None else v - ozaki_factor_apply_sharded_bordered(F, v)
        nrm = torch.linalg.vector_norm(u)
        v = u / torch.clamp_min(nrm, 1e-300)
    sigma_sq = float(agree([float(nrm)], info)[0])
    eps = min(max(1e-9, 8.0 * np.sqrt(float(k) * (ncols + m_e)) * 2.0 ** (-ozaki.Q_BITS * n_slices)), 1e-3)
    if sigma_sq <= (1.0 - eps) ** 2:
        return F
    s = (1.0 - eps) / np.sqrt(sigma_sq)
    log.debug('Renormalizing the sharded slice-stack factor: represented ||F||=%.3e -> %.3e (%d slices).',
              np.sqrt(sigma_sq), 1.0 - eps, n_slices)
    F_loc = F.F._replace(sig=F.F.sig * torch.tensor(s, dtype=F.F.sig.dtype, device=dev))
    return F._replace(F=F_loc, F_E=None if F.F_E is None else F.F_E * s)


def nystrom_factor_sharded_streamed(X, Jc, desc_perms, sig, lam, col_idxs, n_atoms, mesh, n_slices: int = 8,
                                    C_E_psd=None):
    """Streamed, column-sharded int8 slice-stack Woodbury factor: the mesh
    twin of ``Iterative._build_factor_streamed``
    (``sgdml_tpu/parallel/spmd.py:903-1089``).

    Rank ``d`` owns the training points ``[d m_loc, (d + 1) m_loc)`` in
    ``n_ch_loc`` assembly chunks of ``pt_ch = min(8192 // 3N, ceil(M /
    ranks))`` points (``m_loc = n_ch_loc pt_ch``, points past ``M`` padded
    with zero columns), so its high-water mark is its ``n_slices``-byte
    stack and one chunk. ``X``/``Jc``: all ``M`` training points, whole on
    every rank. Three sweeps, in the f64 build's regularization ladder:

    1. W: the inducing rows, each from the rank whose chunk holds it, one
       all-reduce; ``chol(W)`` on every rank (``_chol_reg``, ``cholesky_ex``).
    2. Gram: per own chunk the whitened 8-slice Ozaki Gram
       (``iterative._gram_accum_y``), one all-reduce a sweep; with energy
       constraints the exact f64 Gram of the whitened border ``Y_E =
       L_W^{-1} C_E^T`` is added. A failed ``chol(gram + lam I)``
       re-sweeps with the next rung.
    3. F: per own chunk ``F_c = L^{-1} L_W^{-1} C_c^T``, sliced into the
       rank's stack in place (``iterative._f_chunk_streamed``).

    ``C_E_psd``: the ``(M, k)`` PSD energy rows of the inducing columns
    (``-assemble_kernel_E_rows``), or None. Every ladder decision is rank
    0's. Returns ``(ShardedSliceFactor, leverage scores)``: the scores as a
    host array over the padded force rows (device-major, the padded row
    order), then the ``M`` energy rows with constraints. Below 8 slices the
    factor is renormalized (:func:`_renorm_sliced_factor_sharded`). The
    seconds of each sweep are logged.
    """
    from ..solvers.iterative import (
        _SOLVE_CHUNK, SliceFactor, _chol_reg, _f_chunk_streamed, _gram_accum_y,
    )

    info = mesh_info(mesh)
    check_device(info, X, Jc)
    D = info.size
    m = X.shape[0]
    dim_i = 3 * n_atoms
    cols = np.asarray(col_idxs, dtype=np.int64)
    kcols = len(cols)
    pt_ch = min(max(1, _SOLVE_CHUNK // dim_i), -(-m // D))
    n_ch_loc = -(-m // (D * pt_ch))
    rows_ch = pt_ch * dim_i
    c_first = info.rank * n_ch_loc  # this rank's first chunk, globally
    timer = PhaseTimer(X.device)

    def chunk(c):
        return assemble_kernel_columns_range(X, Jc, desc_perms, sig, n_atoms, cols, (c_first + c) * pt_ch, pt_ch,
                                             m).neg_()

    def agreed(ok):
        return bool(agree([float(ok)], info)[0])

    with timer.phase('W sweep'):
        W = X.new_zeros((kcols, kcols))
        for c in range(n_ch_loc):
            g0 = (c_first + c) * rows_ch
            sel = np.nonzero((cols >= g0) & (cols < g0 + rows_ch))[0]
            if sel.size:
                W[torch.as_tensor(sel, device=X.device)] = chunk(c)[torch.as_tensor(cols[sel] - g0, device=X.device)]
        all_reduce_(W, info)
    Y_E = None
    for reg in [0.0] + list(10.0 ** np.arange(-16, 2)):
        Lw, ok = _chol_reg(W.clone(), reg)
        if not agreed(ok):
            continue
        with timer.phase('Gram sweep'):
            gram = X.new_zeros((kcols, kcols))
            for c in range(n_ch_loc):
                _gram_accum_y(gram, Lw, chunk(c))
            all_reduce_(gram, info)
            if C_E_psd is not None:
                Y_E = torch.linalg.solve_triangular(Lw, C_E_psd.T, upper=False)
                gram.addmm_(Y_E, Y_E.T)
        L, ok = _chol_reg(gram, lam + reg)
        del gram
        if agreed(ok):
            if reg > 0:
                log.debug('Nystrom factor needed regularization %g.', reg)
            break
        log.debug('Sharded Nystrom gram stage failed at reg=%g; re-sweeping with stronger regularization.', reg)
    else:
        raise RuntimeError(
            'Failed to factorize the Nystrom preconditioner despite strong '
            'regularization. Try a larger sigma.'
        )
    del W

    ns = int(n_slices)
    stride = -(-rows_ch // 16) * 16
    with timer.phase('F sweep'):
        sF = torch.zeros((ns, -(-kcols // 16) * 16, n_ch_loc * stride), dtype=torch.int8, device=X.device)
        sigs, levs = [], []
        for c in range(n_ch_loc):
            lev_c, s_c, sig_c = _f_chunk_streamed(Lw, L, chunk(c), ns)
            sF[:, :kcols, c * stride:c * stride + rows_ch] = s_c
            sigs.append(sig_c)
            levs.append(lev_c)
        lev = all_gather_rows(torch.cat(levs), info)
        F_E = None
        if C_E_psd is not None:
            F_E = torch.linalg.solve_triangular(L, Y_E, upper=False)
            lev = torch.cat([lev, torch.sum(F_E * F_E, dim=0)])
        del Lw, L, Y_E
        F = ShardedSliceFactor(SliceFactor(sF, torch.stack(sigs), rows_ch, kcols), F_E, info)
    if ns < 8:
        with timer.phase('renormalization'):
            F = _renorm_sliced_factor_sharded(F, ns)
    log.info('Sharded streamed slice-stack factor (%d ranks, %d slices, k=%d columns, n=%d, local stack %.3f GB): '
             'W sweep %.3f s, Gram sweep %.3f s, F sweep %.3f s, renormalization %.3f s.', D, ns, kcols,
             D * n_ch_loc * rows_ch, sF.numel() / 1e9, timer.durations['W sweep'], timer.durations['Gram sweep'],
             timer.durations['F sweep'], timer.durations.get('renormalization', 0.0))
    return F, lev.cpu().numpy()


def predict_sharded(Xq, Jcq, tables, sig, std, c, n_atoms: int, mesh, alphas_E_lin=None, mm: str = 'native',
                    batch_size: int | None = None):
    """Batch-sharded prediction: each rank predicts its shard of the query
    descriptors ``Xq (B, D)``, ``Jcq (B, D, 3)`` (:func:`shard_batch`)
    against the whole centered ``tables`` (``predict.Tables``; on a GPU the
    fused kernel K1, at the matvec rung ``mm``), in chunks of ``batch_size``
    queries (None: the whole shard at once), then one all-gather. Returns
    ``(E (B,), F (B, 3N))`` on every rank. ``GDMLPredict(mesh=)`` serves
    descriptors and its training points through it, and the mesh CG's
    matvec the training points."""
    from ..predict import predict_from_tables

    info = mesh_info(mesh)
    B = Xq.shape[0]
    Xs, Jcs = shard_batch(Xq, mesh), shard_batch(Jcq, mesh)
    loc = Xs.shape[0]
    bs = loc if batch_size is None else max(1, int(batch_size))
    parts = [predict_from_tables(Xs[b0:b0 + bs], Jcs[b0:b0 + bs], tables, alphas_E_lin, sig, std, c,
                                 n_atoms=n_atoms, mm=mm) for b0 in range(0, loc, bs)]
    E, F = parts[0] if len(parts) == 1 else (torch.cat(x) for x in zip(*parts))
    return all_gather_rows(E, info)[:B], all_gather_rows(F, info)[:B]
