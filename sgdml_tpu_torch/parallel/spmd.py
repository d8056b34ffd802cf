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
  shifted in place, then factored by the distributed blocked Cholesky of
  ``ops/linalg.py``; the masked copy the JAX program makes (it donates the
  matrix instead) is never made.
* **Serving** (:func:`predict_sharded`): each rank predicts its shard of
  the query batch against the whole tables (on a GPU the fused kernel), then
  one all-gather.
* **Nystrom factor** (:func:`nystrom_factor_sharded`): row-sharded kernel
  columns, rank-local triangular solves and one all-reduce of the ``(k,
  k)`` Gram; the factor comes back column-sharded.

The int8 and pair-precision routes on a mesh (``ops/meshchol.py``, the
streamed slice-stack factor, the ``'cyclic'`` layout) are ROADMAP item 13b
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import linalg
from ..ops.kernel import (
    _grad_row_tile, _perm_summed_tile, _perms_key, _tile_constants, _value_tile, column_force_tile,
    column_tables, column_tile_rows, default_tile_sizes, expand_perm_jacobian, perm_tables,
)
from ..utils.profiling import PhaseTimer
from .mesh import MeshInfo, all_gather_rows, all_reduce_, check_device, mesh_info

__all__ = [
    'ShardedLayout',
    'assemble_kernel_columns_sharded',
    'assemble_kernel_sharded',
    'nystrom_factor_sharded',
    'predict_sharded',
    'shard_batch',
    'solve_interleaved',
]

ITEM_13B = 'ROADMAP queue 1 item 13b (the int8 and pair routes on a mesh)'

NB = 1024  # the block size of the interleaved solve's factor


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


def solve_interleaved(K_loc, y_std, lam, lay: ShardedLayout, mesh, precision: str = 'f64', layout: str = 'masked',
                      timer=None):
    """Solve the sharded interleaved system; returns the standard-order
    ``alphas = -(-K + lam I)^{-1} y`` as a float64 tensor, whole on every
    rank (the analytic solver's sign convention).

    ``K_loc`` (this rank's strip from :func:`assemble_kernel_sharded`) is
    consumed: negated, its padded rows and columns zeroed, ``lam`` (1 on
    padded rows, which then solve to exactly 0) put on its diagonal, and
    factored, all in place, in blocks of :data:`NB` rows (``n_rows`` when
    fewer). ``y_std``: the ``(n,)`` labels in standard order.
    ``timer``: a ``PhaseTimer`` that is charged ``'factor'`` and ``'solve'``.

    ``precision='pair'`` and ``layout='cyclic'`` are ROADMAP item 13b.
    """
    if precision == 'pair' or layout == 'cyclic':
        raise NotImplementedError("precision='pair' and layout='cyclic' on a mesh are " + ITEM_13B)
    if precision != 'f64' or layout != 'masked':
        raise ValueError("precision must be 'f64' or 'pair' and layout 'masked' or 'cyclic', got %r, %r"
                         % (precision, layout))
    info = mesh_info(mesh)
    check_device(info, K_loc)
    r0 = info.rank * lay.rloc
    mask_loc = torch.as_tensor(lay.mask[r0:r0 + lay.rloc], device=K_loc.device)
    K_loc.neg_()
    pad_cols = np.nonzero(~lay.mask)[0]
    if pad_cols.size:
        K_loc.index_fill_(1, torch.as_tensor(pad_cols, device=K_loc.device), 0.0)
        K_loc.index_fill_(0, torch.nonzero(~mask_loc)[:, 0], 0.0)
    diag = K_loc.diagonal(offset=r0)
    diag.copy_(torch.where(mask_loc, diag + lam, torch.ones_like(diag)))
    if isinstance(y_std, torch.Tensor):
        y_std = y_std.cpu().numpy()
    y = torch.as_tensor(lay.scatter_vec(np.asarray(y_std, dtype=np.float64)), device=K_loc.device)

    nb = min(NB, lay.n_rows)
    timer = timer or PhaseTimer(K_loc.device)
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
