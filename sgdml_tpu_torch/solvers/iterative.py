"""Iterative solver: Nystrom-preconditioned conjugate gradients, matrix-free.

For training sets whose ``(3NM)^2`` kernel does not fit device memory, the
system

    A alpha = y,    A = -K_asm + lam I   (PSD; alpha returned with the
                                          analytic solver's sign convention
                                          alpha = -A^{-1} y)

is solved matrix-free: the matvec ``A v`` is a prediction pass over all
training points (reference: sgdml/solvers/iterative.py:183-206) through
``predict_from_tables``, so on a GPU every matvec launches the fused (E, F)
kernel.

Preconditioner: a Nystrom low-rank approximation from ``k`` inducing columns
chosen by leverage scores (reference: iterative.py:353-411). With PSD
columns ``C = -K_asm[:, cols]`` and ``W = C[cols, :]``:

    Q = C L_W^{-T}           (L_W = chol(W))
    M v = lam^{-1} (v - F^T (F v)),   F = L^{-1} Q^T,  L = chol(Q^T Q + lam I)

the Woodbury inverse of ``(Q Q^T + lam I)``, positive definite by
construction. Everything is float64: the correction ``(v - F^T F v) / lam``
cancels at ``lam ~ 1e-10``.

This is the single-device f64 route of ``sgdml_tpu.solvers.iterative``, the
one the JAX package takes off the TPU. CG runs in chunks of
:data:`CG_CHUNK_ITERS` iterations whose state stays on the device: where the
JAX package's ``while_loop`` exits early on convergence, a chunk here carries
an ``active`` flag through ``torch.where``; the host reads the flag every
:data:`CG_ACTIVE_READ_ITERS` iterations and the chunk's results once. On
one card those iterations replay CUDA graphs, one a block between two reads
(:class:`_ChunkBlocks`): the JAX package's chunk is one compiled program,
with no host round-trip inside an iteration. Between chunks the host loop
re-measures the true residual, reports progress, checkpoints every ~2
minutes, monitors CG effectiveness and restarts with a stronger
preconditioner (reference: iterative.py:729-804).

``factor_mode='ozaki'`` keeps the factor as an int8 slice stack instead
(:class:`SliceFactor`, ``ops/ozaki.py``): a streamed build in which the
``(n, k)`` f64 column block never exists (:meth:`Iterative.
_build_factor_streamed`), ``factor_slices + 1`` bytes an element instead of
16, so the same memory holds a larger ``k``; its CG matvec starts on the
lowest Ozaki rung of :data:`MV_MM_LADDER` and climbs when the best residual
stagnates. ``'auto'`` keeps the f64 factor on every device, as the JAX
package does off a TPU.

With a ``mesh`` (``parallel/mesh.py``: one process per device) the matvec
is batch-sharded (each rank predicts its shard of the training points, K1
on a GPU, then one all-gather), the f64 factor is column-sharded
(:class:`ShardedFactor`: the build of ``parallel/spmd.py``, or with energy
constraints the one-pass build cut into column shards) and applied with one
all-reduce of ``F v`` and one all-gather of ``v - F^T w``; the slice stack
is column-sharded too (``spmd.ShardedSliceFactor``: each rank streams its
own points' chunks into its block of the stack, ``spmd.
nystrom_factor_sharded_streamed``), with or without energy constraints,
which border it as a replicated f64 block. CG vectors are whole on every
rank, and every decision the host takes from them (a chunk's stop, a
residual replacement, a restart, a wall-clock limit) is taken from rank 0's
numbers (``mesh.agree``), so that no rank leaves a collective that the
others enter.
"""

from __future__ import annotations

import logging
import os
import timeit
import zlib
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import descriptor as desc_ops
from ..ops import ozaki
from ..ops.kernel import assemble_kernel_columns, assemble_kernel_columns_range, assemble_kernel_E_rows
from ..parallel import spmd
from ..parallel.mesh import agree, all_gather_rows, all_reduce_, mesh_device, mesh_info
from ..predict import Tables, predict_from_tables
from ..utils import graphs, profiling
from ..utils.profiling import PhaseTimer
from .analytic import memory_budget

__all__ = ['Iterative', 'MV_MM_LADDER', 'MatvecTables', 'ShardedFactor', 'SliceFactor', 'matvec_tables']

log = logging.getLogger(__name__)

CG_STEPS_HIST_LEN = 100  # window for solver-effectiveness estimate
EFF_RESTART_THRESH = 0  # restart when effectiveness <= this percentage
MAX_NUM_RESTARTS = 6
CHECKPOINT_INTERVAL_S = 2 * 60.0
CG_CHUNK_ITERS = 50  # CG iterations per chunk
# Residual replacement (van der Vorst & Ye, SIAM J. Sci. Comput. 1999): the
# recursive CG residual drifts from the true one b - Ax. Upward drift trips
# the stall detector on a healthy solve; downward drift declares false
# convergence. One exact matvec per chunk measures the truth; past this
# relative gap the recursion is re-anchored at it (r, z, rz replaced; x and
# the search direction p kept).
RESID_REPLACE_DRIFT = 0.02
# Budgeted stagnation policy at the inducing-point cap. There the residual
# NORM oscillates while the A-norm error that CG minimizes keeps falling, so
# stalls only count once the BEST residual has stagnated for an adaptive
# window (2x the largest gap between bests, floored at
# RESEED_STAGNATION_ITERS). A stagnation event re-seeds CG from the best
# iterate AT MOST ONCE per best (CG is deterministic: a second re-seed would
# replay the same trajectory); after that the solve grinds uninterrupted and
# gives up only after DEEP_STAGNATION_BUDGET_FRAC of the wall budget (or,
# without one, DEEP_STAGNATION_ITERS_FRAC of the iterations so far) passes
# without a new best. Growth restarts below the cap keep the reference's
# MAX_NUM_RESTARTS bound.
RESEED_STAGNATION_ITERS = 500
DEEP_STAGNATION_BUDGET_FRAC = 0.25
DEEP_STAGNATION_ITERS_FRAC = 0.25
# A converged chunk stops at the next multiple of this many iterations: one
# host read of the ``active`` flag each time, in place of one an iteration.
CG_ACTIVE_READ_ITERS = 10
# CG matvec precision ladder of the slice-stack route. An inexact matvec
# stalls CG at a residual floor ~ ||b|| eps_mv kappa (inexact-Krylov
# stagnation); when a re-seed cycle at the cap goes barren the solver climbs
# one rung (+2 slices, 4096x lower truncation) instead of giving up;
# 'native' (K1 on a card) is the last rung.
MV_MM_LADDER = ('ozaki', 'ozaki8', 'ozaki10', 'native')

_SOLVE_CHUNK = 8192  # columns per triangular-solve / Gram chunk
# The streamed slice-stack build's plan (Iterative.max_n_inducing_pts) gives
# the stack 72% of the budget. Beside the stack the build holds its two
# (kcols, kcols) f64 Cholesky factors at once (L_W and L, through the F
# sweep): k keeps them within the rest.
_BLOCK_SHARE, _BLOCKS_BESIDE_STACK = 0.28, 2


# ---------------------------------------------------------------------------
# Device-side pieces
# ---------------------------------------------------------------------------


class MatvecTables(NamedTuple):
    """What a matvec needs that does not depend on ``v``: the training
    descriptors on the query side, and the permuted table rows centered on
    their mean with their squared norms (the parts of ``predict.Tables``
    that ``center_tables`` would recompute in every matvec)."""

    X: torch.Tensor  # (M, D) training descriptors (queries)
    Jc: torch.Tensor  # (M, D, 3) compressed training Jacobians
    dp: torch.Tensor  # (P, D) descriptor permutations, int64
    mu: torch.Tensor  # (D,) table mean
    Xt: torch.Tensor  # (M P, D) permuted table rows minus mu
    xt_sq: torch.Tensor  # (M P,) |Xt - mu|^2
    mesh: object = None  # a DeviceMesh: the queries are sharded over it


def matvec_tables(X, Jc, desc_perms, mesh=None) -> MatvecTables:
    """Build the ``v``-free part of the matvec once per solve, with the same
    operations as ``predict.center_tables``. With a ``mesh`` each matvec
    predicts this rank's shard of the training points
    (``spmd.predict_sharded``)."""
    dp = torch.as_tensor(np.asarray(desc_perms), dtype=torch.int64, device=X.device)
    Xt = X[:, dp].reshape(-1, X.shape[1])
    mu = torch.mean(Xt, dim=0)
    Xt = (Xt - mu[None, :]).contiguous()
    return MatvecTables(X, Jc, dp, mu, Xt, torch.sum(Xt * Xt, dim=1), mesh)


def _matvec_A(v, tab: MatvecTables, sig, lam, *, n_atoms, use_E_cstr, mm='native'):
    """``A v = -predict_train(v) + lam v`` on ``v``'s device: the table side
    from ``v`` (``JA`` and ``<xt, ja>``), then one ``predict_from_tables``
    over all training points at the matvec rung ``mm`` (on a mesh over this
    rank's shard of them, ``spmd.predict_sharded``)."""
    m, dim_d = tab.X.shape
    if use_E_cstr:
        v_F, v_E = v[:-m], v[-m:]
    else:
        v_F, v_E = v, None
    JA = desc_ops.jac_dot_vec(tab.Jc, v_F.reshape(m, 3 * n_atoms), n_atoms)
    JA = JA[:, tab.dp].reshape(-1, dim_d).contiguous()
    aE = None if v_E is None else torch.repeat_interleave(v_E, tab.dp.shape[0])
    tables = Tables(tab.mu, tab.Xt, JA, tab.xt_sq, torch.sum(tab.Xt * JA, dim=1))
    if tab.mesh is None:
        E, F = predict_from_tables(tab.X, tab.Jc, tables, aE, sig, 1.0, 0.0, n_atoms=n_atoms, mm=mm)
    else:
        E, F = spmd.predict_sharded(tab.X, tab.Jc, tables, sig, 1.0, 0.0, n_atoms, tab.mesh, alphas_E_lin=aE, mm=mm)
    pred = torch.cat([F.reshape(-1), -E]) if use_E_cstr else F.reshape(-1)
    return -pred + lam * v


def _factor_apply(F, v):
    """``v - F^T (F v)``: two matrix-vector products over the ``(k, n)``
    factor."""
    return v - torch.mv(F.T, torch.mv(F, v))


class ShardedFactor(NamedTuple):
    """The f64 Woodbury factor column-sharded over a mesh: rank ``g`` holds
    columns ``[g nloc, (g + 1) nloc)`` of ``F`` (the ``(k, n)`` factor, its
    columns zero-padded to ``nloc`` times the ranks)."""

    F: torch.Tensor  # (k, nloc)
    info: object  # parallel.mesh.MeshInfo


def _factor_apply_sharded(F: ShardedFactor, v):
    """``v - F^T (F v)`` for a whole ``v``: ``F v`` by one all-reduce of the
    ranks' partial products, ``F^T w`` on each rank's columns, one
    all-gather."""
    n, nloc = v.shape[0], F.F.shape[1]
    r0 = F.info.rank * nloc
    v_loc = v[r0:r0 + nloc]
    if v_loc.shape[0] < nloc:
        v_loc = torch.nn.functional.pad(v_loc, (0, nloc - v_loc.shape[0]))
    w = all_reduce_(torch.mv(F.F, v_loc), F.info)
    return all_gather_rows(v_loc - torch.mv(F.F.T, w), F.info)[:n]


def _flag(t, mesh) -> bool:
    """A device boolean read on the host (a ``graphs.host_read``): rank 0's
    reading on a mesh."""
    if mesh is None:
        return graphs.host_read(lambda: bool(t))
    return graphs.host_read(lambda: bool(agree([float(bool(t))], mesh_info(mesh))[0]))


class SliceFactor(NamedTuple):
    """The Woodbury factor ``F (k, n)`` as an int8 slice stack.

    Column chunk ``c`` of ``width`` columns was sliced with its own global
    scale ``sig[c]`` (``ozaki.split_global_int8``) and sits at columns
    ``[c * stride, c * stride + width)`` of ``s``, with ``stride`` the width
    rounded up to 16 and zero columns after it, and its ``rows`` real rows
    are padded with zero rows to a multiple of 16: so every product of the
    apply reads the stack in place (``ozaki._int8_mm``). Zeros add nothing.
    """

    s: torch.Tensor  # (S, rows padded, n_chunks * stride) int8
    sig: torch.Tensor  # (n_chunks,) float32
    width: int
    rows: int


def _factor_ncols(F):
    """Column count of a factor in either representation (the dense ``(k,
    n)`` f64 factor, or the slice stack, whose last chunk may run past
    ``n``): the width a vector is padded to."""
    return F.sig.shape[0] * F.width if isinstance(F, SliceFactor) else F.shape[1]


def _stack_matvec(F: SliceFactor, v):
    """``F v`` from the slice stack for ``v`` of :func:`_factor_ncols`
    entries, over the stack's padded rows (the padding rows give 0): exact
    int8 level sums recombined in f64 (``ozaki.matvec_sliced_long``)."""
    n_ch = F.sig.shape[0]
    stride = F.s.shape[2] // n_ch
    vs = v.new_zeros((n_ch, stride))
    vs[:, :F.width] = v.view(n_ch, F.width)
    return ozaki.matvec_sliced_long(F.s, F.sig, vs.view(-1), chunk=stride)


def _stack_matvec_t(F: SliceFactor, w):
    """``F^T w`` from the slice stack for ``w`` over its padded rows
    (``ozaki.matvec_sliced_long_t``): :func:`_factor_ncols` entries."""
    n_ch = F.sig.shape[0]
    stride = F.s.shape[2] // n_ch
    u = ozaki.matvec_sliced_long_t(F.s, F.sig, w, chunk=stride)
    return u.view(n_ch, stride)[:, :F.width].reshape(-1)


def _gram_apply(F: SliceFactor, v):
    """``F^T (F v)`` from the slice stack (:func:`_stack_matvec` and
    :func:`_stack_matvec_t`)."""
    return _stack_matvec_t(F, _stack_matvec(F, v))


def _factor_apply_ozaki(F: SliceFactor, v):
    """``v - F^T (F v)`` from the slice stack (see :func:`_gram_apply`)."""
    return v - _gram_apply(F, v)


def _precond(F, v, lam):
    """``M v = (v - F^T (F v)) / lam`` for either factor; a slice stack pads
    ``v`` to its width and cuts the result back."""
    if isinstance(F, SliceFactor):
        vp = torch.nn.functional.pad(v, (0, _factor_ncols(F) - v.shape[0]))
        return _factor_apply_ozaki(F, vp)[:v.shape[0]] / lam
    if isinstance(F, ShardedFactor):
        return _factor_apply_sharded(F, v) / lam
    if isinstance(F, spmd.ShardedSliceFactor):
        if F.F_E is not None:  # the bordered apply pads the force part itself
            return spmd.ozaki_factor_apply_sharded_bordered(F, v) / lam
        vp = torch.nn.functional.pad(v, (0, F.info.size * _factor_ncols(F.F) - v.shape[0]))
        return spmd.ozaki_factor_apply_sharded(F, vp)[:v.shape[0]] / lam
    return _factor_apply(F, v) / lam


def _pcg_step(x, r, z, p, rz, active, F, tab, sig, lam, thresh, *, n_atoms, use_E_cstr, mm):
    """One masked PCG iteration: the new ``(x, r, z, p, rz)``, each the old
    one where ``active`` is False; the residual norm for the history (0 where
    inactive); the PSD guard's trip (only where active); and ``active`` for
    the next iteration."""
    Ap = _matvec_A(p, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr, mm=mm)
    alpha = rz / (p @ Ap)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    z_new = _precond(F, r_new, lam)
    rz_new = r_new @ z_new
    # PSD guard: at large k the Woodbury correction cancels to ~lam ||v||
    # and f64 rounding can push r.z slightly negative. Fall back to an
    # unpreconditioned step AND restart the search direction (beta = 0).
    bad = ~(rz_new > 0) | ~torch.isfinite(rz_new)
    z_new = torch.where(bad, r_new, z_new)
    rz_new = torch.where(bad, r_new @ r_new, rz_new)
    beta = torch.where(bad, 0.0, rz_new / rz)
    p_new = z_new + beta * p
    r_norm = torch.linalg.vector_norm(r_new)
    return (torch.where(active, x_new, x), torch.where(active, r_new, r), torch.where(active, z_new, z),
            torch.where(active, p_new, p), torch.where(active, rz_new, rz), torch.where(active, r_norm, 0.0),
            bad & active, active & (r_norm > thresh))


def _pcg_chunk(state, F, tab, sig, lam, b_norm, rtol, *, n_atoms, use_E_cstr, chunk_iters, mm='native'):
    """``chunk_iters`` PCG iterations on the device, with no host read.

    state: ``(x, r, z, p, rz, it, hist, n_bad)``. ``hist`` records the
    residual norm of each step in this chunk (for the host's effectiveness
    monitor); ``n_bad`` counts PSD-guard trips. Iteration ``i`` commits only
    while ``active`` (still above ``rtol * b_norm`` and fewer than
    ``chunk_iters`` steps), so ``it`` counts exactly the steps a loop that
    exits on convergence would take. Every :data:`CG_ACTIVE_READ_ITERS`
    iterations the host reads ``active`` and ends an inactive chunk, so a
    converged solve runs at most that many idle iterations. ``F`` is either
    factor; ``mm`` is the matvec rung.

    The eager loop: the mesh's chunk, and the private oracle of
    :class:`_ChunkBlocks`, which replays the same iterations from CUDA
    graphs on one card.
    """
    x, r, z, p, rz, _, hist, _ = state
    hist = torch.zeros_like(hist)
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    n_bad = torch.zeros((), dtype=torch.int64, device=x.device)
    thresh = rtol * b_norm
    active = torch.linalg.vector_norm(r) > thresh
    for i in range(chunk_iters):
        if i % CG_ACTIVE_READ_ITERS == 0 and not _flag(active, tab.mesh):
            break
        x, r, z, p, rz, hist[i], bad, going = _pcg_step(x, r, z, p, rz, active, F, tab, sig, lam, thresh,
                                                        n_atoms=n_atoms, use_E_cstr=use_E_cstr, mm=mm)
        n_bad += bad
        it += active
        active = going
    return x, r, z, p, rz, it, hist, n_bad


class _ChunkBlocks:
    """:func:`_pcg_chunk` on one device as a :class:`graphs.Loop`: blocks of
    :data:`CG_ACTIVE_READ_ITERS` masked iterations over static state, each
    block one CUDA graph replay with ``graph`` (a card), run eagerly
    without. The JAX package's chunk is one compiled ``while_loop``
    (``sgdml_tpu/solvers/iterative.py:_pcg_chunk_jit``); here the host reads
    ``active`` between blocks, where the eager loop reads it, so every
    iteration, count and bit is the eager loop's.

    The state is ``(x, r, z, p, rz, active, it, n_bad, hist, slot)``:
    ``hist`` is written at the device-side index ``slot``, which each
    iteration advances, so one graph serves a block at every offset of the
    chunk. The graphs read ``F``, ``tab`` and the rung ``mm`` by address:
    a solve drops its blocks wherever one of them changes.
    """

    def __init__(self, F, tab, sig, lam, b_norm, rtol, *, n, n_atoms, use_E_cstr, mm, graph):
        self.thresh = thresh = rtol * b_norm

        def step(state):
            x, r, z, p, rz, active, it, n_bad, hist, slot = state
            x, r, z, p, rz, h, bad, going = _pcg_step(x, r, z, p, rz, active, F, tab, sig, lam, thresh,
                                                      n_atoms=n_atoms, use_E_cstr=use_E_cstr, mm=mm)
            hist.index_copy_(0, slot, h[None])
            slot.add_(1)
            n_bad += bad
            it += active
            return x, r, z, p, rz, going, it, n_bad, hist, slot

        vec = tab.X.new_empty(n)
        flag, count = torch.empty((), dtype=torch.bool, device=vec.device), vec.new_empty((), dtype=torch.int64)
        like = (vec,) * 4 + (vec.new_empty(()), flag, count, count, vec.new_empty(CG_CHUNK_ITERS),
                             vec.new_empty(1, dtype=torch.int64))
        self.loop = graphs.Loop(step, like, CG_ACTIVE_READ_ITERS, graph)

    def __call__(self, state, chunk_iters):
        """One chunk from ``state`` (as :func:`_pcg_chunk` takes and returns
        it); the results are copies, never the static tensors."""
        x, r, z, p, rz, _, hist, _ = state
        zero = torch.zeros((), dtype=torch.int64, device=x.device)
        start = (x, r, z, p, rz, torch.linalg.vector_norm(r) > self.thresh, zero, zero, torch.zeros_like(hist),
                 zero[None])
        x, r, z, p, rz, _, it, n_bad, hist, _ = self.loop(start, chunk_iters, lambda s: bool(s[5]))
        return x, r, z, p, rz, it, hist, n_bad


def _chol_reg(M, reg):
    """Cholesky factor of a (k, k) SPD block with ``reg`` added to its
    diagonal in place (the callers own ``M``; at k ~ 27,000 columns each
    (k, k) copy is 5.8 GB), and whether it holds (``info == 0`` and a finite
    factor; one host read)."""
    M.diagonal().add_(reg)
    L, info = torch.linalg.cholesky_ex(M)
    return L, bool((info == 0) & torch.isfinite(L).all())


def _solve_chunk(L, B_chunk, gram):
    """One (k, chunk) triangular solve ``Y = L^{-1} B``; ``Y Y^T`` is added
    to ``gram`` in place."""
    Y = torch.linalg.solve_triangular(L, B_chunk, upper=False)
    gram.addmm_(Y, Y.T)
    return Y


def _nystrom_factor_from_cols(C_psd, cols, lam, reg_w, reg_i):
    """Build the Woodbury factor ``F (k, n)`` from PSD kernel columns.

    C_psd: ``(n, k)`` PSD columns on the device. cols: ``(k,)`` host indices
    of the inducing columns. reg_w / reg_i: diagonal regularization added
    before the two Cholesky stages (the caller's ladder retries larger values
    on failure). Returns ``(F, lev_scores (n,), ok)``.

    Two passes over column chunks. Pass 1 whitens each chunk, ``Y = L_W^{-1}
    C_c^T``, and accumulates the Gram ``Y Y^T``; the columns are released
    after it (the caller passes them in the call expression, so no other
    reference holds them). Pass 2 writes ``F_c = L^{-1} Y_c`` into the
    preallocated factor and releases each ``Y_c`` as it goes, so the peak is
    the columns plus the ``Y`` chunks, 16 bytes per factor element, and at
    most three (k, k) blocks (the Gram, its factor and ``L_W``).
    """
    n, k = C_psd.shape
    chunk = min(_SOLVE_CHUNK, n)

    W = C_psd[torch.as_tensor(np.asarray(cols), dtype=torch.int64, device=C_psd.device)]
    Lw, ok_w = _chol_reg(W, reg_w)
    del W
    if not ok_w:
        return None, None, False

    gram = torch.zeros((k, k), dtype=C_psd.dtype, device=C_psd.device)
    qt_chunks = [_solve_chunk(Lw, C_psd[c0:c0 + chunk].T, gram) for c0 in range(0, n, chunk)]
    del C_psd, Lw

    L, ok_i = _chol_reg(gram, lam + reg_i)
    del gram
    if not ok_i:
        return None, None, False

    F = torch.empty((k, n), dtype=L.dtype, device=L.device)
    lev_scores = torch.empty(n, dtype=L.dtype, device=L.device)
    qt_chunks.reverse()
    for c0 in range(0, n, chunk):
        Fc = torch.linalg.solve_triangular(L, qt_chunks.pop(), upper=False)
        F[:, c0:c0 + chunk] = Fc
        lev_scores[c0:c0 + chunk] = torch.sum(Fc * Fc, dim=0)
    return F, lev_scores, True


# -- the streamed slice-stack build (sgdml_tpu/solvers/iterative.py:556-803) --


def _gram_accum_y(gram, Lw, C):
    """``gram += Y Y^T`` for one assembly chunk, ``Y = L_W^{-1} C^T``, the
    Gram as an 8-slice Ozaki product. The triangular solve whitens the chunk
    BEFORE the int8 truncation, so the 48-bit error stays relative to the
    factor's own scale instead of being amplified by cond(W)."""
    Y = torch.linalg.solve_triangular(Lw, C.T, upper=False)
    hi = Y.to(torch.float32)
    lo = (Y - hi.to(torch.float64)).to(torch.float32)
    del Y
    gram.add_(ozaki.ozaki_gemm_nt(hi, hi, lo_a=lo, lo_b=lo, n_slices=8))


def _f_chunk_streamed(Lw, L, C, ns):
    """One factor chunk ``F_c = L^{-1} L_W^{-1} C_c^T`` by two triangular
    solves, its leverage scores and its int8 slices: ``(lev, slices,
    scale)``; the f64 chunk dies here."""
    F = torch.linalg.solve_triangular(L, torch.linalg.solve_triangular(Lw, C.T, upper=False), upper=False)
    return (torch.sum(F * F, dim=0),) + ozaki.split_global_int8(F, n_slices=ns)


def _renorm_sliced_factor(F: SliceFactor, n_slices: int, iters: int = 40):
    """Scale the slice stack so the represented factor has spectral norm
    strictly below 1, keeping the Woodbury apply ``v - F^T (F v)`` PSD.

    The exact factor has ``||F||_2^2 = d_max / (d_max + lam) < 1``, but at
    small lam the margin (~lam / d_max) is far below the truncation noise of
    fewer than 8 slices, so the represented ``I - F^T F`` can go indefinite.
    The represented norm is measured by power iteration on the same sliced
    products CG uses (seeded start, as the JAX package's), and the chunk
    scales shrink so it lands at ``1 - eps`` with ``eps`` at the
    truncation-noise floor.
    """
    ncols = _factor_ncols(F)
    v = torch.as_tensor(np.random.default_rng(12345).standard_normal(ncols), device=F.s.device)
    v = v / torch.linalg.vector_norm(v)
    nrm = None
    for _ in range(iters):
        u = _gram_apply(F, v)
        nrm = torch.linalg.vector_norm(u)
        v = u / torch.clamp_min(nrm, 1e-300)
    sigma_sq = float(nrm)  # ~ lambda_max(F^T F) from the Rayleigh limit
    eps = min(max(1e-9, 8.0 * np.sqrt(float(F.rows) * ncols) * 2.0 ** (-ozaki.Q_BITS * n_slices)), 1e-3)
    if sigma_sq <= (1.0 - eps) ** 2:
        return F
    scale = (1.0 - eps) / np.sqrt(sigma_sq)
    log.debug('Renormalizing slice-stack factor: represented ||F||=%.3e -> %.3e (%d slices).',
              np.sqrt(sigma_sq), 1.0 - eps, n_slices)
    return F._replace(sig=F.sig * torch.tensor(scale, dtype=F.sig.dtype, device=F.sig.device))


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class Iterative:
    """Nystrom-preconditioned CG on one device, in float64.

    Parameters
    ----------
    gdml_train: the calling trainer (its ``create_model`` makes checkpoints;
        its ``device`` is the default device).
    callback: optional progress callback ``(iters, max_iters, disp_str=...,
        sec_disp_str=...)``.
    max_memory: budget in GB for the inducing-point count; None takes
        ``memory_budget`` of the device at solve time (12 GB on the CPU).
    mesh: a ``DeviceMesh`` (``parallel/mesh.py``) to solve over, every rank
        calling :meth:`solve` alike; the solve runs on this rank's device of
        the mesh. None: one device.
    factor_mode: ``'f64'`` (the dense f64 factor), ``'ozaki'`` (the int8
        slice stack of the streamed build, its matvec on the Ozaki rungs of
        :data:`MV_MM_LADDER`) or ``'auto'``, which is ``'f64'`` on every
        device (the JAX package picks the stack on a TPU only).
    factor_slices: int8 slices an element of the slice stack (3-10), or
        ``'auto'``: the count whose budget affords the largest ``k``
        (:meth:`resolve_factor_slices`). None reads ``SGDML_FACTOR_SLICES``,
        else ``'auto'``.
    seed: explicit solver seed; None derives one from the task's training
        split, so identical tasks give identical inducing sets.
    device: where the solve runs; None takes the mesh's device, else the
        trainer's, else the GPU.

    After :meth:`solve`, ``timer.durations`` holds the seconds of
    ``'leverage scores'``, ``'factor'`` and ``'cg'``, each ended by a device
    synchronization, and on a card ``'cg capture'``: the host seconds of the
    CG graphs' captures, which ``'cg'`` includes.

    On one CUDA device each CG chunk replays CUDA graphs of
    :data:`CG_ACTIVE_READ_ITERS` iterations (:class:`_ChunkBlocks`), as the
    JAX package runs its chunk as one compiled loop; on a mesh and on the
    CPU the chunk is the eager loop :func:`_pcg_chunk`, which gives the same
    bits.
    """

    def __init__(self, gdml_train=None, callback=None, max_memory: float | None = None,
                 mesh=None, factor_mode: str = 'auto', factor_slices: int | None = None,
                 seed: int | None = None, *, device=None):
        if factor_mode not in ('auto', 'f64', 'ozaki'):
            raise ValueError("factor_mode must be 'auto', 'f64' or 'ozaki', got %r" % (factor_mode,))
        self.mesh = mesh
        self._info = None if mesh is None else mesh_info(mesh)
        if factor_slices is None:
            env = os.environ.get('SGDML_FACTOR_SLICES')
            factor_slices = int(env) if env else 'auto'
        if factor_slices != 'auto' and not 3 <= factor_slices <= 10:
            raise ValueError("factor_slices must be in [3, 10] or 'auto'")
        if mesh is not None:
            device = mesh_device(self._info, device)
        elif device is None:
            device = getattr(gdml_train, 'device', 'cuda')
        self.gdml_train = gdml_train
        self.callback = callback
        self._max_memory = max_memory
        self.factor_mode = factor_mode
        self.factor_slices = factor_slices
        # The resolution of 'auto' for the current solve (set by the plan;
        # the 8-slice default covers a direct _build_factor call).
        self._auto_ns = 8
        self.seed = seed
        self.device = resolve_device(device)
        self.timer = PhaseTimer(self.device)
        # On one card the CG chunks replay CUDA graphs (_ChunkBlocks); with
        # False they run the eager loop (the mesh's, and chip_smoke.py's
        # private oracle); True off a card runs the blocks eagerly.
        self._graphs = self.device.type == 'cuda' and mesh is None

    def _ns(self) -> int:
        """Slice count of the current solve's stack."""
        return self._auto_ns if self.factor_slices == 'auto' else self.factor_slices

    def _use_ozaki_factor(self) -> bool:
        return self.factor_mode == 'ozaki'

    def _budget(self) -> float:
        """Bytes of device memory for the factor; on a mesh rank 0's, so that
        every rank takes the same k."""
        budget = memory_budget(self.device) if self._max_memory is None else self._max_memory * 1024**3
        return budget if self._info is None else float(agree([budget], self._info)[0])

    def _n_dev(self) -> int:
        return 1 if self._info is None else self._info.size

    # -- preconditioner ----------------------------------------------------

    def _build_factor(self, X, Jc, dperms, sig, lam, col_idxs, n_atoms, use_E_cstr):
        """Assemble PSD columns on the device and build the Woodbury factor,
        with an escalating regularization ladder (reference behavior:
        iterative.py:414-471): the slice stack by the streamed build in
        ``'ozaki'`` mode, on a mesh the sharded streamed build (its energy
        rows as the replicated border ``F_E``; ``sgdml_tpu/solvers/
        iterative.py:921-943``). Returns ``(F, host leverage scores)``."""
        col_idxs = np.asarray(col_idxs, dtype=np.int64)
        if self._use_ozaki_factor() and self.mesh is not None:
            C_E = None
            if use_E_cstr:
                C_E = assemble_kernel_E_rows(X, Jc, dperms, sig, n_atoms, col_idxs).neg_()
            return spmd.nystrom_factor_sharded_streamed(X, Jc, dperms, sig, lam, col_idxs, n_atoms, self.mesh,
                                                        n_slices=self._ns(), C_E_psd=C_E)
        if self._use_ozaki_factor():
            return self._build_factor_streamed(X, Jc, dperms, sig, lam, col_idxs, n_atoms, use_E_cstr)
        if self.mesh is not None and not use_E_cstr:
            return self._build_factor_sharded(X, Jc, dperms, sig, lam, col_idxs, n_atoms)
        for reg in [0.0] + list(10.0 ** np.arange(-16, 2)):
            # The columns are made and negated in place inside the call
            # expression, so the factor build holds their only reference; on
            # the rare retry they are simply re-assembled.
            F, lev, ok = _nystrom_factor_from_cols(
                assemble_kernel_columns(X, Jc, dperms, sig, n_atoms, col_idxs, use_E_cstr=use_E_cstr).neg_(),
                col_idxs, lam, reg, reg,
            )
            if ok:
                if reg > 0:
                    log.debug('Nystrom factor needed regularization %g.', reg)
                if self.mesh is not None:
                    # Energy constraints on a mesh: the one-pass factor, made
                    # alike on every rank, cut into column shards.
                    F = self._shard_factor(F)
                return F, lev.cpu().numpy()
        raise RuntimeError(
            'Failed to factorize the Nystrom preconditioner despite strong '
            'regularization. Try a larger sigma.'
        )

    def _shard_factor(self, F) -> ShardedFactor:
        """This rank's column shard of a whole ``(k, n)`` factor: its
        ``ceil(n / ranks)`` columns, cut first and zero-padded where the
        factor runs out (the padded columns drop out of the apply), so that
        no second whole copy is made."""
        info = self._info
        nloc = -(-F.shape[1] // info.size)
        part = F[:, info.rank * nloc:(info.rank + 1) * nloc]
        F_loc = F.new_zeros((F.shape[0], nloc))
        F_loc[:, :part.shape[1]] = part
        return ShardedFactor(F_loc, info)

    def _build_factor_sharded(self, X, Jc, dperms, sig, lam, col_idxs, n_atoms):
        """The mesh's f64 factor (``sgdml_tpu/solvers/iterative.py:945-967``):
        row-sharded columns and the sharded build of ``parallel/spmd.py``, in
        the regularization ladder. Returns ``(ShardedFactor, host leverage
        scores over the padded force axis)``."""
        for reg in [0.0] + list(10.0 ** np.arange(-16, 2)):
            # The columns are made and negated in the call expression, so the
            # build holds their only reference.
            F, lev, ok = spmd.nystrom_factor_sharded(
                spmd.assemble_kernel_columns_sharded(X, Jc, dperms, sig, n_atoms, col_idxs, self.mesh).neg_(),
                col_idxs, lam, reg, reg, self.mesh)
            if ok:
                if reg > 0:
                    log.debug('Nystrom factor needed regularization %g.', reg)
                return ShardedFactor(F, self._info), lev.cpu().numpy()
        raise RuntimeError(
            'Failed to factorize the Nystrom preconditioner despite strong '
            'regularization. Try a larger sigma.'
        )

    def _build_factor_streamed(self, X, Jc, dperms, sig, lam, cols, n_atoms, use_E_cstr=False):
        """The int8 slice-stack factor by three assembly sweeps over row
        chunks; the ``(n, k)`` f64 column block never exists
        (``sgdml_tpu/solvers/iterative.py:1008-1183``).

        1. W sweep: the inducing rows ``W = C[cols]``.
        2. Gram sweep: per chunk ``Y = L_W^{-1} C^T`` and the 8-slice Ozaki
           Gram ``Y Y^T`` (:func:`_gram_accum_y`).
        3. F sweep: ``F_c = L^{-1} L_W^{-1} C_c^T`` per chunk, sliced into
           the stack, which is allocated once (zeros) and written in place.

        ``chol(W)`` and ``chol(gram + lam I)`` are ``cholesky_ex`` on the
        device (the JAX package takes them to the host; at ``kcols`` ~ 15,000
        and more the host copies and the host factorization are what a card
        avoids), in the regularization ladder of the f64 build; a failed
        Gram stage re-sweeps with the stronger ``L_W``. The Ozaki Gram is
        exactly symmetric and ``cholesky_ex`` reads its lower triangle, so
        the JAX package's symmetrization changes nothing and is left out.

        With ``use_E_cstr`` the force sweeps take a chunk that divides M
        exactly and the ``(M, k)`` energy rows (``assemble_kernel_E_rows``)
        join the Gram and fill the stack's tail chunks, so the ``[F | E]``
        vector stays aligned with the stack's columns. Returns
        ``(SliceFactor, host leverage scores)``; the seconds of each sweep
        are logged.
        """
        m = X.shape[0]
        dim_i = 3 * n_atoms
        n = m * dim_i + (m if use_E_cstr else 0)
        kcols = len(cols)
        pt_ch = max(1, _SOLVE_CHUNK // dim_i)
        if use_E_cstr:
            pt_ch = spmd._largest_divisor(m, pt_ch)
        n_ch = -(-m // pt_ch)
        rows_ch = pt_ch * dim_i
        tail = []  # the energy rows' chunks
        if use_E_cstr:
            C_E = assemble_kernel_E_rows(X, Jc, dperms, sig, n_atoms, cols).neg_()
            C_E = torch.nn.functional.pad(C_E, (0, 0, 0, -(-m // rows_ch) * rows_ch - m))
            tail = list(C_E.split(rows_ch))

        def chunk(c):
            if c >= n_ch:
                return tail[c - n_ch]
            return assemble_kernel_columns_range(X, Jc, dperms, sig, n_atoms, cols, c * pt_ch, pt_ch, m).neg_()

        timer = PhaseTimer(self.device)

        def w_sweep():
            W = torch.empty((kcols, kcols), dtype=X.dtype, device=X.device)
            for c in range(n_ch):
                sel = np.nonzero((cols >= c * rows_ch) & (cols < (c + 1) * rows_ch))[0]
                if sel.size:
                    rows = torch.as_tensor(cols[sel] - c * rows_ch, device=X.device)
                    W[torch.as_tensor(sel, device=X.device)] = chunk(c)[rows]
            return W

        W = None
        for reg in [0.0] + list(10.0 ** np.arange(-16, 2)):
            if W is None:
                with timer.phase('W sweep'):
                    W = w_sweep()
            Lw, ok = _chol_reg(W.clone(), reg)
            if not ok:
                continue
            with timer.phase('Gram sweep'):
                gram = torch.zeros((kcols, kcols), dtype=X.dtype, device=X.device)
                for c in range(n_ch + len(tail)):
                    _gram_accum_y(gram, Lw, chunk(c))
            L, ok = _chol_reg(gram, lam + reg)
            del gram
            if ok:
                if reg > 0:
                    log.debug('Nystrom factor needed regularization %g.', reg)
                break
            log.debug('Nystrom gram stage failed at reg=%g; re-sweeping with stronger regularization.', reg)
        else:
            raise RuntimeError(
                'Failed to factorize the Nystrom preconditioner despite strong '
                'regularization. Try a larger sigma.'
            )
        del W

        ns = self._ns()
        n_chunks, stride = n_ch + len(tail), -(-rows_ch // 16) * 16
        with timer.phase('F sweep'):
            sF = torch.zeros((ns, -(-kcols // 16) * 16, n_chunks * stride), dtype=torch.int8, device=X.device)
            sigs, levs = [], []
            for c in range(n_chunks):
                lev_c, s_c, sig_c = _f_chunk_streamed(Lw, L, chunk(c), ns)
                sF[:, :kcols, c * stride:c * stride + rows_ch] = s_c
                sigs.append(sig_c)
                levs.append(lev_c)
            del Lw, L, tail
            F = SliceFactor(sF, torch.stack(sigs), rows_ch, kcols)
            lev_scores = torch.cat(levs)[:n].cpu().numpy()
        if ns < 8:
            with timer.phase('renormalization'):
                F = _renorm_sliced_factor(F, ns)
        log.info('Streamed slice-stack factor (%d slices, k=%d columns, n=%d, stack %.3f GB): W sweep %.3f s, '
                 'Gram sweep %.3f s, F sweep %.3f s, renormalization %.3f s.', ns, kcols, n, sF.numel() / 1e9,
                 timer.durations['W sweep'], timer.durations['Gram sweep'], timer.durations['F sweep'],
                 timer.durations.get('renormalization', 0.0))
        return F, lev_scores

    def _lev_scores(self, X, Jc, dperms, sig, lam, n_inducing_pts, n_atoms, use_E_cstr, rng=None):
        """Approximate ridge leverage scores from a random column subset
        (reference: iterative.py:353-399). Columns are sampled from the force
        block; the scores cover all rows of the (extended) system."""
        m = X.shape[0]
        dim_i = 3 * n_atoms
        dim_m = dim_i * min(n_inducing_pts, 10)
        rng = np.random.default_rng(rng)
        idxs = np.sort(rng.choice(m * dim_i, dim_m, replace=False))
        _, lev = self._build_factor(X, Jc, dperms, sig, lam, idxs, n_atoms, use_E_cstr=use_E_cstr)
        return lev

    @staticmethod
    def inducing_pts_from_lev_scores(lev_scores, n, rng=None):
        """Leverage-weighted column sample (reference: iterative.py:401),
        from an explicit generator (or seed), as the JAX package draws it."""
        rng = np.random.default_rng(rng)
        p = lev_scores / lev_scores.sum()
        idxs = rng.choice(lev_scores.size, n, replace=False, p=p)
        return np.sort(idxs)

    @staticmethod
    def _streamed_caps(n_train, n_atoms, budget, ns, n_dev=1):
        """The caps on k of the streamed ``ns``-slice stack: ``'plan'``, the
        JAX package's (:meth:`max_n_inducing_pts` with ``streamed=True``,
        the stack column-sharded over ``n_dev`` devices); then two bounds on
        ``kcols = 3 N k`` that a 16 GB TPU never met, each a device's (the
        ``(kcols, kcols)`` blocks are replicated, and the transposed apply
        still sums over ``kcols`` rows): ``'blocks'``, the build's two
        ``(kcols, kcols)`` f64 factors within the 28% of the budget beside
        the stack, and ``'int32'``, the transposed apply's exact-int32 sum
        over the stack's rows (``ozaki.matvec_sliced_long_t`` raises past
        ``ozaki.max_contraction_dim(8)``)."""
        dim_i = 3 * n_atoms
        return {
            'plan': min(n_train, Iterative.max_n_inducing_pts(n_train, n_atoms, budget, n_dev=n_dev,
                                                              factor_bytes=ns + 1.0, streamed=True)),
            'blocks': max(1, int(np.sqrt(_BLOCK_SHARE * budget / (_BLOCKS_BESIDE_STACK * 8.0))) // dim_i),
            'int32': max(1, ozaki.max_contraction_dim(8) // dim_i),
        }

    def resolve_factor_slices(self, n_train, n_atoms, budget=None):
        """The slice count whose budget affords the LARGEST inducing-point
        count k; ties go to 8 slices (cleaner spectrum, no renormalization).
        Returns ``(n_slices, k_cap)``. ``budget`` in bytes defaults to the
        solver's (``max_memory``, else ``memory_budget`` of its device); on
        a mesh the stack is column-sharded over its devices.

        On a 16 GB TPU the fresh 8-slice k=11 AT-AT solve extrapolated to
        ~76k CG iterations while the 6-slice k=15 one converged in 14k: fresh
        solves want the largest k the budget affords."""
        budget = self._budget() if budget is None else budget
        best_ns, best_k = 8, -1
        for ns in (8, 6):
            k = min(Iterative._streamed_caps(n_train, n_atoms, budget, ns, self._n_dev()).values())
            if k > best_k:
                best_ns, best_k = ns, k
        return best_ns, best_k

    def _factor_plan(self, n_train, n_atoms, use_E_cstr=False):
        """The inducing-point cap of the solve's factor. The dense f64
        factor: 16 bytes per factor element (the one-pass build's columns and
        ``Y`` chunks, or the factor and the ``Y`` chunks of pass 2), over the
        mesh's ranks where the build is sharded; with energy constraints
        every rank builds the whole one-pass factor, so the plan is one
        device's (the JAX package scales it by the devices there too). The slice
        stack: :meth:`_streamed_caps` at the resolved slice count, over the
        mesh's devices with or without energy constraints (their border is a
        replicated ``(k, M)`` block), with a log line when a bound beyond the
        JAX package's plan sets k. With
        ``max_memory=None`` the budget is what the device has free now, so a
        solve reads it once."""
        budget = self._budget()
        if not self._use_ozaki_factor():
            n_dev = 1 if use_E_cstr else self._n_dev()
            return min(n_train, Iterative.max_n_inducing_pts(n_train, n_atoms, budget, n_dev=n_dev))
        if self.factor_slices == 'auto':
            self._auto_ns, k = self.resolve_factor_slices(n_train, n_atoms, budget)
            if self._auto_ns != 8:
                log.info('Auto-selected the %d-slice preconditioner factor (k cap %d vs %d at 8 slices).',
                         self._auto_ns, k,
                         min(Iterative._streamed_caps(n_train, n_atoms, budget, 8, self._n_dev()).values()))
        caps = Iterative._streamed_caps(n_train, n_atoms, budget, self._ns(), self._n_dev())
        k = min(caps.values())
        if k < caps['plan']:
            why = {'blocks': 'its two (kcols, kcols) f64 factors within %.0f%% of the %.2f GB budget' % (
                       100 * _BLOCK_SHARE, budget / 1e9),
                   'int32': 'kcols <= %d rows for the exact int32 sums of the transposed apply' % (
                       ozaki.max_contraction_dim(8))}
            log.info('Slice-stack factor capped at k=%d inducing points (the plan affords %d): %s.', k,
                     caps['plan'], '; '.join(why[w] for w in ('blocks', 'int32') if caps[w] == k))
        return k

    # -- main solve ----------------------------------------------------------

    def solve(self, task, R_desc, R_d_desc, desc_perms, y, y_std, tol: float = 1e-4,
              save_progr_callback=None, max_seconds: float | None = None):
        """Solve for the regression coefficients.

        R_desc ``(M, D)`` and R_d_desc ``(M, D, 3)`` (tensors or arrays) are
        moved to the solver's device in float64; desc_perms ``(P, D)`` host
        ints; y ``(n,)`` normalized labels.

        Returns ``(alphas, tol, num_iters, resid, train_rmse,
        inducing_pts_idxs, is_conv)`` as the JAX package does, with
        ``alphas`` a float64 tensor on the device.
        """
        n_train, n_atoms = task['R_train'].shape[:2]
        dim_i = 3 * n_atoms
        n = len(y)
        sig = float(np.squeeze(task['sig']))
        lam = float(np.squeeze(task['lam']))
        use_E_cstr = bool(task.get('use_E_cstr', False))
        self.timer = timer = PhaseTimer(self.device)

        # Deterministic solver randomness: seeded from the task's
        # training-split fingerprint unless an explicit seed was given.
        if self.seed is not None:
            rng = np.random.default_rng(self.seed)
        else:
            key = '%s|%d|%.17g|%.17g' % (str(task.get('md5_train', '')), n_train, sig, lam)
            rng = np.random.default_rng(zlib.crc32(key.encode()))

        def tensor(a):
            return torch.as_tensor(a, dtype=torch.float64, device=self.device)

        X, Jc = tensor(R_desc), tensor(R_d_desc)
        dperms = np.asarray(desc_perms)
        tab = matvec_tables(X, Jc, dperms, mesh=self.mesh)
        info = self._info

        def host(values):
            """Host numbers the loop decides from: rank 0's on a mesh."""
            values = np.asarray(values, dtype=np.float64)
            return values if info is None else agree(values, info)

        def A_apply(v):
            return _matvec_A(v, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)

        # Fresh solves start AT the cap (the strongest preconditioner the
        # budget affords); warm starts may begin below it and grow 1.2x per
        # stall-restart, bounded by the same cap.
        grow_cap = n_inducing_pts = self._factor_plan(n_train, n_atoms, use_E_cstr)

        # Warm start (resume / sigma-grid recycling). The E-constrained
        # unknown vector is [force block | M energy block]: both blocks are
        # required, and a size mismatch falls back to a cold start.
        alphas0_F = task.get('alphas0_F')
        num_iters0 = int(task.get('solver_iters', 0))
        x0 = None
        if alphas0_F is not None:
            x0 = -np.asarray(alphas0_F).ravel()
            if use_E_cstr:
                alphas0_E = task.get('alphas0_E')
                x0 = None if alphas0_E is None else np.concatenate([x0, -np.asarray(alphas0_E).ravel()])
            if x0 is not None and x0.size != n:
                log.warning('Ignoring warm-start coefficients of length %d for an n=%d system.', x0.size, n)
                x0 = None
            if x0 is None:
                num_iters0 = 0

        # Inducing points: reuse stored ones when resuming (even below the
        # cap), else leverage scores from a random column probe.
        lev_scores = None
        if 'inducing_pts_idxs' in task and 0 < len(task['inducing_pts_idxs']) // dim_i <= n_inducing_pts:
            inducing_pts_idxs = np.asarray(task['inducing_pts_idxs'])
            n_inducing_pts = len(inducing_pts_idxs) // dim_i
        else:
            log.info('Estimating leverage scores (k=%d inducing points).', n_inducing_pts)
            with timer.phase('leverage scores'):
                lev_scores = self._lev_scores(X, Jc, dperms, sig, lam, n_inducing_pts, n_atoms, use_E_cstr, rng)
            log.info('Leverage scores done in %.1f s.', timer.durations['leverage scores'])
            inducing_pts_idxs = self.inducing_pts_from_lev_scores(
                lev_scores[: n_train * dim_i], n_inducing_pts * dim_i, rng)

        with timer.phase('factor'):
            Fp, lev_scores = self._build_factor(X, Jc, dperms, sig, lam, inducing_pts_idxs, n_atoms, use_E_cstr)
        log.info('Built Nystrom preconditioner (k=%d columns) in %.1f s.', len(inducing_pts_idxs),
                 timer.durations['factor'])

        b = tensor(y)
        b_norm = float(np.linalg.norm(y))
        # The slice-stack route starts its matvec on the lowest rung; a
        # checkpoint resumes at the rung it stored (the climbs are driven by
        # stagnation, so re-climbing on every warm start would replay them).
        mv_mm = 'ozaki' if self._use_ozaki_factor() else 'native'
        if str(task.get('solver_mv_mm', '')) in MV_MM_LADDER:
            mv_mm = str(task['solver_mv_mm'])

        def precond_z(r, F):
            return _precond(F, r, lam)

        def init_state(x_init, F):
            x = tensor(x_init) if x_init is not None else torch.zeros(n, dtype=torch.float64, device=self.device)
            r = b - A_apply(x)
            z = precond_z(r, F)
            rz = r @ z
            if not _flag(rz > 0, self.mesh):  # PSD guard (see _pcg_chunk)
                z = r
                rz = r @ r
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            return (x, r, z, z, rz, zero, torch.zeros(CG_CHUNK_ITERS, dtype=torch.float64, device=self.device),
                    zero)

        # The chunk's CUDA graphs read the factor, the tables and the matvec
        # rung by address: they are dropped (None) before a factor rebuild
        # and at a rung climb, and made again at the next chunk.
        blocks, capture_s = None, 0.0

        def chunk(state):
            """One chunk's enqueue with its block reads: the span ``cg.chunk``."""
            nonlocal blocks
            with profiling.span('cg.chunk'):
                if not self._graphs:
                    return _pcg_chunk(state, Fp, tab, sig, lam, b_norm, tol, n_atoms=n_atoms,
                                      use_E_cstr=use_E_cstr, chunk_iters=CG_CHUNK_ITERS, mm=mv_mm)
                if blocks is None:
                    blocks = _ChunkBlocks(Fp, tab, sig, lam, b_norm, tol, n=n, n_atoms=n_atoms,
                                          use_E_cstr=use_E_cstr, mm=mv_mm, graph=self.device.type == 'cuda')
                return blocks(state, CG_CHUNK_ITERS)

        def drop_blocks():
            nonlocal blocks, capture_s
            if blocks is not None:
                capture_s += blocks.loop.capture_s
            blocks = None

        # 'cg' is charged the loop's time less the preconditioner rebuilds
        # of its restarts, which go to 'leverage scores' and 'factor'.
        t_cg, t_built = timeit.default_timer(), sum(timer.durations.values())
        state = init_state(x0, Fp)
        num_iters = num_iters0
        num_restarts = 0
        resid = float(host([graphs.host_read(torch.linalg.vector_norm(state[1]).item)])[0])
        steps_hist: list = []
        max_iters = 3 * n_atoms * n_train * 10
        last_ckpt = timeit.default_timer()
        t_start = timeit.default_timer()
        # Best finite iterate: restarts re-seed from it, and the final answer
        # falls back to it, so a numerical breakdown never poisons the model.
        best_resid = resid if np.isfinite(resid) else np.inf
        best_x = state[0].clone()
        iters_since_best = 0
        max_best_gap = 0
        reseeds_since_best = 0

        while True:
            state = chunk(state)
            x, r, z, p, rz, it_done, hist, n_bad = state
            # Residual replacement: measure the TRUE residual once per chunk.
            r_true = b - A_apply(x)
            # The chunk's one host read: its step count, guard trips, history
            # and true residual, with the wall clock (on a mesh, rank 0's).
            head = graphs.host_read(torch.cat([it_done.to(hist.dtype)[None], n_bad.to(hist.dtype)[None], hist,
                                               torch.linalg.vector_norm(r_true)[None]]).cpu).numpy()
            now = timeit.default_timer()
            head = host(np.concatenate([head, [now - t_start, now - last_ckpt]]))
            it_done, n_bad, hist_np = int(head[0]), int(head[1]), head[2:2 + int(head[0])]
            true_resid = float(head[-3])
            elapsed, since_ckpt = float(head[-2]), float(head[-1])
            num_iters += it_done
            iters_since_best += it_done
            if n_bad:
                log.info('PSD guard tripped %d/%d times in this CG chunk (beta=0 unpreconditioned steps).',
                         n_bad, it_done)

            new_resid_series = np.concatenate([[resid], hist_np])
            resid_rec = float(new_resid_series[-1])

            # Re-anchor the recursion at the true residual when it has drifted.
            replaced = False
            if np.isfinite(true_resid):
                drift = (abs(true_resid - resid_rec) / max(true_resid, 1e-300)
                         if np.isfinite(resid_rec) else np.inf)
                # A chunk that stopped early without true convergence: the
                # recursive residual dipped below tol (or broke down) while
                # the truth is above it; always re-anchor then.
                early_noconv = it_done < CG_CHUNK_ITERS and true_resid > tol * b_norm
                if drift > RESID_REPLACE_DRIFT or early_noconv:
                    z_new = precond_z(r_true, Fp)
                    rz_new = r_true @ z_new
                    if not _flag(rz_new > 0, self.mesh):  # PSD guard
                        z_new = r_true
                        rz_new = r_true @ r_true
                        p = z_new  # beta = 0: restart the direction too
                    state = (x, r_true, z_new, p, rz_new) + state[5:]
                    replaced = True
                    log.info('CG residual replacement at iteration %d: recursive %.3e -> true %.3e '
                             '(drift %.1f%%).', num_iters, resid_rec, true_resid, 100 * drift)
                new_resid_series[-1] = true_resid
                resid = true_resid
            else:
                resid = resid_rec

            steps_hist += list(np.diff(new_resid_series))
            steps_hist = steps_hist[-CG_STEPS_HIST_LEN:]
            if np.isfinite(resid) and resid < best_resid:
                best_resid = resid
                best_x = x.clone()
                max_best_gap = max(max_best_gap, iters_since_best)
                iters_since_best = 0
                reseeds_since_best = 0
            elif not np.isfinite(resid):
                log.warning('CG residual is non-finite at iteration %d (numerical breakdown); falling back '
                            'to the best iterate (residual %.3e).', num_iters, best_resid)

            converged = resid <= tol * b_norm
            if converged or num_iters >= max_iters:
                break
            if max_seconds is not None and elapsed > max_seconds:
                log.warning('CG wall-clock budget (%.0f s) exhausted at iteration %d (residual %.3e vs '
                            'target %.3e); returning the unconverged solution.',
                            max_seconds, num_iters, resid, tol * b_norm)
                break
            if it_done < CG_CHUNK_ITERS and not converged:
                # Stopped early without true convergence: drift if the
                # replacement re-anchored the recursion, else a stall.
                eff = 100 if replaced else -100
            elif len(steps_hist) < CG_STEPS_HIST_LEN:
                eff = 100  # not enough history to judge yet
            else:
                steps = np.array(steps_hist)
                total = np.abs(steps).sum()
                ratio = (-steps.clip(max=0).sum() / total) if total > 0 else 1.0
                eff = (int(100 * ratio) - 50) * 2

            rate = (num_iters - num_iters0) / max(elapsed, 1e-9)
            if self.callback is None:
                log.info('CG: %d iters (%.2f iter/s), resid %.3e (best %.3e, target %.3e), effectiveness '
                         '%d%%, k=%d.', num_iters, rate, resid, best_resid, tol * b_norm, eff, n_inducing_pts)
            else:
                self.callback(
                    num_iters, max_iters,
                    disp_str='Training error (RMSE): forces %.4f' % (resid / np.sqrt(n)),
                    sec_disp_str='%d iter @ %.2f iter/s, k=%d' % (num_iters, rate, n_inducing_pts),
                )

            # Periodic checkpoint of the BEST iterate (mid-oscillation the
            # current one can sit far above it); on a mesh rank 0 writes it.
            if save_progr_callback is not None and since_ckpt > CHECKPOINT_INTERVAL_S:
                last_ckpt = now
                if info is None or info.rank == 0:
                    self._save_checkpoint(task, X, Jc, y_std, best_x, tol, num_iters, best_resid, b_norm,
                                          inducing_pts_idxs, save_progr_callback, mv_mm=mv_mm)

            # Stall: strengthen the preconditioner and restart, within the
            # same memory budget as the initial build; or, at the cap, the
            # stagnation policy (see the constants block).
            if eff <= EFF_RESTART_THRESH:
                steps_hist = []
                if n_inducing_pts >= grow_cap:
                    window = max(RESEED_STAGNATION_ITERS, 2 * max_best_gap)
                    if iters_since_best < window:
                        continue  # normal oscillation: keep the Krylov space
                    if reseeds_since_best == 0:
                        reseeds_since_best = 1
                        log.info('CG stalled at the inducing-point memory cap (k=%d); re-seeding CG from the '
                                 'best iterate (resid %.3e).', n_inducing_pts, best_resid)
                        state = init_state(best_x, Fp)
                        resid = best_resid
                        iters_since_best = 0
                        continue
                    if mv_mm != MV_MM_LADDER[-1]:
                        # Already re-seeded from this best (a second re-seed
                        # would replay the same trajectory): climb the
                        # matvec ladder, a different operator, and re-seed.
                        mv_mm = MV_MM_LADDER[MV_MM_LADDER.index(mv_mm) + 1]
                        drop_blocks()
                        log.info('CG best residual stagnant at %.3e for %d iterations: escalating the matvec '
                                 'precision to %r.', best_resid, iters_since_best, mv_mm)
                        state = init_state(best_x, Fp)
                        resid = best_resid
                        iters_since_best = 0
                        continue
                    # Top rung, already re-seeded: grind uninterrupted,
                    # within a bound.
                    if max_seconds is not None:
                        rate_now = max((num_iters - num_iters0) / max(elapsed, 1e-9), 1e-9)
                        deep_iters = int(DEEP_STAGNATION_BUDGET_FRAC * max_seconds * rate_now)
                    else:
                        deep_iters = int(DEEP_STAGNATION_ITERS_FRAC * (num_iters - num_iters0))
                    deep = max(2 * window, deep_iters)
                    if iters_since_best >= deep:
                        log.warning('CG made no progress on the best residual (%.3e) for %d iterations '
                                    '(deep-stagnation limit %d) at the top matvec precision; giving up with '
                                    'the current (unconverged) solution.', best_resid, iters_since_best, deep)
                        break
                    continue
                num_restarts += 1
                if num_restarts >= MAX_NUM_RESTARTS:
                    log.warning('CG stalled %d times; giving up with the current (unconverged) solution.',
                                num_restarts)
                    break
                n_inducing_pts = min(int(np.ceil(1.2 * n_inducing_pts)), grow_cap)
                log.info('CG stalled; restarting with k=%d inducing points (%d restarts left).',
                         n_inducing_pts, MAX_NUM_RESTARTS - num_restarts)
                if lev_scores is None:
                    with timer.phase('leverage scores'):
                        lev_scores = self._lev_scores(X, Jc, dperms, sig, lam, n_inducing_pts, n_atoms,
                                                      use_E_cstr, rng)
                inducing_pts_idxs = self.inducing_pts_from_lev_scores(
                    lev_scores[: n_train * dim_i], n_inducing_pts * dim_i, rng)
                # Free the old factor, and the graphs that read it, before
                # the new one is built.
                drop_blocks()
                Fp = state = z = r = p = None
                with timer.phase('factor'):
                    Fp, lev_scores = self._build_factor(X, Jc, dperms, sig, lam, inducing_pts_idxs, n_atoms,
                                                        use_E_cstr)
                state = init_state(best_x, Fp)
                resid = best_resid
                iters_since_best = 0  # a fresh Krylov space gets a full window

        drop_blocks()
        if not np.isfinite(resid) or resid > best_resid:
            x_final, resid = best_x, best_resid
        else:
            x_final = state[0]
        if info is not None:
            # Every rank returns rank 0's bits.
            torch.distributed.broadcast(x_final, src=torch.distributed.get_global_rank(info.group, 0),
                                        group=info.group)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        timer.durations['cg'] = timeit.default_timer() - t_cg - (sum(timer.durations.values()) - t_built)
        if capture_s:
            timer.durations['cg capture'] = capture_s
        is_conv = resid <= tol * b_norm
        return -x_final, tol, num_iters, resid, resid / np.sqrt(n), np.asarray(inducing_pts_idxs), is_conv

    def _save_checkpoint(self, task, R_desc, R_d_desc, y_std, x, tol, num_iters, resid, b_norm,
                         inducing_pts_idxs, save_progr_callback, mv_mm=None):
        # E-constrained solves extend x by the M energy unknowns; split them
        # off before create_model, which reshapes alphas_F to (M, 3N).
        x = -x
        alphas_E = None
        alphas_F = x
        if bool(task.get('use_E_cstr', False)):
            n_train = int(task['R_train'].shape[0])
            alphas_E = x[-n_train:]
            alphas_F = x[:-n_train]
        model = self.gdml_train.create_model(task, 'cg', R_desc, R_d_desc, y_std, alphas_F, alphas_E=alphas_E)
        model.update({
            'solver_tol': tol,
            'solver_iters': num_iters,
            'solver_resid': resid,
            'norm_y_train': b_norm,
            'inducing_pts_idxs': np.asarray(inducing_pts_idxs),
        })
        if mv_mm is not None:
            model['solver_mv_mm'] = mv_mm
        model = self._finish_checkpoint_model(model, task, R_desc, R_d_desc)
        try:
            save_progr_callback(model)
        except Exception:
            # Checkpointing is best-effort: a failed save must never abort
            # the solve. The next interval retries.
            log.warning('Periodic checkpoint save failed (continuing the solve):', exc_info=True)

    def _finish_checkpoint_model(self, model, task, R_desc, R_d_desc):
        """The checkpoint's integration constant, from a prediction on the
        training set on the solver's device (the fused kernel on a GPU)."""
        if 'E_train' in task:
            from ..predict import GDMLPredict

            pred = GDMLPredict(model, device=self.device)
            pred.set_R_desc(R_desc)
            pred.set_R_d_desc(R_d_desc)
            E_pred, _ = pred.predict()
            model['c'] = float(np.mean(np.squeeze(task['E_train']) - E_pred))
        return model

    # -- memory models (reference: iterative.py:827-866) --------------------

    @staticmethod
    def max_n_inducing_pts(n_train, n_atoms, max_memory_bytes, n_dev=1, factor_bytes=16.0, streamed=False):
        """Inducing-point budget: the reference formula (iterative.py:827-844),
        capped so that the ``(k, n)`` factor's ``factor_bytes`` per element
        (16 for the one-pass f64 build's peak: columns and ``Y`` chunks
        together) stay within 40% of the budget. ``streamed``: the streamed
        slice-stack build's plan, its ``factor_bytes`` (slices + 1) per
        element within 72% of the budget less a 1.5 GB reserve.
        ``max_memory_bytes`` is a device's; with ``n_dev`` devices the factor
        is column-sharded, so its linear-in-k terms scale by ``n_dev``. The
        JAX package's function, so that k agrees at the same budget."""
        sq, lin = 5, 4
        dim_i = 3 * n_atoms
        n_dev = max(1, int(n_dev))
        if streamed:
            avail = max(0.0, 0.72 * max_memory_bytes - 1.5e9)
            cap = avail * n_dev / (min(float(factor_bytes), 16.0) * n_train * dim_i * dim_i)
            return max(1, min(int(cap), n_train))
        to_dof = dim_i**2 * 8
        sq_factor = lin * n_train * to_dof / n_dev
        ny_factor = sq * to_dof
        n_ind = (np.sqrt(sq_factor**2 + 4.0 * ny_factor * max_memory_bytes) - sq_factor) / (2 * ny_factor)
        n_ind_split_cap = 0.4 * max_memory_bytes / float(factor_bytes) * n_dev / (n_train * dim_i * dim_i)
        return max(1, min(int(n_ind), int(n_ind_split_cap), n_train))

    @staticmethod
    def est_memory_requirement(n_train, n_inducing_pts, n_atoms):
        sq, lin = 5, 4
        est = lin * n_train * n_inducing_pts * (3 * n_atoms) ** 2 * 8
        est += sq * n_inducing_pts**2 * (3 * n_atoms) ** 2 * 8
        return est
