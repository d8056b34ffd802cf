"""Closed-form solver: Cholesky factorization of the assembled kernel system
on the device (reference behavior: sgdml/solvers/analytic.py:49-151).

The assembled kernel K is negated to make the system convex, shifted by
the ridge ``lam`` on its diagonal and factorized. A failed factorization
shows as ``info != 0`` from ``torch.linalg.cholesky_ex``, read once after
the factor (once per block column on the blocked routes). Four routes on
one device, chosen by the device-memory budget:

* **dense f64** (the system's ``24 n^2`` bytes fit): ``K`` is negated and
  shifted in place, so the factor is the only second ``n^2`` buffer. The
  ladder mirrors the reference: Cholesky -> LU -> least squares (for
  non-square systems).
* **in-place f64** (past the dense bound, where ``est_memory_inplace``,
  ``8 n^2`` bytes and a working set, fits): the same ``K``, negated and
  shifted in place, factored in place block column by block column by
  ``ops/linalg.cholesky_`` (the blocked right-looking Cholesky that
  ``parallel/spmd.solve_interleaved`` runs at one rank) and solved by two
  block substitutions. A factor that fails has consumed ``K``, so there is
  no LU rung: the solve logs a warning and takes the pair-or-grid rule.
* **f32 block-grid packed + refinement CG** (past both f64 routes): the
  force block of ``A = -K + lam' I`` is assembled straight into the f32
  block-grid triangle of ``ops/blockchol.py`` (``3 n^2`` bytes with
  transients, ``est_memory_grid``), factorized by a blocked Cholesky, and
  used as the preconditioner of conjugate gradients on the TRUE f64
  system, whose matvec is the matrix-free prediction pass
  (``solvers/iterative._matvec_A``: on a GPU the fused (E, F) kernel).
  ``lam'`` is raised along a ladder of multiples of ``lmax`` (found by
  power iteration through the same matvec) just far enough for the f32
  factorization to hold, which bounds the preconditioned condition number
  by ``lam'/lam``. Energy constraints add a dense border through an exact
  Schur-complement preconditioner.
* **pair precision + refinement CG** (past both f64 routes, where ``lam <
  1e-7 lmax`` and ``est_memory_pair`` fits): the same refinement CG with
  the (f32, bf16) pair-precision factor of ``ops/pairchol.py``, assembled in
  f64 and factorized with exact int8 Ozaki updates at the pair-storage
  floor, so ``lam'`` sits about 100x below the f32 grid's and CG takes
  far fewer iterations; the factor is applied through int8 slice stacks.
  Its ladder starts at ``3e-9 lmax``; where every rung fails, or CG breaks
  down before a finite iterate, it falls back to the grid route (logged).

Same routes and results as ``sgdml_tpu.solvers.analytic`` on one device,
where H100 measurements re-decided two TPU rules. Dense f64 stays the route
wherever it fits (the JAX package leaves it past 8,192 unknowns because the
TPU emulates f64). Past the dense bound the f64 system is factored in place
wherever that fits (the JAX package sends every system past ``24 n^2`` to
the pair or grid route, a rule written for a 16 GB chip that emulates f64;
it runs the in-place arithmetic only on a mesh): at aspirin M=1000 on an
H100 the in-place route trained in about a twentieth of the pair route's
time (PERF.md). Past both, the pair-or-grid rule is the JAX package's.

The refinement CG of the grid and pair routes runs in chunks, each of which
the JAX package compiles as one ``while_loop``: on a CUDA device a chunk
replays CUDA graphs of ``CG_ACTIVE_READ_ITERS`` iterations each
(:class:`_CholBlocks`), with one host read between two; elsewhere it is the
eager loop :func:`_pcg_chol`, which gives the same bits.
"""

from __future__ import annotations

import logging
import timeit

import numpy as np
import torch

from ..ops import blockchol, linalg, pairchol
from ..ops.kernel import (
    _grad_row_tile, _perms_key, _tile_constants, _value_tile, assemble_kernel, assemble_kernel_grid,
    assemble_kernel_grid_pair, default_tile_sizes, expand_perm_jacobian, perm_tables, tile_peak_bytes,
)
from ..utils import graphs
from ..utils.profiling import PhaseTimer

__all__ = ['Analytic', 'memory_budget']

log = logging.getLogger(__name__)

# Budget on the CPU, where no allocator reports what is free.
CPU_BUDGET_BYTES = 12 * 1024**3

PCG_MAX_ITERS = 2500
PCG_RTOL = 1e-9  # relative residual target (reference CG stops at 1e-4)
PCG_CHUNK_ITERS = 250  # refinement-CG iterations between host reports
GRID_TARGET_BLOCK = 8192  # side of a grid block, in unknowns
# The lam' ladder in units of lmax. The unshifted rung is skipped when lam <
# 1e-7 lmax: an f32 factorization needs the smallest eigenvalue above about
# n eps32 lmax.
LAM_P_SHIFTS = (0.0, 3e-7, 3e-6, 3e-5, 3e-4, 3e-3)
# The pair route: its block side and its ladder, which starts near the
# pair-storage floor (~2^-33 lmax) plus assembly noise; the unshifted rung is
# skipped when lam < 1e-9 lmax. The route is taken where lam is below
# PAIR_REGION lmax (the f32 grid's first rung would shift it).
PAIR_TARGET_BLOCK = 4096
PAIR_LAM_P_SHIFTS = (0.0, 3e-9, 3e-8, 3e-7, 3e-6)
PAIR_REGION = 1e-7
# The in-place f64 route's block: the mesh's (parallel/spmd.NB).
INPLACE_BLOCK = 1024
BORDER_TILE = 64  # energy columns a tile of the border assembly

_F32, _F64 = torch.float32, torch.float64


def memory_budget(device) -> int:
    """Bytes a dense solve may take on ``device``: on a GPU what CUDA
    reports free plus what PyTorch's allocator holds unused; on the CPU
    :data:`CPU_BUDGET_BYTES`."""
    device = torch.device(device)
    if device.type != 'cuda':
        return CPU_BUDGET_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device))


def _neg_shift_(K: torch.Tensor, lam: float) -> torch.Tensor:
    """``K <- -K + lam I`` in place; returns ``K``."""
    K.neg_()
    K.diagonal().add_(lam)
    return K


def _cho_solve_neg(A: torch.Tensor, y: torch.Tensor):
    """``alphas = -cho_solve(A, y)`` for ``A = -K + lam I`` (see
    :func:`_neg_shift_`); also returns whether the factorization held
    (``sgdml_tpu.solvers.analytic._cho_solve_neg`` after the shift)."""
    L, info = torch.linalg.cholesky_ex(A)
    if int(info) != 0:  # one device-to-host read, after the factor
        return None, False
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    alphas = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return -alphas[:, 0], True


def _lu_solve_neg(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``-solve(A, y)`` by LU for ``A = -K + lam I``, when Cholesky fails."""
    return -torch.linalg.solve(A, y)


# -- the f32 grid route -------------------------------------------------------


def _lmax_power(tab, sig, lam, *, n_atoms, use_E_cstr=False, iters=12, v0=None) -> float:
    """Largest eigenvalue of ``A = -K + lam I`` by ``iters`` power
    iterations through the matrix-free matvec (``iters + 1`` prediction
    passes over ``tab``, ``solvers/iterative.MatvecTables``; no matrix is
    formed). The start vector is ``v0``, else a standard normal draw from a
    CPU generator seeded 0: a constant vector is a rigid translation, an
    exact null vector of the force kernel, from which the iteration would
    return ``lam``. One host read, at the end."""
    from .iterative import _matvec_A

    m = tab.X.shape[0]
    n = m * 3 * n_atoms + (m if use_E_cstr else 0)
    if v0 is None:
        v0 = torch.randn(n, generator=torch.Generator().manual_seed(0), dtype=_F64)
    v = torch.as_tensor(v0, dtype=tab.X.dtype).to(tab.X.device)
    v = v / torch.linalg.vector_norm(v)

    def mv(v):
        return _matvec_A(v, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)

    for _ in range(iters):
        w = mv(v)
        v = w / torch.linalg.vector_norm(w)
    return float(v @ mv(v))


def _assemble_ee_A(X, sig, lam_p, desc_perms, tile=BORDER_TILE):
    """Energy-energy border block of ``A = -K + lam' I``:
    ``Aee[i, j] = sum_p k(x_i, x_j^p) + lam' delta_ij`` (the negation of the
    assembled ee kernel block, sgdml/train.py:298-300), ``(M, M)``, tiled
    over the columns."""
    m, dim_d = X.shape
    dp = torch.as_tensor(np.asarray(desc_perms), dtype=torch.int64, device=X.device)
    Xp = X[:, dp]  # (M, P, D)
    out = torch.empty((m, m), dtype=X.dtype, device=X.device)
    for j0 in range(0, m, tile):
        j1 = min(m, j0 + tile)
        ee = _value_tile(X, Xp[j0:j1].reshape(-1, dim_d), sig)  # -k, (M, t P)
        torch.neg(ee.view(m, j1 - j0, -1).sum(2), out=out[:, j0:j1])
    out.diagonal().add_(lam_p)
    return out


def _assemble_fe_A(X, Jc, sig, desc_perms, n_atoms, tile=BORDER_TILE):
    """Force-rows x energy-columns border of ``A = -K``:
    ``A_fe[(i, x), j] = -grad_x k(x_j, x_i^p)^T J_i`` summed over the
    permutations (the negation of the assembled ef kernel border, same tile
    math as ``assemble_kernel``'s E blocks; reference sgdml/train.py:251-265),
    ``(M 3N, M)``, tiled over the energy columns."""
    m, dim_d = X.shape
    dim_i = 3 * n_atoms
    key = _perms_key(desc_perms)
    n_perms = key[1][0]
    s_perm = _tile_constants(key, n_atoms, X.device, X.dtype)[1]
    Xp, Jcp = perm_tables(X, Jc, desc_perms)
    Jit = expand_perm_jacobian(Jcp, s_perm).reshape(m * n_perms, dim_d, dim_i)
    Xit = Xp.reshape(m * n_perms, dim_d)
    out = torch.empty((m * dim_i, m), dtype=X.dtype, device=X.device)
    for j0 in range(0, m, tile):
        j1 = min(m, j0 + tile)
        ef = _grad_row_tile(X[j0:j1], Xit, Jit, sig).view(j1 - j0, m, n_perms, dim_i).sum(2)
        torch.neg(ef.permute(1, 2, 0).reshape(m * dim_i, j1 - j0), out=out[:, j0:j1])
    return out


def _border_M_apply(M_ff, G, Ls, n_f):
    """Exact bordered (Schur-complement) preconditioner apply:

        M = [[P_ff, A_fe], [A_ef, Aee + lam']],
        G = P_ff^{-1} A_fe,   S = Aee + lam' - A_ef G,   Ls = chol(S)

        M^{-1} v = [P_ff^{-1} v_f - G z_e;  z_e],
        z_e = S^{-1} (v_e - G^T v_f)

    ``G`` in the dtype of ``v``. Symmetric PSD by construction, and exact for
    the lam'-shifted bordered matrix up to the factor's precision, so the
    preconditioned condition number keeps the lam'/lam bound (a
    block-diagonal variant that dropped the coupling stalled at ~1e-5
    relative residual, as the JAX package records)."""

    def M_apply(v):
        vf, ve = v[:n_f], v[n_f:]
        zf0 = M_ff(vf)
        ze = torch.cholesky_solve((ve - G.mT @ vf)[:, None], Ls)[:, 0]
        return torch.cat([zf0 - G @ ze, ze])

    return M_apply


def _border_pieces_grid(L32, A_fe, Aee):
    """Bordered-preconditioner pieces for the f32 grid factor:
    ``G = P_ff^{-1} A_fe`` (f32, multi-RHS block-triangular solves) and
    ``Ls = chol(Aee + lam' - A_ef G)`` (f64)."""
    n_f, m = A_fe.shape
    n_pad = len(L32) * L32[0][0].shape[0]
    B = torch.zeros((n_pad, m), dtype=_F32, device=A_fe.device)
    B[:n_f] = A_fe
    G = blockchol.solve_grid(L32, B)[:n_f]
    return G, _schur_chol(Aee - A_fe.mT @ G.to(Aee.dtype))


def _border_pieces_pair(sstrips, Dinv, A_fe, Aee):
    """Bordered-preconditioner pieces for the pair factor: ``G = P_ff^{-1}
    A_fe`` by the int8 strip solve with ``M`` right-hand sides (f64) and
    ``Ls = chol(Aee + lam' - A_ef G)``."""
    G = pairchol.solve_strips_int8(sstrips, Dinv, A_fe)
    return G, _schur_chol(Aee - A_fe.mT @ G)


def _schur_chol(S):
    Ls, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        raise RuntimeError(
            'the energy-constraint Schur complement is not positive definite at this lam\'; '
            'try a different sigma or a larger regularization')
    return Ls


def _matvec_op(tab, sig, lam, *, n_atoms, use_E_cstr):
    """The refinement CG's matrix-free f64 matvec ``v -> A v``."""
    from .iterative import _matvec_A

    def A_apply(v):
        return _matvec_A(v, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)

    return A_apply


def _grid_operators(L32, G, Ls, tab, sig, lam, *, n_atoms, n, use_E_cstr):
    """``(A_apply, M_apply)`` of the refinement CG: the matrix-free f64
    matvec, and the preconditioner, which pads to the grid's side, solves
    in f32 through ``L32`` and casts back (through the exact border with
    ``G``, ``Ls`` when ``use_E_cstr``)."""
    m = tab.X.shape[0]
    n_f = n - (m if use_E_cstr else 0)
    n_pad = len(L32) * L32[0][0].shape[0]
    A_apply = _matvec_op(tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)

    def M_ff(v):
        vp = torch.zeros(n_pad, dtype=_F32, device=v.device)
        vp[:n_f] = v
        return blockchol.solve_grid(L32, vp)[:n_f].to(v.dtype)

    return A_apply, (_border_M_apply(M_ff, G.to(_F64), Ls, n_f) if use_E_cstr else M_ff)


def _cuda_graph(fn, n, device):
    """``fn`` of f64 vectors of length ``n`` on a CUDA ``device`` as a
    ``utils/graphs.Program`` over a static input, on a side stream: the
    first call runs eagerly, the capture follows, and later calls replay it:
    same kernels, same bits, one launch from the host."""
    x = torch.empty(n, dtype=_F64, device=device)
    side = torch.cuda.Stream(device)
    run = graphs.Program(lambda: fn(x), graph=True)

    def replay(v):
        y = torch.empty_like(x)
        with graphs.on_stream(side):
            x.copy_(v)
            y.copy_(run())
        return y

    return replay


def _pair_M_apply(sstrips, Dinv, G, Ls, n, m, use_E_cstr):
    """The pair route's preconditioner: the int8 strip solve through the
    factor (``pairchol.solve_strips_int8``, which pads to the grid's side),
    through the exact border with ``G``, ``Ls`` when ``use_E_cstr`` (``m``
    energy rows). On a GPU the strip solve of a vector is a CUDA graph of
    its own (:func:`_cuda_graph`): it issues about 8,000 small kernels,
    which the host took 0.2 s to enqueue at aspirin M=1000 on the H100
    (PERF.md). While a stream is captured (the refinement's block graphs,
    :class:`_CholBlocks`) the same kernels are enqueued into that capture
    instead: the same bits."""
    n_f = n - m if use_E_cstr else n

    def solve(v):
        return pairchol.solve_strips_int8(sstrips, Dinv, v)

    M_ff = solve
    device = Dinv[0].slices.device
    if device.type == 'cuda':
        graphed = _cuda_graph(solve, n_f, device)

        def M_ff(v):
            return solve(v) if torch.cuda.is_current_stream_capturing() else graphed(v)
    return _border_M_apply(M_ff, G, Ls, n_f) if use_E_cstr else M_ff


def _pcg_chol_step(x, r, z, p, rz, active, A_apply, M_apply, thresh):
    """One masked refinement-CG iteration: the new ``(x, r, z, p, rz)``, each
    the old one where ``active`` is False, and ``active`` for the next
    iteration (the residual norm above ``thresh`` and finite)."""
    Ap = A_apply(p)
    alpha = rz / (p @ Ap)
    r_new = r - alpha * Ap
    z_new = M_apply(r_new)
    rz_new = r_new @ z_new
    p_new = z_new + (rz_new / rz) * p
    rn = torch.linalg.vector_norm(r_new)
    return (torch.where(active, x + alpha * p, x), torch.where(active, r_new, r), torch.where(active, z_new, z),
            torch.where(active, p_new, p), torch.where(active, rz_new, rz), active & (rn > thresh) & torch.isfinite(rn))


def _pcg_chol(state, A_apply, M_apply, b_norm, rtol, *, max_iters, flag=bool):
    """One chunk of at most ``max_iters`` conjugate-gradient iterations on
    the f64 system, preconditioned by ``M_apply``.

    state: ``(x, r, z, p, rz, it)`` on the device (``it`` is ignored and
    restarts at 0). Iteration ``i`` commits only while ``active``: the
    residual norm above ``rtol * b_norm`` and finite, as the JAX package's
    ``while_loop`` tests it, so ``it`` counts the iterations that loop
    takes (a step that makes the residual non-finite is committed and
    ends the chunk, as there). The host reads ``active`` every
    ``CG_ACTIVE_READ_ITERS`` iterations and ends an inactive chunk there;
    ``flag`` reads it (on a mesh rank 0's reading, so that every rank stops
    alike), a ``graphs.host_read``. Returns ``(state, |r|)``.

    The eager loop: the mesh's chunk, and the private oracle of
    :class:`_CholBlocks`, which replays the same iterations from CUDA graphs
    on one card.
    """
    from .iterative import CG_ACTIVE_READ_ITERS

    x, r, z, p, rz, _ = state
    thresh = rtol * b_norm
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    rn = torch.linalg.vector_norm(r)
    active = (rn > thresh) & torch.isfinite(rn)
    for i in range(max_iters):
        if i % CG_ACTIVE_READ_ITERS == 0 and not graphs.host_read(lambda: flag(active)):
            break
        x, r, z, p, rz, going = _pcg_chol_step(x, r, z, p, rz, active, A_apply, M_apply, thresh)
        it += active
        active = going
    return (x, r, z, p, rz, it), torch.linalg.vector_norm(r)


class _CholBlocks:
    """:func:`_pcg_chol` on one device as a :class:`graphs.Loop` over the
    state ``(x, r, z, p, rz, active, it)``: blocks of
    ``CG_ACTIVE_READ_ITERS`` masked iterations, each one CUDA graph replay
    with ``graph`` (a card), run eagerly without; the host reads ``active``
    between blocks, where the eager loop reads it. The JAX package's chunk
    is one compiled ``while_loop`` (``sgdml_tpu/solvers/analytic.py:
    _pcg_chol``). The graphs read the operators' tensors (the matvec's
    tables, the factor, the border) by address, and live as long as the
    solve's refinement."""

    def __init__(self, A_apply, M_apply, b_norm, rtol, like, graph):
        from .iterative import CG_ACTIVE_READ_ITERS

        self.thresh = thresh = rtol * b_norm

        def step(state):
            x, r, z, p, rz, active, it = state
            x, r, z, p, rz, going = _pcg_chol_step(x, r, z, p, rz, active, A_apply, M_apply, thresh)
            it += active
            return x, r, z, p, rz, going, it

        flag = torch.empty((), dtype=torch.bool, device=like.device)
        like = (like,) * 4 + (like.new_empty(()), flag, like.new_empty((), dtype=torch.int64))
        self.loop = graphs.Loop(step, like, CG_ACTIVE_READ_ITERS, graph)

    def __call__(self, state, max_iters):
        """One chunk from ``state`` (as :func:`_pcg_chol` takes it); returns
        ``(state, |r|)`` as it does, the state copied out."""
        x, r, z, p, rz, _ = state
        rn = torch.linalg.vector_norm(r)
        start = (x, r, z, p, rz, (rn > self.thresh) & torch.isfinite(rn),
                 torch.zeros((), dtype=torch.int64, device=x.device))
        x, r, z, p, rz, _, it = self.loop(start, max_iters, lambda s: bool(s[5]))
        return (x, r, z, p, rz, it), torch.linalg.vector_norm(r)


def _refinement_cg(A_apply, M_apply, y, graph=None, timer=None):
    """Refinement CG on ``y`` preconditioned by ``M_apply``, in chunks of
    ``PCG_CHUNK_ITERS`` (one host read a chunk), to ``PCG_RTOL`` or
    ``PCG_MAX_ITERS``. Returns ``(x, rel, iters)``. With ``graph`` None the
    chunks are the eager loop :func:`_pcg_chol`; else :class:`_CholBlocks`,
    whose blocks replay CUDA graphs where ``graph`` is True, and whose
    captures' host seconds go to ``timer``'s ``'cg capture'``.

    On a numerical breakdown (a non-finite residual) ``x`` is the best
    finite iterate seen at a chunk's end, with a warning, or None when there
    was none: a breakdown poisons the in-flight state with NaNs, and NaN
    comparisons being False would otherwise let the poisoned ``x`` through.
    A stop above ``1e-6`` warns."""
    b_norm = max(float(torch.linalg.vector_norm(y)), 1e-300)
    iters, rel = 0, 1.0
    best_x, best_rel = None, np.inf
    t0 = timeit.default_timer()
    z0 = M_apply(y)
    state = (torch.zeros_like(y), y, z0, z0, y @ z0, None)
    if graph is None:
        def chunk(state):
            return _pcg_chol(state, A_apply, M_apply, b_norm, PCG_RTOL, max_iters=PCG_CHUNK_ITERS)
    else:
        blocks = _CholBlocks(A_apply, M_apply, b_norm, PCG_RTOL, y, graph)

        def chunk(state):
            return blocks(state, PCG_CHUNK_ITERS)
    for _ in range(-(-PCG_MAX_ITERS // PCG_CHUNK_ITERS)):
        state, resid = chunk(state)
        head = torch.stack([state[5].to(_F64), resid]).cpu()  # the chunk's one host read
        it_done, rel = int(head[0]), float(head[1]) / b_norm
        iters += it_done
        if np.isfinite(rel) and rel < best_rel:
            best_x, best_rel = state[0], rel
        log.info('Refinement CG: %d iterations, relative residual %.2e (%.1f s).',
                 iters, rel, timeit.default_timer() - t0)
        if not np.isfinite(rel) or rel <= PCG_RTOL or it_done < PCG_CHUNK_ITERS:
            break
    if graph is not None and timer is not None and blocks.loop.capture_s:
        timer.durations['cg capture'] = timer.durations.get('cg capture', 0.0) + blocks.loop.capture_s
    if not np.isfinite(rel):
        if best_x is None:
            return None, rel, iters
        log.warning(
            'Refinement CG broke down numerically at iteration %d; '
            'returning the best finite iterate (relative residual '
            '%.2e).', iters, best_rel,
        )
        x, rel = best_x, best_rel
    else:
        x = state[0]
    if not (rel <= 1e-6):
        log.warning(
            'Refinement CG stopped at relative residual %.2e (target '
            '%.0e); the solution may be slightly less accurate than a '
            'direct f64 factorization.', rel, PCG_RTOL,
        )
    return x, rel, iters


class Analytic:
    """Closed-form training on the device of its inputs.

    Parameters
    ----------
    gdml_train: the calling trainer (kept for API parity).
    callback: optional progress callback (unused by every route).
    mesh: a ``DeviceMesh`` (``parallel/mesh.py``): the solve is the sharded
        one at any size (:meth:`_solve_sharded`), every rank calling
        :meth:`solve` alike. None: one device.
    max_memory: budget in GB for the route choice; None takes
        :func:`memory_budget` of the inputs' device.
    mesh_precision: the factorization on a mesh: ``'f64'``, the blocked f64
        Cholesky of ``ops/linalg.py``; ``'pair'``, the pair-precision
        Cholesky of ``ops/meshchol.py`` as the preconditioner of CG on the
        f64 strip, along a lam' ladder (``spmd.solve_interleaved``).

    After :meth:`solve`, ``route`` names the route that solved (``'dense'``,
    ``'inplace'``, ``'grid'``, ``'pair'`` or ``'mesh'``) and
    ``timer.durations`` holds the seconds of its phases, each ended by a
    device synchronization: ``'assembly'`` and ``'cholesky'`` on the dense
    route; ``'assembly'``, ``'factor'`` and ``'solve'`` on the in-place route
    (a failed in-place factor leaves its two phases to the route that
    follows) and on the mesh (with ``'pair'`` the factor
    summed over the rungs, the solve the CG, and ``timer.counts['rungs']``
    the rungs tried); ``'lmax'``, ``'assembly'`` and
    ``'factor'`` (summed over the lam' ladder's rungs), ``'repack'`` (the
    pair route: leaf inverses and int8 slice stacks), ``'border'`` (with
    energy constraints) and ``'cg'`` past it. ``t_assemble`` is everything
    before the solve proper and ``t_solve`` the rest. The grid and pair
    routes also set ``lmax``, ``rungs`` (``(lam', info)`` of each rung
    tried; ``info`` 0 where the factor held), ``lam_p_used`` and
    ``pcg_iters``, and so does the mesh's pair route (its ``rungs`` as
    ``solve_interleaved``'s ``stats`` hold them; ``lam_p_used`` None where it
    fell back to f64).
    """

    def __init__(self, gdml_train=None, callback=None, mesh=None,
                 max_memory: float | None = None, mesh_precision: str = 'f64'):
        if mesh_precision not in ('f64', 'pair'):
            raise ValueError("mesh_precision must be 'f64' or 'pair', got %r" % (mesh_precision,))
        if mesh is not None:
            from ..parallel.mesh import mesh_info

            mesh_info(mesh)  # a DeviceMesh, with this rank in it
        self.mesh = mesh
        self.mesh_precision = mesh_precision
        self.gdml_train = gdml_train
        self.callback = callback
        self._max_memory = max_memory
        self.t_assemble = self.t_solve = self.route = None
        self.timer = PhaseTimer()
        # The refinement chunks of the grid and pair routes: None replays
        # CUDA graphs exactly on a CUDA device (the mesh has its own loop);
        # False runs the eager loop (chip_smoke.py's private oracle); True
        # off a card runs the graphs' blocks eagerly.
        self._graphs = None

    def _refine_graph(self, device):
        """The ``graph`` argument of :func:`_refinement_cg` on ``device``:
        None for the eager loop, else whether its blocks are captured."""
        on = device.type == 'cuda' if self._graphs is None else self._graphs
        return device.type == 'cuda' if on else None

    def solve(self, task, R_desc, R_d_desc, desc_perms, y):
        """Solve ``(-K + lam I) x = y`` and return ``alphas = -x`` as a
        tensor on the inputs' device, by the first route that fits the
        budget (``max_memory``, else :func:`memory_budget`):

        1. densely, where the system's ``24 n^2`` bytes
           (:meth:`est_memory_requirement`, the reference's) fit;
        2. by the in-place f64 factor (:meth:`_solve_inplace`), where
           :meth:`est_memory_inplace` fits;
        3. by the JAX package's rule past the dense bound
           (``sgdml_tpu/solvers/analytic.py:393-416``): the pair route where
           ``lam < 1e-7 lmax`` and :meth:`est_memory_pair` fits, else the
           f32 grid route. A failed in-place factor takes this step too,
           with a warning.

        R_desc: ``(M, D)``, R_d_desc: ``(M, D, 3)`` tensors on the device.
        desc_perms: ``(P, D)`` host ints. y: ``(n,)`` labels.
        """
        sig = float(np.squeeze(task['sig']))
        lam = float(np.squeeze(task['lam']))
        use_E_cstr = bool(task.get('use_E_cstr', False))
        device = R_desc.device
        self.timer = timer = PhaseTimer(device)

        n_train, dim_d = R_d_desc.shape[:2]
        n_atoms = int((1 + np.sqrt(8 * dim_d + 1)) / 2)
        if self.mesh is not None:
            return self._solve_sharded(R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr)
        budget = (memory_budget(device) if self._max_memory is None
                  else self._max_memory * 1024**3)
        need = Analytic.est_memory_requirement(n_train, n_atoms, use_E_cstr)
        if need > budget:
            n_perms = np.asarray(desc_perms).shape[0]
            if Analytic.est_memory_inplace(n_train, n_atoms, use_E_cstr, n_perms) <= budget:
                alphas = self._solve_inplace(R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr)
                if alphas is not None:
                    return alphas
            return self._solve_pair_or_grid(task, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr,
                                            budget)

        self.route = 'dense'
        with timer.phase('assembly'):
            K = assemble_kernel(R_desc, R_d_desc, desc_perms, sig, n_atoms, use_E_cstr=use_E_cstr)
        self.t_assemble = timer.durations['assembly']
        log.info('Assembled %dx%d kernel in %.2f s', K.shape[0], K.shape[1], self.t_assemble)

        y = torch.as_tensor(y, dtype=K.dtype, device=device)
        with timer.phase('cholesky'):
            if K.shape[0] == K.shape[1]:
                A = _neg_shift_(K, lam)
                alphas, ok = _cho_solve_neg(A, y)
                if not ok:
                    log.warning('Cholesky factorization failed (not PSD at lam=%g); falling back to LU.', lam)
                    alphas = _lu_solve_neg(A, y)
            else:
                alphas = -torch.linalg.lstsq(-K, y[:, None]).solution[:, 0]
        self.t_solve = timer.durations['cholesky']
        log.info('Solved %d-dim linear system in %.2f s', K.shape[0], self.t_solve)
        return alphas

    def _solve_pair_or_grid(self, task, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr, budget):
        """The JAX package's rule past the dense bound: lmax by power
        iteration, then the pair route where ``lam < PAIR_REGION lmax`` and
        :meth:`est_memory_pair` fits ``budget``, else the grid route."""
        from .iterative import matvec_tables

        # Both routes refine on the f64 inputs and their matvec tables: made
        # once here, where lmax picks the route.
        X, Jc = R_desc.to(_F64), R_d_desc.to(_F64)
        with self.timer.phase('lmax'):
            tab = matvec_tables(X, Jc, desc_perms)
            lmax = _lmax_power(tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)
        route = (self._solve_pair_pcg
                 if lam < PAIR_REGION * lmax and Analytic.est_memory_pair(X.shape[0], n_atoms) <= budget
                 else self._solve_grid_pcg)
        return route(task, X, Jc, desc_perms, y, sig, lam, n_atoms, lmax=lmax, tab=tab)

    def _solve_inplace(self, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr):
        """Past the dense bound, where :meth:`est_memory_inplace` fits: the
        dense route's ``K`` (energy rows included), negated and shifted in
        place (:func:`_neg_shift_`), factored in place in blocks of
        :data:`INPLACE_BLOCK` (``linalg.cholesky_``: the arithmetic of
        ``spmd.solve_interleaved`` at one rank, with no mesh) and solved by
        two block substitutions (``linalg.blocked_tri_solve``). The factor is
        dropped before ``alphas = -x`` is returned, so that nothing after the
        solve runs beside it. Where a diagonal block is not positive definite
        the factor has consumed ``K``: it is freed, a warning is logged and
        None is returned (the caller takes the pair-or-grid rule)."""
        timer = self.timer
        with timer.phase('assembly'):
            K = assemble_kernel(R_desc, R_d_desc, desc_perms, sig, n_atoms, use_E_cstr=use_E_cstr)
        self.t_assemble = timer.durations['assembly']
        log.info('Assembled %dx%d kernel in %.2f s', K.shape[0], K.shape[1], self.t_assemble)
        n = K.shape[0]
        nb = min(INPLACE_BLOCK, n)
        failure = None
        with timer.phase('factor'):
            try:
                linalg.cholesky_(_neg_shift_(K, lam), nb)
            except linalg.NotPositiveDefiniteError as err:
                failure = str(err)
        if failure is not None:
            del K  # outside the handler, whose traceback holds the factor's frame
            log.warning('In-place f64 Cholesky failed (%s at lam=%g); falling back to the pair or grid route.',
                        failure, lam)
            return None
        y = torch.as_tensor(y, dtype=K.dtype, device=K.device)
        with timer.phase('solve'):
            x = linalg.blocked_tri_solve(K, linalg.blocked_tri_solve(K, y, nb), nb, trans=True)
        del K
        self.route = 'inplace'
        self.t_solve = timer.durations['factor'] + timer.durations['solve']
        log.info('Solved %d-dim linear system (in-place f64 blocked Cholesky, nb %d) in %.2f s', n, nb, self.t_solve)
        return -x

    def _solve_sharded(self, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr):
        """The mesh's closed-form solve (``sgdml_tpu/solvers/analytic.py:
        456-490``): each rank assembles its row strip of the interleaved
        kernel matrix, which ``spmd.solve_interleaved`` solves at
        ``mesh_precision``: the distributed blocked f64 Cholesky factors it
        in place, or the pair route keeps it as CG's system. Returns
        ``alphas`` whole on every rank."""
        from ..parallel import spmd

        timer = self.timer
        self.route = 'mesh'
        with timer.phase('assembly'):
            K, lay = spmd.assemble_kernel_sharded(R_desc, R_d_desc, desc_perms, sig, n_atoms, self.mesh,
                                                  use_E_cstr=use_E_cstr)
        self.t_assemble = timer.durations['assembly']
        log.info('Assembled %dx%d kernel (row-sharded over %d devices) in %.2f s', lay.n, lay.n, lay.n_dev,
                 self.t_assemble)
        stats = {}
        alphas = spmd.solve_interleaved(K, y, lam, lay, self.mesh, precision=self.mesh_precision, timer=timer,
                                        stats=stats)
        if self.mesh_precision == 'pair':
            self.lmax, self.rungs = stats['lmax'], stats['rungs']
            self.lam_p_used, self.pcg_iters = stats.get('lam_p'), stats.get('iters')
        self.t_solve = timer.durations['factor'] + timer.durations['solve']
        log.info('Solved %d-dim linear system (%s blocked Cholesky over %d devices) in %.2f s', lay.n,
                 self.mesh_precision, lay.n_dev, self.t_solve)
        return alphas

    def _setup_refinement(self, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, use_E_cstr, lmax, tab):
        """The f64 inputs and labels of a refinement route, with its matvec
        tables and ``lmax`` (by power iteration) where not given."""
        from .iterative import matvec_tables

        X, Jc = R_desc.to(_F64), R_d_desc.to(_F64)
        y = torch.as_tensor(y, dtype=_F64, device=X.device)
        if tab is None:
            tab = matvec_tables(X, Jc, desc_perms)
        if lmax is None:
            with self.timer.phase('lmax'):
                lmax = _lmax_power(tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)
        return X, Jc, y, tab, lmax

    def _record_factor(self, lmax, lam_p_used, what, spec, lam, m, use_E_cstr):
        """Keep lmax, lam' and the seconds before the solve proper; log them."""
        timer = self.timer
        self.lmax, self.lam_p_used = lmax, lam_p_used
        self.t_assemble = sum(timer.durations.get(k, 0.0) for k in ('lmax', 'assembly', 'factor', 'repack', 'border'))
        log.info(
            "Assembled+factorized %dx%d %s triangle (%d x %d blocks) in %.2f s (lmax=%.3e, lam'=%g%s%s).",
            spec.n, spec.n, what, spec.k, spec.k, self.t_assemble, lmax, lam_p_used,
            '' if lam_p_used == lam else ' [shifted for stability]',
            ' [+%d-row E border]' % m if use_E_cstr else '',
        )

    def _solve_grid_pcg(self, task, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms, lmax=None, tab=None):
        """Large-system closed-form solve: f32 block-grid Cholesky
        preconditioner + f64 matrix-free refinement CG (module docstring).
        ``lmax`` is found by power iteration, and ``tab`` (the matvec tables
        of the f64 inputs) is built, unless given. Returns ``alphas = -x`` as
        a float64 tensor on the inputs' device."""
        use_E_cstr = bool(task.get('use_E_cstr', False))
        timer = self.timer
        dim_i = 3 * n_atoms
        m = R_desc.shape[0]
        m_pad = -(-m // 8) * 8
        spec = blockchol.grid_spec(m_pad * dim_i, target_block=GRID_TARGET_BLOCK, align=dim_i)
        X, Jc, y, tab, lmax = self._setup_refinement(R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms,
                                                     use_E_cstr, lmax, tab)

        # lam' ladder: raise the preconditioner shift until the f32
        # factorization holds. The preconditioned condition number is
        # bounded by lam'/lam, so CG always converges; when lam' == lam it
        # converges in a handful of iterations.
        shifts = LAM_P_SHIFTS[1:] if lam < 1e-7 * lmax else LAM_P_SHIFTS
        L32, lam_p_used, self.rungs = None, None, []
        for shift in shifts:
            lam_p = max(lam, shift * lmax)
            with timer.phase('assembly'):
                A32 = blockchol.grid_diag_add(
                    assemble_kernel_grid(X, Jc, desc_perms, sig, n_atoms, spec, dtype=_F32), lam_p)
            with timer.phase('factor'):
                L, info = blockchol.chol_grid(A32)  # in place: L is A32
            self.rungs.append((lam_p, info))
            if info == 0:
                L32, lam_p_used = L, lam_p
                break
            log.debug("grid rung lam'=%g: the f32 factorization failed at order %d.", lam_p, info)
            del A32, L  # free the failed factor before the next assembly
        if L32 is None:
            raise RuntimeError(
                'f32 block Cholesky failed even with a strong diagonal '
                'shift; the kernel matrix is numerically degenerate. '
                'Try a different sigma.'
            )
        # Energy-constraint border: exact bordered preconditioner at the
        # same lam' (Schur complement through the factor, _border_M_apply;
        # reference coverage: sgdml/train.py:235-300).
        G = Ls = None
        if use_E_cstr:
            with timer.phase('border'):
                G, Ls = _border_pieces_grid(
                    L32, _assemble_fe_A(X, Jc, sig, desc_perms, n_atoms),
                    _assemble_ee_A(X, sig, lam_p_used, desc_perms))
        self._record_factor(lmax, lam_p_used, 'f32 packed', spec, lam, m, use_E_cstr)

        A_apply, M_apply = _grid_operators(L32, G, Ls, tab, sig, lam, n_atoms=n_atoms, n=y.shape[0],
                                           use_E_cstr=use_E_cstr)
        with timer.phase('cg'):
            x, _, self.pcg_iters = _refinement_cg(A_apply, M_apply, y, self._refine_graph(y.device), timer)
        if x is None:
            raise RuntimeError(
                'Refinement CG broke down numerically before producing '
                'a finite iterate (the f32 factor is unusable as a '
                'preconditioner). Try a different sigma or a larger '
                'regularization.'
            )
        self.t_solve = timer.durations['cg']
        self.route = 'grid'
        return -x

    def _solve_pair_pcg(self, task, R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms,
                        target_block: int = PAIR_TARGET_BLOCK, lmax=None, tab=None):
        """Large-system closed-form solve, pair-precision variant: the (f32,
        bf16) block Cholesky with Ozaki int8 updates (``ops/pairchol.py``)
        factors at the pair-storage floor, so the stability shift lam' sits
        orders of magnitude below the f32 grid's (~3e-7 lmax), and the
        refinement CG converges in ~sqrt(lam'_f32 / lam'_pair) fewer
        iterations (``sgdml_tpu/solvers/analytic.py:638-836``).

        Each rung assembles true pair entries in f64
        (``assemble_kernel_grid_pair``) with native products: the JAX
        package's ``assembly='f64'``, and its ``mm='auto'`` as that rule
        reads off a TPU (it takes Ozaki products only there); no caller sets
        another value, so neither is an argument here. ``lmax`` and ``tab``
        as in :meth:`_solve_grid_pcg`. The factor is repacked in stages
        (factor at 6 bytes an element, leaf inverses, drop the diagonal
        pairs, int8 strips one at a time) and applied by
        ``pairchol.solve_strips_int8``. The CG is the grid route's chunked
        driver (:func:`_refinement_cg`, :func:`_pcg_chol`) with the pair
        preconditioner (:func:`_pair_M_apply`): the JAX package's
        ``_pcg_pair_step`` and ``_pcg_pair_start``, which host-step it and
        read the residual every 10 iterations, have no separate body here.
        When every rung fails, or CG breaks down before a finite iterate, it
        falls back to :meth:`_solve_grid_pcg` with a warning (given this
        ``lmax``). Returns ``alphas = -x`` as a float64 tensor."""
        use_E_cstr = bool(task.get('use_E_cstr', False))
        timer = self.timer
        dim_i = 3 * n_atoms
        m = R_desc.shape[0]
        m_pad = -(-m // 8) * 8
        spec = blockchol.grid_spec(m_pad * dim_i, target_block=target_block, align=dim_i)
        X, Jc, y, tab, lmax = self._setup_refinement(R_desc, R_d_desc, desc_perms, y, sig, lam, n_atoms,
                                                     use_E_cstr, lmax, tab)

        # lam' ladder from near the pair-storage floor; a failed rung costs
        # one assembly and a factorization up to its first indefinite leaf.
        shifts = PAIR_LAM_P_SHIFTS[1:] if lam < 1e-9 * lmax else PAIR_LAM_P_SHIFTS
        Lh = Ll = lam_p_used = None
        self.rungs = []
        for shift in shifts:
            lam_p = max(lam, shift * lmax)
            with timer.phase('assembly'):
                Ghi, Glo = assemble_kernel_grid_pair(X, Jc, desc_perms, sig, n_atoms, spec)
                pairchol.grid_pair_diag_add(Ghi, Glo, lam_p)
            with timer.phase('factor'):
                Ghi, Glo, info = pairchol.chol_grid_pair(Ghi, Glo)
            self.rungs.append((lam_p, info))
            if info == 0:
                Lh, Ll, lam_p_used = Ghi, Glo, lam_p
                break
            log.debug("pair rung lam'=%g: the factorization failed at order %d.", lam_p, info)
            del Ghi, Glo
        if Lh is None:
            log.warning("Pair-precision factorization failed at every lam' rung; falling back to the f32 grid "
                        'solver.')
            return self._solve_grid_pcg(task, X, Jc, desc_perms, y, sig, lam, n_atoms, lmax=lmax, tab=tab)
        with timer.phase('repack'):
            # Staged: the factor whole at 6 bytes an element, then its leaf
            # inverses, then the int8 strips one at a time.
            Dinv = pairchol.leaf_inverses(Lh, Ll)
            for j in range(len(Lh)):
                Lh[j][j] = Ll[j][j] = None
            sstrips = pairchol.int8_strips(pairchol.strips_from_grid(Lh, Ll))
            del Lh, Ll
            Dinv = pairchol.slice_leaf_inverses(Dinv)
        # Energy-constraint border (see _solve_grid_pcg): exact bordered
        # preconditioner through the pair factor at the same lam'.
        G = Ls = None
        if use_E_cstr:
            with timer.phase('border'):
                G, Ls = _border_pieces_pair(
                    sstrips, Dinv, _assemble_fe_A(X, Jc, sig, desc_perms, n_atoms),
                    _assemble_ee_A(X, sig, lam_p_used, desc_perms))
        self._record_factor(lmax, lam_p_used, 'pair-precision (f32+bf16)', spec, lam, m, use_E_cstr)

        A_apply = _matvec_op(tab, sig, lam, n_atoms=n_atoms, use_E_cstr=use_E_cstr)
        with timer.phase('cg'):
            M_apply = _pair_M_apply(sstrips, Dinv, G, Ls, y.shape[0], m, use_E_cstr)
            x, rel, iters = _refinement_cg(A_apply, M_apply, y, self._refine_graph(y.device), timer)
        if x is None:
            log.warning('Pair-precision refinement CG broke down before producing a finite iterate; falling back '
                        'to the f32 grid solver.')
            del M_apply, sstrips, Dinv, G, Ls
            return self._solve_grid_pcg(task, X, Jc, desc_perms, y, sig, lam, n_atoms, lmax=lmax, tab=tab)
        log.info('Refinement CG done: %d iterations, relative residual %.2e (%.1f s).', iters, rel,
                 timer.durations['cg'])
        self.t_solve = timer.durations['cg']
        self.pcg_iters = iters
        self.route = 'pair'
        return -x

    @staticmethod
    def est_memory_requirement(n_train, n_atoms, use_E_cstr=False):
        """Bytes needed on the device for the dense f64 path: K + Cholesky
        factor + solve scratch (reference formula:
        sgdml/solvers/analytic.py:153-159)."""
        n = n_train * 3 * n_atoms + (n_train if use_E_cstr else 0)
        return 3 * n**2 * 8 + n * 8

    @staticmethod
    def est_memory_inplace(n_train, n_atoms, use_E_cstr=False, n_perms=1):
        """Bytes needed on the device for the in-place f64 route
        (:meth:`_solve_inplace`): ``K`` (``8 n^2``) and the solve's four
        vectors (the labels, the two substitutions' outputs, ``alphas``),
        plus the larger of the two working sets that ``K`` holds in turn:

        * the assembly (``ops/kernel.assemble_kernel``): one tile's
          intermediates at the default tile sizes
          (``kernel.tile_peak_bytes``); the descriptors, the Jacobians and
          their ``n_perms`` permuted copies; with energy constraints, the row
          and column tiles' expanded ``(D, 3N)`` Jacobians;
        * the factor (``ops/linalg.cholesky_``): the panel solve's fresh
          ``(n - nb, nb)`` output, the ``(nb, nb)`` diagonal block, its
          factor and one more ``nb^2`` for the library's workspace.
        """
        dim_i = 3 * n_atoms
        dim_d = n_atoms * (n_atoms - 1) // 2
        n = n_train * dim_i + (n_train if use_E_cstr else 0)
        nb = min(INPLACE_BLOCK, n)
        assembly = tile_peak_bytes(n_train, n_atoms, n_perms) + (n_perms + 1) * n_train * dim_d * 4 * 8
        if use_E_cstr:
            tile_i, tile_j = default_tile_sizes(n_train, n_atoms, n_perms)
            assembly += (tile_i + tile_j) * n_perms * dim_d * dim_i * 8
        factor = ((n - nb) * nb + 3 * nb * nb) * 8
        return 8 * n * n + 4 * 8 * n + max(assembly, factor)

    @staticmethod
    def est_memory_grid(n_train, n_atoms):
        """Bytes needed on the device for the f32 packed-triangle path:
        packed triangle (n^2/2 f32) + top-level rectangle transients
        (~n^2/4)."""
        n = (-(-n_train // 8) * 8) * 3 * n_atoms
        return 3 * n**2  # (2 + 1) * n^2 bytes

    @staticmethod
    def est_memory_pair(n_train, n_atoms):
        """Bytes needed on the device for the pair-precision path. Peak =
        the repack and the CG phase: 7-slice int8 strips (3.5 bytes an
        element over the full square) + the leaf inverses (8 bytes an
        element of their blocks) + transients (the JAX package's formula)."""
        dim_i = 3 * n_atoms
        n = (-(-n_train // 8) * 8) * dim_i
        spec = blockchol.grid_spec(n, target_block=4096, align=dim_i)
        return int(3.5 * n**2 + 8 * n * spec.b + 3e8)
