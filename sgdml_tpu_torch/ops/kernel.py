"""Matern-5/2 Hessian kernel blocks and dense kernel-matrix assembly.

GDML models forces directly: the kernel between two geometries ``i`` and
``j`` is the ``3N x 3N`` block

    K_ij = J_i^T [ sum_p H_k(x_i, P_p x_j) ] J_j^(p),

where ``x`` are inverse-pairwise-distance descriptors, ``J`` their Jacobians,
``P_p`` ranges over the molecule's permutation group and ``H_k`` is the
Hessian of the Matern-5/2 kernel. With ``d = x_i - x_j``, ``u5 = sqrt5 ||d||``
and ``b = 5 exp(-u5/sig) / (3 sig^4)`` the block is

    H = b (5 d d^T - (sig^2 + sig u5) I)

(reference worker algebra: sgdml/train.py:179-232). Same functions, layouts
and results as ``sgdml_tpu.ops.kernel``; the JAX program's scans become
loops here:

* the permutation ``scan`` of a tile is a Python loop that accumulates into
  one tensor, with the multiplications done in place so that a tile holds
  about three ``(I, T, 9 N^2)`` planes at a time;
* the tile ``scan`` with ``dynamic_update_slice`` is slice assignment into a
  preallocated ``K`` on the device. Tiles are not padded: the last one of a
  row or column may be smaller, so ``K`` is written at its final size and
  the energy-constraint borders sit right after the ``M 3N`` force rows.

The Jacobian Gram term uses the closed form of :func:`gram_maps` (one
descriptor per off-diagonal atom block), so full ``(D, 3N)`` Jacobians are
never formed for the force-force blocks.

:func:`assemble_kernel_grid` assembles ``A = -K`` block by block into the
packed triangle of ``ops/blockchol.py`` (the analytic solver's grid route),
:func:`assemble_kernel_grid_pair` into the pair-float grid of
``ops/pairchol.py`` (its pair route).
:func:`assemble_kernel_columns` assembles a column subset ``K[:, cols]`` for
the iterative solver's Nystrom preconditioner, in the matmul form of
:func:`column_force_tile`, written row tile by row tile into a preallocated
tensor. Assembly is plain PyTorch (cuBLAS products and elementwise kernels)
on any device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ._precision import _true_f32
from . import ozaki
from .descriptor import incidence
from .pairchol import pair_split

__all__ = [
    'COLUMN_TILE_BUDGET_BYTES',
    'Mat52Coeffs',
    'TILE_BUDGET_BYTES',
    'assemble_kernel',
    'assemble_kernel_E_rows',
    'assemble_kernel_columns',
    'assemble_kernel_columns_range',
    'assemble_kernel_grid',
    'assemble_kernel_grid_pair',
    'column_force_tile',
    'column_tables',
    'column_tile_rows',
    'default_tile_sizes',
    'expand_perm_jacobian',
    'gram_maps',
    'hessian_tile',
    'hessian_tile_compressed',
    'perm_incidence',
    'perm_tables',
    'tile_peak_bytes',
]

_SQRT5 = math.sqrt(5.0)

# Bytes of a tile's working set as default_tile_sizes estimates it (five
# (I, T, 9 N^2) planes). The JAX package keeps 64 MB on a 16 GB TPU. On an
# 80 GB card the largest dense system (24 n^2 bytes, n ~ 57k unknowns)
# leaves 16 n^2 ~ 53 GB unused while K is assembled (the factor comes
# later), so 1 GiB fits with room to spare, and 16x the budget cuts the
# tiles, and with them the launches, 13-fold at ethanol M = 1000.
TILE_BUDGET_BYTES = 1 << 30


class Mat52Coeffs:
    """Scalar coefficient functions of the Matern-5/2 kernel family.

    ``u5`` always denotes ``sqrt(5) * ||x - x'||``.
    """

    @staticmethod
    def hess(u5, sig):
        """(b, cc): H = b * (5 d d^T) - cc * I."""
        b = 5.0 * torch.exp(-u5 / sig) / (3.0 * sig**4)
        cc = b * (sig**2 + sig * u5)
        return b, cc

    @staticmethod
    def grad(u5, sig):
        """w: grad_x k = -w * d  (w = 5 (u5 + sig) exp(-u5/sig) / (3 sig^3))."""
        return 5.0 / (3.0 * sig**3) * (u5 + sig) * torch.exp(-u5 / sig)

    @staticmethod
    def value(u5, sig):
        """k itself: (1 + u5/sig (1 + u5/(3 sig))) exp(-u5/sig)."""
        return (1.0 + (u5 / sig) * (1.0 + u5 / (3.0 * sig))) * torch.exp(-u5 / sig)


def _u5(d):
    """``sqrt(5) ||d||`` over the last axis."""
    return _SQRT5 * torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=0.0))


def perm_incidence(desc_perms: np.ndarray, n_atoms: int) -> np.ndarray:
    """Row-permuted signed incidence matrices ``(P, D, N)`` (host numpy)."""
    s = incidence(n_atoms)
    return np.stack([s[p, :] for p in np.asarray(desc_perms)], axis=0)


def perm_tables(X: torch.Tensor, Jc: torch.Tensor, desc_perms):
    """Permuted descriptor/Jacobian tables.

    X: ``(M, D)`` descriptors. Jc: ``(M, D, 3)`` compressed Jacobians.
    desc_perms: ``(P, D)`` descriptor-space permutations (host ints).

    Returns ``Xp (M, P, D)`` with ``Xp[m, p] = X[m][desc_perms[p]]`` and
    ``Jcp (M, P, D, 3)``; the permuted *full* Jacobian of ``(m, p)`` is
    ``S_p (.) Jcp[m, p]`` with ``S_p = perm_incidence(...)[p]``.
    """
    dp = torch.as_tensor(np.asarray(desc_perms), dtype=torch.int64, device=X.device)
    return X[:, dp], Jc[:, dp, :]


def expand_perm_jacobian(Jcp: torch.Tensor, s_perm: torch.Tensor) -> torch.Tensor:
    """Expand permuted compressed Jacobians ``(..., P, D, 3)`` to full
    ``(..., P, D, 3N)`` using the permuted incidence ``s_perm (P, D, N)``."""
    full = torch.einsum('pdn,...pdc->...pdnc', s_perm, Jcp)
    return full.reshape(*full.shape[:-2], full.shape[-2] * 3)


def hessian_tile(Xi, Ji, Xt, Jt, sig):
    """Kernel Hessian blocks from full Jacobians.

    Xi: ``(I, D)``, Ji: ``(I, D, 3N)`` row descriptors and Jacobians; Xt:
    ``(T, D)``, Jt: ``(T, D, 3N)`` column tables (already permuted).
    Returns ``(I, 3N, T, 3N)``: ``out[i, :, t, :] = J_i^T H(x_i, x_t) J_t``.
    """
    d = Xi[:, None, :] - Xt[None, :, :]
    b, cc = Mat52Coeffs.hess(_u5(d), sig)
    a = torch.einsum('itd,idx->itx', d, Ji)  # J_i^T d
    c = torch.einsum('itd,tdy->ity', d, Jt)  # d^T J_t
    g = torch.einsum('idx,tdy->ixty', Ji, Jt)  # Jacobian Gram
    k1 = (5.0 * b)[:, :, None, None] * a[:, :, :, None] * c[:, :, None, :]
    return k1.permute(0, 2, 1, 3) - cc[:, None, :, None] * g


@functools.lru_cache(maxsize=None)
def _gram_maps_cached(desc_perms_key, n_atoms: int):
    desc_perms = np.frombuffer(desc_perms_key[0], dtype=np.int64).reshape(desc_perms_key[1])
    return gram_maps(desc_perms, n_atoms)


def gram_maps(desc_perms: np.ndarray, n_atoms: int):
    """Static index maps for the closed-form Jacobian Gram (host numpy).

    The Gram block between row geometry ``i`` (identity descriptor order)
    and permuted column geometry ``t`` is

        G[(m,a),(n,b)] = sum_d s[d,m] s_p[d,n] Jc_i[d,a] Jc_t[d,b],

    and ``s[d,m] s_p[d,n] != 0`` only when atom ``m`` is in pair(d) and atom
    ``n`` is in pair(perm_p(d)). For ``n != pi_p(m)`` exactly ONE descriptor
    contributes; for ``n == pi_p(m)`` all ``N-1`` descriptors through ``m``
    do. So G is one static gather plus one small row reduction.

    Returns per permutation ``p`` (stacked along axis 0):
    g_idx: ``(P, N*N)`` int32 -- contributing descriptor per (m, n) block
        (unused value 0 at the ``n == pi_p(m)`` slots).
    sgn: ``(P, N*N)`` -- sign ``s[d,m] * s_p[d,n]`` (0 at diagonal slots).
    a_diag: ``(P, N, D)`` -- signed row reduction for the ``n == pi_p(m)``
        blocks: ``A[m, d] = s[d, m] * s_p[d, pi_p(m)]``.
    diag_col: ``(P, N)`` int32 -- ``pi_p(m)``.
    """
    desc_perms = np.asarray(desc_perms)
    n_perms = desc_perms.shape[0]
    s = incidence(n_atoms)  # (D, N)
    dim_d = s.shape[0]
    g_idx = np.zeros((n_perms, n_atoms * n_atoms), dtype=np.int32)
    sgn = np.zeros((n_perms, n_atoms * n_atoms))
    a_diag = np.zeros((n_perms, n_atoms, dim_d))
    diag_col = np.zeros((n_perms, n_atoms), dtype=np.int32)

    b1 = (s != 0).T  # (N, D) atom-in-pair
    for p in range(n_perms):
        s_p = s[desc_perms[p]]  # (D, N)
        b2 = (s_p != 0).T  # (N, D)
        # hits[m, n, d] -- does descriptor d touch row-atom m and col-atom n?
        hits = b1[:, None, :] & b2[None, :, :]
        counts = hits.sum(axis=2)  # (N, N) in {1, N-1}
        if not np.all((counts == 1) | (counts == n_atoms - 1)):
            raise ValueError('inconsistent permutation incidence structure')
        dc = np.argmax(counts, axis=1)  # pi_p(m); unique since N-1 > 1
        diag_col[p] = dc
        g = np.argmax(hits, axis=2)  # unique d where counts == 1
        g_idx[p] = g.reshape(-1)
        sg = s[g, np.arange(n_atoms)[:, None]] * s_p[g, np.arange(n_atoms)[None, :]]
        sg[np.arange(n_atoms), dc] = 0.0
        sgn[p] = sg.reshape(-1)
        a_diag[p] = (s * s_p[:, dc]).T  # A[m, d] = s[d, m] * s_p[d, pi(m)]
    return g_idx, sgn, a_diag, diag_col


def _perms_key(desc_perms):
    """Hashable key for a permutation table."""
    arr = np.ascontiguousarray(np.asarray(desc_perms, dtype=np.int64))
    return (arr.tobytes(), arr.shape)


@functools.lru_cache(maxsize=None)
def _tile_constants(desc_perms_key, n_atoms: int, device: torch.device, dtype: torch.dtype):
    """``(s, s_perm, g_idx, sgn, a_diag, diag_col)`` as tensors on ``device``
    -- the last nine arguments of :func:`hessian_tile_compressed`."""
    desc_perms = np.frombuffer(desc_perms_key[0], dtype=np.int64).reshape(desc_perms_key[1])
    g_idx, sgn, a_diag, diag_col = _gram_maps_cached(desc_perms_key, n_atoms)

    def floats(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def ints(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    return (floats(incidence(n_atoms)), floats(perm_incidence(desc_perms, n_atoms)),
            ints(g_idx), floats(sgn), floats(a_diag), ints(diag_col))


def _check_mm(mm: str, dtype):
    if mm not in ('native', 'ozaki'):
        raise ValueError("mm must be 'native' or 'ozaki', got %r" % (mm,))
    if mm == 'ozaki' and dtype != torch.float64:
        raise ValueError("mm='ozaki' takes float64 tiles (its products come out in float64), got %s" % dtype)


def _perm_summed_tile(Xi, Jci, Xtp, Jctp, sig, s, s_perm, g_idx, sgn, a_diag, diag_col, mm='native'):
    """Perm-summed Hessian blocks in the layout ``(I, T, N, 3, N, 3)``;
    ``mm='ozaki'`` takes the three D-contractions as Ozaki products."""
    dim_i, dim_t = Xi.shape[0], Xtp.shape[0]
    dim_d, n_atoms = s.shape
    atom_ids = torch.arange(n_atoms, device=Xi.device)
    jci_t = Jci.transpose(1, 2)  # (I, 3, D)
    acc = None
    for p in range(s_perm.shape[0]):
        xt, jct = Xtp[:, p], Jctp[:, p]  # (T, D), (T, D, 3)
        d = Xi[:, None, :] - xt[None, :, :]  # (I, T, D)
        b, cc = Mat52Coeffs.hess(_u5(d), sig)  # (I, T)

        # Gradient contractions through the incidence factorization.
        wa = Jci[:, None] * d[..., None]  # (I, T, D, 3)
        wc = jct[None] * d[..., None]
        # Diagonal-slot blocks: row reduction over the descriptors through m.
        t1 = a_diag[p][None, :, None, :] * jci_t[:, None, :, :]  # (I, N, 3, D)
        if mm == 'ozaki':  # 7 slices, as sgdml_tpu/ops/kernel.py:256-263
            oz = ozaki.ozaki_gemm_nt_f64
            a = oz(wa.transpose(2, 3).reshape(-1, dim_d), s.T, 7).view(dim_i, dim_t, 3, n_atoms).transpose(2, 3)
            c = oz(wc.transpose(2, 3).reshape(-1, dim_d), s_perm[p].T, 7).view(
                dim_i, dim_t, 3, n_atoms).transpose(2, 3)
            t2 = oz(t1.reshape(-1, dim_d), jct.transpose(1, 2).reshape(-1, dim_d), 7).view(
                dim_i, n_atoms, 3, dim_t, 3).permute(0, 3, 1, 2, 4)
        else:
            a = torch.einsum('dm,itdc->itmc', s, wa)  # (I, T, N, 3)
            c = torch.einsum('dn,itdc->itnc', s_perm[p], wc)
            t2 = torch.einsum('imad,tdb->itmab', t1, jct)  # (I, T, N, 3, 3)

        # Off-diagonal blocks: one descriptor each -- gather, then outer
        # product; the diagonal slots are overwritten with t2.
        gf = g_idx[p]
        gram = Jci.index_select(1, gf)[:, None, :, :, None] * jct.index_select(1, gf)[None, :, :, None, :]
        gram.mul_(sgn[p][None, None, :, None, None])
        gram = gram.view(dim_i, dim_t, n_atoms, n_atoms, 3, 3)
        gram[:, :, atom_ids, diag_col[p]] = t2
        gram.mul_(cc[:, :, None, None, None, None])

        k1 = ((5.0 * b)[:, :, None, None] * a).reshape(dim_i, dim_t, -1, 1) * c.reshape(dim_i, dim_t, 1, -1)
        k1 = k1.view(dim_i, dim_t, n_atoms, 3, n_atoms, 3)
        k1.sub_(gram.permute(0, 1, 2, 4, 3, 5))
        acc = k1 if acc is None else acc.add_(k1)
    return acc


def hessian_tile_compressed(
    Xi, Jci, Xtp, Jctp, sig, s, s_perm, g_idx, sgn, a_diag, diag_col, mm='native',
):
    """Perm-summed kernel Hessian blocks from *compressed* Jacobians.

    Same math as :func:`hessian_tile`, with the Jacobian Gram term from the
    closed form of :func:`gram_maps`.

    Xi: ``(I, D)`` row descriptors. Jci: ``(I, D, 3)`` compressed row
    Jacobians. Xtp: ``(T, P, D)`` permuted column descriptors. Jctp: ``(T, P,
    D, 3)`` permuted compressed column Jacobians. s: ``(D, N)`` incidence.
    s_perm: ``(P, D, N)`` permuted incidences. g_idx/sgn/a_diag/diag_col:
    :func:`gram_maps` as tensors (index tables int64). ``mm='ozaki'`` runs
    the three D-contractions (the gradient contractions ``a``, ``c`` and the
    diagonal-slot Gram ``t2``) as 7-slice Ozaki int8 products over (f32, f32)
    pairs, on float64 tiles (``sgdml_tpu/ops/kernel.py:253-287``).

    Returns ``(I, 3N, T, 3N)``, summed over the permutations.
    """
    _check_mm(mm, Xi.dtype)
    acc = _perm_summed_tile(Xi, Jci, Xtp, Jctp, sig, s, s_perm, g_idx, sgn, a_diag, diag_col, mm=mm)
    dim_i, dim_t, n_atoms = acc.shape[0], acc.shape[1], acc.shape[2]
    return acc.permute(0, 2, 3, 1, 4, 5).reshape(dim_i, 3 * n_atoms, dim_t, 3 * n_atoms)


def _grad_row_tile(Xi, Xt, Jt, sig):
    """Energy-force coupling rows: ``out[i, t, :] = -w(d) d^T J_t`` with
    ``d = x_i - x_t`` (reference sgdml/train.py:235-248). Shape (I, T, 3N)."""
    d = Xi[:, None, :] - Xt[None, :, :]
    w = Mat52Coeffs.grad(_u5(d), sig)
    return -torch.einsum('itd,tdy->ity', w[..., None] * d, Jt)


def _value_tile(Xi, Xt, sig):
    """Energy-energy entries: ``out[i, t] = -k(x_i, x_t)``
    (reference sgdml/train.py:298-300). Shape (I, T)."""
    d = Xi[:, None, :] - Xt[None, :, :]
    return -Mat52Coeffs.value(_u5(d), sig)


def _pair_bytes(n_atoms: int, dtype_bytes: int) -> int:
    """A tile's bytes per (row, column) pair: five ``9 N^2`` planes and
    eight D-vectors."""
    dim_d = (n_atoms * (n_atoms - 1)) // 2
    return (5 * 9 * n_atoms * n_atoms + 8 * dim_d) * dtype_bytes


def _tile_sizes(m: int, n_atoms: int, budget: int, dtype_bytes: int):
    """(tile_i, tile_j) whose tile keeps each intermediate near ``budget``
    bytes: a few ``9 N^2`` planes and D-vectors per (row, column) pair."""
    per_pair = _pair_bytes(n_atoms, dtype_bytes)
    pairs = max(1, budget // per_pair)
    tile = max(1, int(math.sqrt(pairs)))
    return min(m, tile), min(m, max(1, pairs // tile))


def default_tile_sizes(m: int, n_atoms: int, n_perms: int, dtype_bytes: int = 8):
    """Pick (tile_i, tile_j) for :data:`TILE_BUDGET_BYTES`.

    The permutation axis is a loop, so it does not multiply tile memory.
    The per-pair estimate counts five ``9 N^2`` planes; the tile itself holds
    about three at a time (the accumulator, the Gram planes and the outer
    product), so the estimate bounds the peak from above.
    """
    del n_perms
    return _tile_sizes(m, n_atoms, TILE_BUDGET_BYTES, dtype_bytes)


def tile_peak_bytes(m: int, n_atoms: int, n_perms: int, dtype_bytes: int = 8) -> int:
    """Bytes that bound one :func:`assemble_kernel` tile's intermediates at
    :func:`default_tile_sizes`: the per-pair estimate over the tile's pairs."""
    ti, tj = default_tile_sizes(m, n_atoms, n_perms, dtype_bytes)
    return ti * tj * _pair_bytes(n_atoms, dtype_bytes)


def assemble_kernel(
    R_desc, R_d_desc, desc_perms, sig, n_atoms,
    use_E_cstr: bool = False, tile_i: int | None = None, tile_j: int | None = None,
):
    """Assemble the full (s)GDML kernel matrix on the inputs' device.

    Parameters
    ----------
    R_desc: ``(M, D)`` training descriptors (tensor).
    R_d_desc: ``(M, D, 3)`` compressed training Jacobians (tensor).
    desc_perms: ``(P, D)`` descriptor permutations (host numpy ints).
    sig: kernel length scale. n_atoms: N.
    use_E_cstr: append M energy-constraint rows/columns
        (reference sgdml/train.py:235-300).
    tile_i, tile_j: geometries per row/column tile (default
        :func:`default_tile_sizes`); the last tile of each may be smaller.

    Returns
    -------
    ``(M*3N [+M], M*3N [+M])`` kernel matrix in the inputs' dtype (same sign
    convention as the reference's assembled K, i.e. *before* the solver's
    global sign flip).
    """
    X, Jc = R_desc, R_d_desc
    m, dim_d = X.shape
    dim_i = 3 * n_atoms
    key = _perms_key(desc_perms)
    n_perms = key[1][0]
    if tile_i is None or tile_j is None:
        ti, tj = default_tile_sizes(m, n_atoms, n_perms, X.element_size())
        tile_i, tile_j = tile_i or ti, tile_j or tj
    consts = _tile_constants(key, n_atoms, X.device, X.dtype)
    s_perm = consts[1]
    Xp, Jcp = perm_tables(X, Jc, desc_perms)  # (M, P, D), (M, P, D, 3)

    n_f = m * dim_i
    n_total = n_f + (m if use_E_cstr else 0)
    K = torch.empty((n_total, n_total), dtype=X.dtype, device=X.device)
    for i0 in range(0, m, tile_i):
        i1 = min(m, i0 + tile_i)
        rows = slice(i0 * dim_i, i1 * dim_i)
        for j0 in range(0, m, tile_j):
            j1 = min(m, j0 + tile_j)
            cols = slice(j0 * dim_i, j1 * dim_i)
            blk = _perm_summed_tile(X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], sig, *consts)
            K[rows, cols].view(i1 - i0, n_atoms, 3, j1 - j0, n_atoms, 3).copy_(
                blk.permute(0, 2, 3, 1, 4, 5))
            if not use_E_cstr:
                continue
            # Energy rows under force columns: -grad_x k(x_i, x_t)^T J_t.
            Jt = expand_perm_jacobian(Jcp[j0:j1], s_perm).reshape(-1, dim_d, dim_i)
            fe = _grad_row_tile(X[i0:i1], Xp[j0:j1].reshape(-1, dim_d), Jt, sig)
            K[n_f + i0:n_f + i1, cols] = fe.reshape(i1 - i0, j1 - j0, n_perms, dim_i).sum(2).reshape(
                i1 - i0, -1)
            # Force rows under energy columns: -w(d') d'^T J_i with
            # d' = x_j - x_i^p (the permutations act on the row side).
            Jit = expand_perm_jacobian(Jcp[i0:i1], s_perm).reshape(-1, dim_d, dim_i)
            Xit = Xp[i0:i1].reshape(-1, dim_d)
            ef = _grad_row_tile(X[j0:j1], Xit, Jit, sig).reshape(j1 - j0, i1 - i0, n_perms, dim_i).sum(2)
            K[rows, n_f + j0:n_f + j1] = ef.permute(1, 2, 0).reshape(-1, j1 - j0)
            # Energy-energy block: -sum_p k(x_j, x_i^p).
            ee = _value_tile(X[j0:j1], Xit, sig).reshape(j1 - j0, i1 - i0, n_perms).sum(2)
            K[n_f + i0:n_f + i1, n_f + j0:n_f + j1] = ee.T
    return K


def _grid_block_fn(R_desc, R_d_desc, desc_perms, sig, n_atoms, spec, dtype, tile_i, tile_j, mm):
    """``block(bi, bj)``: the ``(b, b)`` block ``(bi, bj)`` of ``A = -K``
    in ``dtype``, written tile by tile (the shared loop of
    :func:`assemble_kernel_grid` and :func:`assemble_kernel_grid_pair`)."""
    _check_mm(mm, dtype)
    dim_i = 3 * n_atoms
    if spec.b % dim_i != 0:
        raise ValueError('grid blocks must be aligned to 3*n_atoms')
    m = R_desc.shape[0]
    b_pts = spec.b // dim_i
    X, Jc = R_desc.to(dtype), R_d_desc.to(dtype)
    key = _perms_key(desc_perms)
    if tile_i is None or tile_j is None:
        ti, tj = default_tile_sizes(spec.n // dim_i, n_atoms, key[1][0], X.element_size())
        tile_i, tile_j = tile_i or ti, tile_j or tj
    tile_i, tile_j = min(tile_i, b_pts), min(tile_j, b_pts)
    consts = _tile_constants(key, n_atoms, X.device, dtype)
    Xp, Jcp = perm_tables(X, Jc, desc_perms)

    def block(bi, bj):
        out = torch.zeros((spec.b, spec.b), dtype=dtype, device=X.device)
        p0, q0 = bi * b_pts, bj * b_pts
        for i0 in range(p0, min(m, p0 + b_pts), tile_i):
            i1 = min(m, p0 + b_pts, i0 + tile_i)
            for j0 in range(q0, min(m, q0 + b_pts), tile_j):
                j1 = min(m, q0 + b_pts, j0 + tile_j)
                blk = _perm_summed_tile(X[i0:i1], Jc[i0:i1], Xp[j0:j1], Jcp[j0:j1], sig, *consts, mm=mm)
                out[(i0 - p0) * dim_i:(i1 - p0) * dim_i, (j0 - q0) * dim_i:(j1 - q0) * dim_i].view(
                    i1 - i0, n_atoms, 3, j1 - j0, n_atoms, 3).copy_(blk.permute(0, 2, 3, 1, 4, 5)).neg_()
        if bi == bj and p0 + b_pts > m:
            out.diagonal()[max(0, m - p0) * dim_i:] = 1.0
        return out

    return block


def assemble_kernel_grid(
    R_desc, R_d_desc, desc_perms, sig, n_atoms, spec, dtype=torch.float32,
    tile_i: int | None = None, tile_j: int | None = None, mm: str = 'native',
):
    """Assemble ``A = -K`` (force block only) into the block-grid packed
    triangle of ``ops/blockchol.py``, on the inputs' device, in ``dtype``.

    ``spec.n`` counts ``m_pad >= M`` points of ``3N`` rows each and
    ``spec.b`` must be a multiple of ``3N``. Rows and columns of the padded
    points are zero, and the padded diagonal is 1, so the padded system
    stays SPD. Each ``(b, b)`` block is written tile by tile (``tile_i`` x
    ``tile_j`` points, default :func:`default_tile_sizes` in ``dtype``,
    capped at the block's points; edge tiles are smaller). float32 blocks
    are computed from float32 descriptors with TF32 off. ``mm`` goes to
    :func:`hessian_tile_compressed` (``'ozaki'`` takes float64). Same
    layout and values as ``sgdml_tpu.ops.kernel.assemble_kernel_grid``.
    """
    block = _grid_block_fn(R_desc, R_d_desc, desc_perms, sig, n_atoms, spec, dtype, tile_i, tile_j, mm)
    with _true_f32(dtype):
        return [[block(i, j) for j in range(i + 1)] for i in range(spec.k)]


def assemble_kernel_grid_pair(
    R_desc, R_d_desc, desc_perms, sig, n_atoms, spec,
    tile_i: int | None = None, tile_j: int | None = None, mm: str = 'native',
):
    """Assemble ``A = -K`` straight into pair-float (f32 hi, bf16 lo)
    block-grid storage (``ops/pairchol.py``): each ``(b, b)`` block is
    computed in f64 by :func:`assemble_kernel_grid`'s loop and split as soon
    as it is made, so the f64 triangle never exists whole. About 33-bit
    entries let the pair Cholesky's stability shift sit at the pair-storage
    floor instead of f32 entry noise. Returns ``(Ghi, Glo)``; same layout
    and values as ``sgdml_tpu.ops.kernel.assemble_kernel_grid_pair``.
    """
    block = _grid_block_fn(R_desc, R_d_desc, desc_perms, sig, n_atoms, spec, torch.float64, tile_i, tile_j, mm)
    Ghi, Glo = [], []
    for i in range(spec.k):
        pairs = [pair_split(block(i, j)) for j in range(i + 1)]
        Ghi.append([p[0] for p in pairs])
        Glo.append([p[1] for p in pairs])
    return Ghi, Glo


def column_tables(X, Jc, desc_perms, col_3n_idxs, n_atoms, s_perm):
    """Column-side tables for a force-column subset.

    Column ``c = (j, q)``: training point ``j = c // 3N``, partial ``q = c %
    3N``. Returns ``(Xjp (C, P, D), Jt_col (C, P, D))``: the permuted
    descriptors of the column points and their permuted Jacobian restricted
    to the one partial ``q = (atom, xyz)`` of each column, through the
    incidence factorization ``J[d, 3n + y] = s_perm[p, d, n] Jc[p, d, y]``,
    so that no full ``(C, P, D, 3N)`` Jacobian is formed.
    """
    dim_i = 3 * n_atoms
    cols = torch.as_tensor(np.asarray(col_3n_idxs), dtype=torch.int64, device=X.device)
    dp = torch.as_tensor(np.asarray(desc_perms), dtype=torch.int64, device=X.device)
    col_j, col_q = cols // dim_i, cols % dim_i
    Xjp = X[col_j][:, dp]  # (C, P, D)
    j_sel = Jc[col_j, :, col_q % 3][:, dp]  # (C, P, D)
    s_sel = s_perm.index_select(2, col_q // 3).permute(2, 0, 1)  # (C, P, D)
    return Xjp, s_sel * j_sel


def column_force_tile(Xi, Jci, Xjp, Jt_col, s_id, sig):
    """Force-block rows of ``K[:, cols]`` for one row tile.

    ``Xi (I, D)`` / ``Jci (I, D, 3)`` are the row points' tables; the column
    tables come from :func:`column_tables`. Returns ``(blk (I 3N, C), u5 (I,
    C, P), cj (I, C, P))``; the last two feed the energy-constraint rows.

    Everything that involves ``d = x_i - x_c^p`` is in matmul form: ``|d|^2 =
    |x_i|^2 + |x_c^p|^2 - 2 x_i.x_c^p`` and the Jacobian contractions as a
    self term plus one ``(C P, D) x (D, I 3N)`` product each, so the ``(I, C,
    P, D)`` difference tensor never exists. The two products are weighted and
    summed over the permutations in place.
    """
    tile_i, dim_d = Xi.shape
    dim_i = 3 * s_id.shape[1]
    n_cols, n_perms = Xjp.shape[:2]
    Ji = torch.einsum('dn,idc->idnc', s_id, Jci).reshape(tile_i, dim_d, dim_i)

    Xj_flat = Xjp.reshape(n_cols * n_perms, dim_d)
    Jt_flat = Jt_col.reshape(n_cols * n_perms, dim_d)

    cross = (Xi @ Xj_flat.T).view(tile_i, n_cols, n_perms)
    d2 = torch.sum(Xi * Xi, dim=-1)[:, None, None] + torch.sum(Xjp * Xjp, dim=-1)[None] - 2.0 * cross
    u5 = _SQRT5 * torch.sqrt(torch.clamp(d2, min=0.0))
    b, cc = Mat52Coeffs.hess(u5, sig)  # (I, C, P)
    cj = (Xi @ Jt_flat.T).view(tile_i, n_cols, n_perms) - torch.sum(Xjp * Jt_col, dim=-1)[None]

    # J_i^T d = J_i^T x_i - J_i^T x_c^p, and g = (J_i^T J_t)[:, q], in
    # (c, p, i, x) layout.
    a_self = torch.einsum('id,idx->ix', Xi, Ji)  # (I, X)
    Ji_mat = Ji.permute(1, 0, 2).reshape(dim_d, tile_i * dim_i)
    a_cross = (Xj_flat @ Ji_mat).view(n_cols, n_perms, tile_i, dim_i)
    g = (Jt_flat @ Ji_mat).view(n_cols, n_perms, tile_i, dim_i)

    w1 = 5.0 * b * cj  # (I, C, P)
    # blk[i, c, x] = sum_p w1 a_self - sum_p (w1 a_cross + cc g)
    a_cross.mul_(w1.permute(1, 2, 0)[..., None]).addcmul_(g, cc.permute(1, 2, 0)[..., None])
    blk = w1.sum(2).T[:, :, None] * a_self[None] - a_cross.sum(1)  # (C, I, X)
    return blk.permute(1, 2, 0).reshape(tile_i * dim_i, n_cols), u5, cj


# Bytes of a column tile's working set as column_tile_rows estimates it: two
# (C, P, I, 3N) products and three (I, C, 3N) planes. The JAX package keeps
# 1.5 GB on a 16 GB TPU. On an 80 GB card the one-pass Nystrom build's peak is
# 16 bytes per factor element, capped at 40% of the budget
# (solvers/iterative.py, max_n_inducing_pts); while the columns are assembled
# only they exist (8 bytes per element, at most 20% of it), so 4 GiB of staging
# stays under the build's later peak.
COLUMN_TILE_BUDGET_BYTES = 4 << 30


def column_tile_rows(m, n_cols, n_atoms, n_perms, dtype_bytes=8, budget=None):
    """Row points per column tile for ``budget`` bytes (default
    :data:`COLUMN_TILE_BUDGET_BYTES`): ``(2 P + 3) C 3N`` elements a row."""
    budget = COLUMN_TILE_BUDGET_BYTES if budget is None else budget
    per_row = (2 * n_perms + 3) * n_cols * 3 * n_atoms * dtype_bytes
    return max(1, min(m, int(budget // max(per_row, 1))))


def assemble_kernel_columns(
    R_desc, R_d_desc, desc_perms, sig, n_atoms, col_3n_idxs,
    tile_i: int | None = None, use_E_cstr: bool = False,
):
    """``K[:, cols]`` for flat force-column indices ``col_3n_idxs`` into the
    ``M 3N`` axis (the Nystrom preconditioner's inducing columns), on the
    inputs' device. With ``use_E_cstr`` the M energy-constraint rows are
    appended; the columns stay force columns.

    Row tiles of ``tile_i`` points (default :func:`column_tile_rows`) are
    written into a preallocated ``(M 3N [+M], C)`` tensor, the last tile
    ragged. Same layout and values as ``sgdml_tpu.ops.kernel``'s.
    """
    X, Jc = R_desc, R_d_desc
    m = X.shape[0]
    dim_i = 3 * n_atoms
    n_cols = int(np.asarray(col_3n_idxs).shape[0])
    key = _perms_key(desc_perms)
    if tile_i is None:
        tile_i = column_tile_rows(m, n_cols, n_atoms, key[1][0], X.element_size())
    s_id, s_perm = _tile_constants(key, n_atoms, X.device, X.dtype)[:2]
    Xjp, Jt_col = column_tables(X, Jc, desc_perms, col_3n_idxs, n_atoms, s_perm)

    n_f = m * dim_i
    K = torch.empty((n_f + (m if use_E_cstr else 0), n_cols), dtype=X.dtype, device=X.device)
    for i0 in range(0, m, tile_i):
        i1 = min(m, i0 + tile_i)
        blk, u5, cj = column_force_tile(X[i0:i1], Jc[i0:i1], Xjp, Jt_col, s_id, sig)
        K[i0 * dim_i:i1 * dim_i] = blk
        if use_E_cstr:
            # Energy-constraint rows under the force columns:
            # K[E_off + i, (j, q)] = -sum_p w(u) (d^T J_t[:, q]).
            K[n_f + i0:n_f + i1] = -torch.sum(Mat52Coeffs.grad(u5, sig) * cj, dim=2)
    return K


def assemble_kernel_columns_range(
    X, Jc, desc_perms, sig, n_atoms, col_3n_idxs, row_p0: int, row_cnt: int, m_real: int,
    tile_i: int | None = None,
):
    """Force rows ``K[row_p0 3N : (row_p0 + row_cnt) 3N, cols]`` of the
    kernel: one chunk of the streamed Nystrom build, whose full ``(n, k)``
    column block never exists (``sgdml_tpu/ops/kernel.py:1047-1124``).

    ``X``/``Jc`` hold at least the ``m_real`` real points; rows of points at
    or past ``m_real`` (a sweep's padded tail) are zero and never read.
    Returns ``(row_cnt 3N, len(cols))``, in row tiles of ``tile_i`` points
    (default :func:`column_tile_rows`).
    """
    dim_i = 3 * n_atoms
    n_cols = int(np.asarray(col_3n_idxs).shape[0])
    key = _perms_key(desc_perms)
    if tile_i is None:
        tile_i = column_tile_rows(row_cnt, n_cols, n_atoms, key[1][0], X.element_size())
    s_id, s_perm = _tile_constants(key, n_atoms, X.device, X.dtype)[:2]
    Xjp, Jt_col = column_tables(X, Jc, desc_perms, col_3n_idxs, n_atoms, s_perm)
    K = torch.zeros((row_cnt * dim_i, n_cols), dtype=X.dtype, device=X.device)
    for i0 in range(row_p0, min(m_real, row_p0 + row_cnt), tile_i):
        i1 = min(m_real, row_p0 + row_cnt, i0 + tile_i)
        K[(i0 - row_p0) * dim_i:(i1 - row_p0) * dim_i] = column_force_tile(
            X[i0:i1], Jc[i0:i1], Xjp, Jt_col, s_id, sig)[0]
    return K


def assemble_kernel_E_rows(R_desc, R_d_desc, desc_perms, sig, n_atoms, col_3n_idxs, tile_i: int = 64):
    """The ``(M, k)`` energy-constraint rows of ``K[:, cols]`` for force
    columns, ``K[E_off + i, (j, q)] = -sum_p w(u) (d^T J_t[:, q])``
    (reference: sgdml/train.py:235-248), alone: the streamed build borders
    its slice stack with them (``sgdml_tpu/ops/kernel.py:975-1044``).

    In matmul form (``|x_i - x_c^p|^2`` and ``d^T J_t`` by norm expansion),
    so no ``(I, C, P, D)`` difference tensor exists; row tiles of
    ``tile_i`` points.
    """
    X = R_desc
    m = X.shape[0]
    s_perm = _tile_constants(_perms_key(desc_perms), n_atoms, X.device, X.dtype)[1]
    Xjp, Jt_col = column_tables(X, R_d_desc, desc_perms, col_3n_idxs, n_atoms, s_perm)
    n_cols, n_perms, dim_d = Xjp.shape
    Xj_flat = Xjp.reshape(n_cols * n_perms, dim_d)
    Jt_flat = Jt_col.reshape(n_cols * n_perms, dim_d)
    Xj2 = torch.sum(Xjp * Xjp, dim=-1)  # (C, P)
    jdot = torch.sum(Xjp * Jt_col, dim=-1)  # (C, P): x_c^p . J_t[:, q]
    out = torch.empty((m, n_cols), dtype=X.dtype, device=X.device)
    for i0 in range(0, m, tile_i):
        Xi = X[i0:i0 + tile_i]
        cross = (Xi @ Xj_flat.T).view(-1, n_cols, n_perms)
        d2 = torch.sum(Xi * Xi, dim=-1)[:, None, None] + Xj2[None] - 2 * cross
        w = Mat52Coeffs.grad(_SQRT5 * torch.sqrt(torch.clamp(d2, min=0.0)), sig)  # (I, C, P)
        cj = (Xi @ Jt_flat.T).view(-1, n_cols, n_perms) - jdot[None]
        out[i0:i0 + tile_i] = -torch.sum(w * cj, dim=-1)
    return out
