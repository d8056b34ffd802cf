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
never formed for the force-force blocks. Assembly is plain PyTorch (cuBLAS
products and elementwise kernels) on any device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .descriptor import incidence

__all__ = [
    'Mat52Coeffs',
    'TILE_BUDGET_BYTES',
    'assemble_kernel',
    'default_tile_sizes',
    'expand_perm_jacobian',
    'gram_maps',
    'hessian_tile',
    'hessian_tile_compressed',
    'perm_incidence',
    'perm_tables',
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


def _check_mm(mm: str):
    if mm != 'native':
        raise NotImplementedError(
            "mm=%r: the int8 Ozaki products are ROADMAP queue 1 item 11 "
            "(ops/ozaki.py and the int8 routes); only mm='native' is ported" % mm
        )


def _perm_summed_tile(Xi, Jci, Xtp, Jctp, sig, s, s_perm, g_idx, sgn, a_diag, diag_col):
    """Perm-summed Hessian blocks in the layout ``(I, T, N, 3, N, 3)``."""
    dim_i, dim_t = Xi.shape[0], Xtp.shape[0]
    n_atoms = s.shape[1]
    atom_ids = torch.arange(n_atoms, device=Xi.device)
    jci_t = Jci.transpose(1, 2)  # (I, 3, D)
    acc = None
    for p in range(s_perm.shape[0]):
        xt, jct = Xtp[:, p], Jctp[:, p]  # (T, D), (T, D, 3)
        d = Xi[:, None, :] - xt[None, :, :]  # (I, T, D)
        b, cc = Mat52Coeffs.hess(_u5(d), sig)  # (I, T)

        # Gradient contractions through the incidence factorization.
        a = torch.einsum('dm,itdc->itmc', s, Jci[:, None] * d[..., None])  # (I, T, N, 3)
        c = torch.einsum('dn,itdc->itnc', s_perm[p], jct[None] * d[..., None])

        # Diagonal-slot blocks: row reduction over the descriptors through m.
        t1 = a_diag[p][None, :, None, :] * jci_t[:, None, :, :]  # (I, N, 3, D)
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
    :func:`gram_maps` as tensors (index tables int64). Only ``mm='native'``
    is ported.

    Returns ``(I, 3N, T, 3N)``, summed over the permutations.
    """
    _check_mm(mm)
    acc = _perm_summed_tile(Xi, Jci, Xtp, Jctp, sig, s, s_perm, g_idx, sgn, a_diag, diag_col)
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


def _tile_sizes(m: int, n_atoms: int, budget: int, dtype_bytes: int):
    """(tile_i, tile_j) whose tile keeps each intermediate near ``budget``
    bytes: a few ``9 N^2`` planes and D-vectors per (row, column) pair."""
    dim_d = (n_atoms * (n_atoms - 1)) // 2
    per_pair = (5 * 9 * n_atoms * n_atoms + 8 * dim_d) * dtype_bytes
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
