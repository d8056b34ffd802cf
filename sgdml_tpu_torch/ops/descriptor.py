"""Inverse-pairwise-distance descriptor and its Jacobian, in PyTorch.

The descriptor of a geometry ``r`` (N atoms) is ``x_p = 1 / ||r_a - r_b||``
for every unordered atom pair ``p = (a, b)`` with ``a > b`` in
``numpy.tril_indices`` order, giving dimension ``D = N (N - 1) / 2``
(reference: sgdml/utils/desc.py:80-239), with the minimum-image convention
for periodic systems (reference: sgdml/utils/desc.py:44-77).

The full Jacobian ``J in R^{D x 3N}`` is never stored. It factorizes as
``J[p, (n, c)] = S[p, n] * Jc[p, c]`` with the static signed incidence
matrix ``S (D, N)`` (``S[p, b] = +1``, ``S[p, a] = -1``) and the compressed
Jacobian ``Jc (D, 3)``, so every Jacobian contraction is a matmul against
``S``. Same functions and layouts as ``sgdml_tpu.ops.descriptor``; batches
are a leading dimension written out where the JAX package uses ``vmap``.
The static index tables stay numpy; their tensors are cached per
``(n_atoms, device, dtype)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    'descriptor_dim',
    'tril_pairs',
    'incidence',
    'descriptor',
    'descriptor_jacobian',
    'descriptor_batch',
    'jacobian_full',
    'jac_dot_vec',
    'vec_dot_jac',
    'perm_to_desc_perm',
    'pbc_diff',
]


def descriptor_dim(n_atoms: int) -> int:
    """Descriptor dimension ``D = N(N-1)/2``."""
    return (n_atoms * (n_atoms - 1)) // 2


@functools.lru_cache(maxsize=None)
def tril_pairs(n_atoms: int) -> np.ndarray:
    """Static ``(D, 2)`` int array of atom pairs ``(a, b)``, ``a > b``.

    Pair ordering matches ``numpy.tril_indices(n, k=-1)`` (row-major:
    (1,0), (2,0), (2,1), ...), which fixes the on-disk descriptor layout to
    the reference's (sgdml/utils/desc.py:109-110).
    """
    rows, cols = np.tril_indices(n_atoms, k=-1)
    return np.stack([rows, cols], axis=1)


@functools.lru_cache(maxsize=None)
def incidence(n_atoms: int) -> np.ndarray:
    """Static signed incidence matrix ``S (D, N)``.

    ``S[p, b] = +1`` and ``S[p, a] = -1`` for pair ``p = (a, b)``, so that
    ``d/dr_b (1/||r_a - r_b||) = +Jc[p]`` lands in atom ``b``'s column of
    the full Jacobian.
    """
    pairs = tril_pairs(n_atoms)
    dim = pairs.shape[0]
    s = np.zeros((dim, n_atoms))
    s[np.arange(dim), pairs[:, 1]] = 1.0
    s[np.arange(dim), pairs[:, 0]] = -1.0
    return s


@functools.lru_cache(maxsize=None)
def _pairs_t(n_atoms: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    pairs = torch.as_tensor(tril_pairs(n_atoms), device=device)
    return pairs[:, 0], pairs[:, 1]


@functools.lru_cache(maxsize=None)
def _incidence_t(n_atoms: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(incidence(n_atoms), device=device, dtype=dtype)


def pbc_diff(diffs: torch.Tensor, lat_and_inv) -> torch.Tensor:
    """Clamp pairwise difference vectors to the minimum image.

    Parameters
    ----------
    diffs: ``(..., 3)`` difference vectors ``u - v``.
    lat_and_inv: tuple ``(lattice, lattice^-1)`` of ``(3, 3)`` tensors with
        lattice vectors as columns (reference: sgdml/utils/desc.py:44-77).
        ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    lat, lat_inv = lat_and_inv
    c = torch.einsum('ij,...j->...i', lat_inv, diffs)
    return diffs - torch.einsum('ij,...j->...i', lat, torch.round(c))


def _pair_diffs(r: torch.Tensor, n_atoms: int, lat_and_inv=None) -> torch.Tensor:
    """``(..., D, 3)`` per-pair differences ``r_a - r_b`` (min-image if
    periodic) of ``r`` shaped ``(3N,)`` or ``(..., N, 3)``."""
    if r.dim() == 1:
        r = r.reshape(n_atoms, 3)
    a, b = _pairs_t(n_atoms, r.device)
    diffs = r[..., a, :] - r[..., b, :]
    if lat_and_inv is not None:
        diffs = pbc_diff(diffs, lat_and_inv)
    return diffs


def descriptor(r: torch.Tensor, n_atoms: int, lat_and_inv=None) -> torch.Tensor:
    """Descriptor ``x (D,)`` of one geometry ``r`` (``(N, 3)`` or ``(3N,)``)."""
    diffs = _pair_diffs(r, n_atoms, lat_and_inv)
    dists = torch.linalg.vector_norm(diffs, dim=-1)
    return 1.0 / dists


def descriptor_jacobian(r: torch.Tensor, n_atoms: int, lat_and_inv=None):
    """Descriptor and compressed Jacobian of one geometry (or a batch).

    Returns
    -------
    x: ``(..., D)`` descriptor.
    jc: ``(..., D, 3)`` compressed Jacobian rows ``(r_a - r_b)/d^3``; the
        full ``(D, 3N)`` Jacobian is ``einsum('pn,pc->pnc', S, jc)``.
    """
    diffs = _pair_diffs(r, n_atoms, lat_and_inv)
    d2 = torch.sum(diffs * diffs, dim=-1)
    inv_d = torch.rsqrt(d2)
    x = inv_d
    jc = diffs * (inv_d**3)[..., None]
    return x, jc


def descriptor_batch(R: torch.Tensor, n_atoms: int, lat_and_inv=None):
    """Batched descriptors+Jacobians for ``R (M, N, 3)`` or ``(M, 3N)``.

    Returns ``(M, D)`` descriptors and ``(M, D, 3)`` compressed Jacobians.
    """
    R = R.reshape(R.shape[0], n_atoms, 3)
    return descriptor_jacobian(R, n_atoms, lat_and_inv)


def jacobian_full(jc: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """Expand compressed Jacobian(s) ``(..., D, 3)`` to full ``(..., D, 3N)``."""
    s = _incidence_t(n_atoms, jc.device, jc.dtype)
    full = torch.einsum('pn,...pc->...pnc', s, jc)
    return full.reshape(*jc.shape[:-2], jc.shape[-2], 3 * n_atoms)


def jac_dot_vec(jc: torch.Tensor, vec: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """``J @ v`` for 3N-vector(s): ``(..., D, 3) x (..., 3N) -> (..., D)``.

    Used to pre-contract training Jacobians with regression coefficients
    (the model's ``R_d_desc_alpha`` table; reference sgdml/utils/desc.py:368
    and sgdml/train.py:791).
    """
    s = _incidence_t(n_atoms, jc.device, jc.dtype)
    v = vec.reshape(*vec.shape[:-1], n_atoms, 3)
    pair_v = torch.einsum('pn,...nc->...pc', s, v)  # v_b - v_a per pair
    return torch.sum(jc * pair_v, dim=-1)


def vec_dot_jac(jc: torch.Tensor, vec_d: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """``J^T @ u`` for D-vector(s): ``(..., D, 3) x (..., D) -> (..., 3N)``.

    Maps descriptor-space gradients back to Cartesian space (reference
    sgdml/utils/desc.py:388-408) as one matmul against the incidence matrix.
    """
    s = _incidence_t(n_atoms, jc.device, jc.dtype)
    weighted = jc * vec_d[..., None]  # (..., D, 3)
    out = torch.einsum('pn,...pc->...nc', s, weighted)
    return out.reshape(*out.shape[:-2], 3 * n_atoms)


def perm_to_desc_perm(perm: np.ndarray) -> np.ndarray:
    """Convert an atom permutation to the induced descriptor permutation.

    Applying the returned index array to a descriptor equals permuting the
    atoms first and re-computing the descriptor (host-side NumPy; matches
    reference sgdml/utils/desc.py:509-539 behavior).
    """
    perm = np.asarray(perm)
    n = perm.size
    pair_id = np.zeros((n, n), dtype=np.int64)
    rows, cols = np.tril_indices(n, k=-1)
    pair_id[rows, cols] = np.arange(rows.size)
    pair_id = pair_id + pair_id.T
    permuted = pair_id[np.ix_(perm, perm)]
    return permuted[rows, cols].astype(np.int64)
