"""Plain sGDML arithmetic in PyTorch (Chmiela et al., Nat. Commun. 9, 3887
(2018)): inverse-distance descriptors and their Jacobians, the Matern-5/2
Hessian kernel's force and energy predictions, the dense kernel matrix and
a blocked Cholesky. Written from the published equations, with direct
descriptor differences where the program uses the Gram identity; it imports
torch and numpy only.

A geometry r (N atoms) has descriptor x_p = 1 / |r_a - r_b| for each pair
p = (a, b), a > b, in ``numpy.tril_indices`` order. With d = x - x',
u = sqrt(5) |d| and b = 5 exp(-u / sig) / (3 sig^4), the kernel's Hessian
block is H = b (5 d d^T - (sig^2 + sig u) I), and a model with training
descriptors x_t and coefficients alpha_t predicts

    F(x) = std J(x)^T sum_t H(x, x_t) J_t alpha_t,
    E(x) = c + std sum_t b (sig^2 + sig u) d . (J_t alpha_t).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    'descriptors', 'jac_times', 'to_cartesian', 'full_jacobian', 'contract', 'predict', 'kernel_rows',
    'cholesky_inplace', 'cho_solve',
]

_SQRT5 = math.sqrt(5.0)


def _pairs(n_atoms: int, device):
    a, b = np.tril_indices(n_atoms, k=-1)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


def descriptors(R: torch.Tensor):
    """R (B, N, 3) -> x (B, D) and jc (B, D, 3) = (r_a - r_b) / |r_a - r_b|^3,
    the derivative of x_p by r_b (by r_a it is -jc)."""
    a, b = _pairs(R.shape[1], R.device)
    diff = R[:, a] - R[:, b]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return 1.0 / dist, diff / dist[..., None] ** 3


def jac_times(jc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J v for Cartesian vectors v (B, 3N): (B, D)."""
    n_atoms = v.shape[-1] // 3
    a, b = _pairs(n_atoms, jc.device)
    v = v.reshape(v.shape[0], n_atoms, 3)
    return torch.sum(jc * (v[:, b] - v[:, a]), dim=-1)


def to_cartesian(jc: torch.Tensor, g: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """J^T g for descriptor-space vectors g (B, D): (B, 3N)."""
    a, b = _pairs(n_atoms, jc.device)
    w = jc * g[..., None]
    out = torch.zeros((jc.shape[0], n_atoms, 3), dtype=jc.dtype, device=jc.device)
    out.index_add_(1, b, w)
    out.index_add_(1, a, -w)
    return out.reshape(jc.shape[0], 3 * n_atoms)


def full_jacobian(jc: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """(B, D, 3N) Jacobians from jc (B, D, 3)."""
    a, b = _pairs(n_atoms, jc.device)
    B, D = jc.shape[:2]
    J = torch.zeros((B, D, n_atoms, 3), dtype=jc.dtype, device=jc.device)
    rows = torch.arange(D, device=jc.device)
    J[:, rows, b] = jc
    J[:, rows, a] = -jc
    return J.reshape(B, D, 3 * n_atoms)


def contract(xq: torch.Tensor, xt: torch.Tensor, ja: torch.Tensor, sig: float, block: int = 16):
    """(E_raw (B,), F_d (B, D)) of queries xq (B, D) against training
    descriptors xt (T, D) and ja_t = J_t alpha_t (T, D), ``block`` queries
    at a time."""
    E, F = [], []
    for q0 in range(0, xq.shape[0], block):
        d = xq[q0:q0 + block, None, :] - xt[None]
        u = _SQRT5 * torch.sqrt(torch.sum(d * d, dim=-1))
        b = 5.0 * torch.exp(-u / sig) / (3.0 * sig**4)
        cc = b * (sig * sig + sig * u)
        dja = torch.einsum('btd,td->bt', d, ja)
        E.append(torch.sum(cc * dja, dim=1))
        F.append(5.0 * torch.einsum('bt,btd->bd', b * dja, d) - cc @ ja)
    return torch.cat(E), torch.cat(F)


def predict(R: torch.Tensor, xt: torch.Tensor, ja: torch.Tensor, sig: float, std: float, c: float,
            block: int = 16):
    """(E (B,), F (B, 3N)) of geometries R (B, N, 3)."""
    xq, jcq = descriptors(R)
    E_raw, F_d = contract(xq, xt, ja, sig, block)
    return E_raw * std + c, to_cartesian(jcq, F_d, R.shape[1]) * std


def kernel_rows(xi, Ji, xt, Jt, sig):
    """Rows of the dense kernel matrix for row points i against all points
    t: (I 3N, T 3N) with block (i, t) = J_i^T H(x_i, x_t) J_t. xi (I, D),
    Ji (I, D, 3N), xt (T, D), Jt (T, D, 3N)."""
    d = xi[:, None, :] - xt[None]
    u = _SQRT5 * torch.sqrt(torch.sum(d * d, dim=-1))
    b = 5.0 * torch.exp(-u / sig) / (3.0 * sig**4)
    cc = b * (sig * sig + sig * u)
    left = torch.einsum('itd,idx->itx', d, Ji)
    right = torch.bmm(d.transpose(0, 1), Jt).transpose(0, 1)  # (I, T, 3N): d^T J_t
    I, T, n3 = left.shape
    gram = (Ji.transpose(1, 2).reshape(I * n3, -1) @ Jt.permute(1, 0, 2).reshape(-1, T * n3)).view(I, n3, T, n3)
    gram.mul_(-cc[:, None, :, None])
    gram.add_((5.0 * b)[:, None, :, None] * left.permute(0, 2, 1)[..., None] * right[:, None, :, :])
    return gram.reshape(I * n3, T * n3)


def cholesky_inplace(A: torch.Tensor, nb: int = 1024) -> bool:
    """Lower Cholesky factor of the symmetric positive definite A, in its
    lower triangle, in place, a block column at a time. False where a
    diagonal block is not positive definite."""
    n = A.shape[0]
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        L, info = torch.linalg.cholesky_ex(A[k0:k1, k0:k1])
        if int(info) != 0:
            return False
        A[k0:k1, k0:k1] = L
        if k1 == n:
            break
        panel = torch.linalg.solve_triangular(L, A[k1:, k0:k1].T, upper=False).T
        A[k1:, k0:k1] = panel
        for i0 in range(k1, n, nb):
            i1 = min(n, i0 + nb)
            A[i0:i1, k1:i1].addmm_(panel[i0 - k1:i1 - k1], panel[:i1 - k1].T, alpha=-1.0)
    return True


def cho_solve(L: torch.Tensor, y: torch.Tensor, nb: int = 1024) -> torch.Tensor:
    """x with L L^T x = y, from the lower triangle of L, a block at a time."""
    n = L.shape[0]
    z = y.clone()
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        z[k0:k1] = torch.linalg.solve_triangular(torch.tril(L[k0:k1, k0:k1]), z[k0:k1, None], upper=False)[:, 0]
        z[k1:] -= L[k1:, k0:k1] @ z[k0:k1]
    for k1 in range(n, 0, -nb):
        k0 = max(0, k1 - nb)
        z[k0:k1] = torch.linalg.solve_triangular(torch.tril(L[k0:k1, k0:k1]).T, z[k0:k1, None], upper=True)[:, 0]
        z[:k0] -= L[k0:k1, :k0].T @ z[k0:k1]
    return z
