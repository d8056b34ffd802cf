"""Plain reference for sGDML with a permutation group (Chmiela et al., Nat.
Commun. 9, 3887 (2018)): the symmetric kernel summed over the molecule's
permutations, the judge of a trained symmetric model, its predictions and a
training of its own for the control. It imports torch and numpy only, and
takes its descriptor arithmetic from ``gdml.py``.

An atom permutation pi moves the descriptor of pair p = (a, b) to pair
(pi(a), pi(b)): with x_q the descriptor of the geometry whose atoms are
relabelled R[pi], x_q[p] = x[pair(pi(a), pi(b))], the pairs in
``numpy.tril_indices`` order. Its Jacobian rows move alike. The kernel
between geometries i and j is the sum over the P permutations

    K_ij = sum_q J_i^T H(x_i, x_j^q) J_j^q,

with x_j^q and J_j^q the permuted descriptor and Jacobian of j, and a model
predicts from the M P permuted rows of its tables (x_t^q, (J_t alpha_t)^q):

    F(x) = std J(x)^T sum_{t,q} H(x, x_t^q) (J_t alpha_t)^q,
    E(x) = c + std sum_{t,q} b (sig^2 + sig u) d . (J_t alpha_t)^q.

The sum over the group is not divided by P: a symmetrized kernel written
as the group's mean would scale K by 1/P and the alphas by P, and leave
every prediction as it is. Float32 runs with TF32 off (``train`` sets it),
so that a float32 product is a float32 product.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gdml
from .train import _inputs, _offset

__all__ = ['desc_perms', 'judge', 'kernel_rows', 'predict', 'tables', 'train']


def desc_perms(perms) -> np.ndarray:
    """(P, D) descriptor permutations of the (P, N) atom permutations:
    row q holds, for each pair (a, b) in ``tril_indices`` order, the index
    of the pair (pi_q(a), pi_q(b))."""
    perms = np.asarray(perms, dtype=np.int64)
    n_atoms = perms.shape[1]
    a, b = np.tril_indices(n_atoms, k=-1)
    index = {(int(i), int(j)): p for p, (i, j) in enumerate(zip(a, b))}
    return np.array([[index[max(pi[i], pi[j]), min(pi[i], pi[j])] for i, j in zip(a, b)] for pi in perms],
                    dtype=np.int64)


def tables(x: torch.Tensor, ja: torch.Tensor, dp: np.ndarray):
    """The M P permuted rows (x_t^q, (J_t alpha_t)^q) of descriptors x (M,
    D) and contracted Jacobians ja (M, D), row t P + q."""
    idx = torch.as_tensor(dp, device=x.device)
    return x[:, idx].reshape(-1, x.shape[1]), ja[:, idx].reshape(-1, x.shape[1])


def kernel_rows(xi, Ji, x, J, dp, sig):
    """Rows of the symmetric kernel matrix for row points i against all
    points t: (I 3N, T 3N), the sum over the permutations of ``gdml``'s
    rows against the permuted column descriptors and Jacobians. xi (I, D),
    Ji (I, D, 3N), x (T, D), J (T, D, 3N), dp (P, D)."""
    out = None
    for q in dp:
        idx = torch.as_tensor(q, device=x.device)
        rows = gdml.kernel_rows(xi, Ji, x[:, idx], J[:, idx], sig)
        out = rows if out is None else out.add_(rows)
    return out


def predict(R, R_train, alphas, perms, sig, std, c, device, dtype=torch.float64, block=16):
    """(E (B,), F (B, 3N)) of geometries R (B, N, 3) by the model with
    training geometries ``R_train``, coefficients ``alphas`` and group
    ``perms``, its tables worked out here."""
    Rt = torch.as_tensor(np.asarray(R_train), dtype=dtype, device=device)
    x, jc = gdml.descriptors(Rt)
    alpha = torch.as_tensor(np.asarray(alphas), dtype=dtype, device=device).reshape(Rt.shape[0], -1)
    xt, jat = tables(x, gdml.jac_times(jc, alpha), desc_perms(perms))
    Rq = torch.as_tensor(np.asarray(R), dtype=dtype, device=device)
    return gdml.predict(Rq, xt, jat, sig, std, c, block)


def judge(model, R_train, F_train, E_train, perms, sig, lam, device, block=16):
    """``{'resid': |(K_sym - lam I) alpha - y| / |y|, 'model': the largest
    relative error of the model's tables}`` in float64, for the group
    ``perms`` (the dataset's, not the model's own). K_sym alpha contracts
    the training points against the M P permuted table rows; ``c`` is the
    symmetric contraction's integration constant."""
    f64 = torch.float64
    R, y, std = _inputs(R_train, F_train, device, f64)
    M, N = R.shape[:2]
    x, jc = gdml.descriptors(R)
    alpha = torch.as_tensor(np.asarray(model['alphas_F']), dtype=f64, device=device).reshape(M, 3 * N)
    ja = gdml.jac_times(jc, alpha)
    xt, jat = tables(x, ja, desc_perms(perms))
    E_raw, F_d = gdml.contract(x, xt, jat, sig, block)
    K_alpha = gdml.to_cartesian(jc, F_d, N).ravel()
    resid = float(torch.linalg.vector_norm(K_alpha - lam * alpha.ravel() - y) / torch.linalg.vector_norm(y))
    c, E = _offset(E_raw, E_train, std, device, f64)
    e_scale = float(torch.max(torch.abs(E)))

    def rel(ours, theirs):
        theirs = torch.as_tensor(np.asarray(theirs, dtype=np.float64), device=device)
        return float(torch.max(torch.abs(theirs.reshape(ours.shape) - ours)) / torch.max(torch.abs(ours)))

    errors = [rel(x.T, model['R_desc']), rel(ja, model['R_d_desc_alpha']),
              abs(float(np.squeeze(model['std'])) - std) / std,
              abs(float(np.squeeze(model['c'])) - c) / e_scale]
    return {'resid': resid, 'model': max(e if np.isfinite(e) else np.inf for e in errors)}


def train(R_train, F_train, E_train, perms, sig, lam, device, dtype, rows=8):
    """A model dict (``alphas_F``, ``R_desc``, ``R_d_desc_alpha``, ``std``,
    ``c``) trained in ``dtype`` with the group ``perms``: the dense
    symmetric kernel matrix assembled ``rows`` points at a time, its
    Cholesky factor in place, two substitutions. None where the factor
    breaks down."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R, y, std = _inputs(R_train, F_train, device, dtype)
    M, N = R.shape[:2]
    x, jc = gdml.descriptors(R)
    J = gdml.full_jacobian(jc, N)
    dp = desc_perms(perms)
    n = M * 3 * N
    A = torch.empty((n, n), dtype=dtype, device=device)
    for i0 in range(0, M, rows):
        i1 = min(M, i0 + rows)
        A[i0 * 3 * N:i1 * 3 * N] = kernel_rows(x[i0:i1], J[i0:i1], x, J, dp, sig)
    del J
    A.neg_()
    A.diagonal().add_(lam)
    if not gdml.cholesky_inplace(A):
        return None
    alpha = -gdml.cho_solve(A, y)
    del A
    alpha = alpha.reshape(M, 3 * N)
    ja = gdml.jac_times(jc, alpha)
    c = _offset(gdml.contract(x, *tables(x, ja, dp), sig)[0], E_train, std, device, dtype)[0]

    def host(t):
        return t.to(torch.float64).cpu().numpy()

    return {'alphas_F': host(alpha.ravel()), 'R_desc': host(x.T), 'R_d_desc_alpha': host(ja), 'std': std, 'c': c}
