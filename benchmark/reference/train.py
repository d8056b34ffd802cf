"""Plain reference for ``GDMLTrain.train``: judges a trained model by its own
arithmetic, and trains one itself for the control.

From the training geometries and labels alone it works out the
descriptors, Jacobians and label scale again, and judges the model's
coefficients by the residual of the system they solve,
(K - lam I) alpha = F / std with K the force-field kernel matrix (the
prediction of the scaled training forces), and the model's tables
(``R_desc``, ``R_d_desc_alpha``, ``std`` and the integration constant
``c``) against its own.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gdml

__all__ = ['judge', 'scales', 'train']


def _inputs(R_train, F_train, device, dtype):
    R = torch.as_tensor(np.asarray(R_train), dtype=dtype, device=device)
    y = np.asarray(F_train, dtype=np.float64).ravel()
    std = float(np.std(y))
    return R, torch.as_tensor(y / std, dtype=dtype, device=device), std


def _offset(E_raw, E_train, std, device, dtype):
    """The integration constant c: the mean of E - std E_raw over the
    training points, E_raw the model's unscaled energy there."""
    E = torch.as_tensor(np.asarray(E_train, dtype=np.float64).ravel(), dtype=dtype, device=device)
    return float(torch.mean(E - std * E_raw)), E


def scales(alphas, R_train, F_train, E_train, sig, device):
    """(std, c) of a model with coefficients ``alphas``, worked out here
    from the training geometries and labels, in float64."""
    f64 = torch.float64
    R, _, std = _inputs(R_train, F_train, device, f64)
    x, jc = gdml.descriptors(R)
    alpha = torch.as_tensor(np.asarray(alphas), dtype=f64, device=device).reshape(R.shape[0], -1)
    E_raw, _ = gdml.contract(x, x, gdml.jac_times(jc, alpha), sig)
    return std, _offset(E_raw, E_train, std, device, f64)[0]


def judge(model, R_train, F_train, E_train, sig, lam, device, block=16):
    """``{'resid': |(K - lam I) alpha - y| / |y|, 'model': the largest
    relative error of the model's tables}`` in float64."""
    f64 = torch.float64
    R, y, std = _inputs(R_train, F_train, device, f64)
    M, N = R.shape[:2]
    x, jc = gdml.descriptors(R)
    alpha = torch.as_tensor(np.asarray(model['alphas_F']), dtype=f64, device=device).reshape(M, 3 * N)
    ja = gdml.jac_times(jc, alpha)
    E_raw, F_d = gdml.contract(x, x, ja, sig, block)
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


def train(R_train, F_train, E_train, sig, lam, device, dtype, rows=8):
    """A model dict (``alphas_F``, ``R_desc``, ``R_d_desc_alpha``, ``std``,
    ``c``) trained in ``dtype``: the dense kernel matrix assembled ``rows``
    points at a time, its Cholesky factor in place, two substitutions.
    None where the factor breaks down."""
    R, y, std = _inputs(R_train, F_train, device, dtype)
    M, N = R.shape[:2]
    x, jc = gdml.descriptors(R)
    J = gdml.full_jacobian(jc, N)
    n = M * 3 * N
    A = torch.empty((n, n), dtype=dtype, device=device)
    for i0 in range(0, M, rows):
        i1 = min(M, i0 + rows)
        A[i0 * 3 * N:i1 * 3 * N] = gdml.kernel_rows(x[i0:i1], J[i0:i1], x, J, sig)
    del J
    A.neg_()
    A.diagonal().add_(lam)
    if not gdml.cholesky_inplace(A):
        return None
    alpha = -gdml.cho_solve(A, y)
    del A
    alpha = alpha.reshape(M, 3 * N)
    ja = gdml.jac_times(jc, alpha)
    c = _offset(gdml.contract(x, x, ja, sig)[0], E_train, std, device, dtype)[0]

    def host(t):
        return t.to(torch.float64).cpu().numpy()

    return {'alphas_F': host(alpha.ravel()), 'R_desc': host(x.T), 'R_d_desc_alpha': host(ja), 'std': std, 'c': c}
