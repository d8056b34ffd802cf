"""Block-grid packed Cholesky for SPD systems that fill device memory.

The lower triangle of an ``n x n`` matrix is kept as a ``k x k`` grid of
equal ``(b, b)`` blocks: a list of lists of tensors, row ``i`` holding
blocks ``0..i``. :func:`chol_grid` factorizes it right-looking, block
column by block column, from the host: a leaf Cholesky (cuSOLVER through
``torch.linalg.cholesky_ex``), the panel's triangular solves (each into a
new block that replaces its input) and the trailing GEMM updates (cuBLAS,
in place). Peak memory is the packed storage plus one block-sized
temporary. float32 grids are factorized and solved with TF32 off.

:func:`solve_grid` applies ``(L L^T)^{-1}`` by block-triangular sweeps (the
refinement CG's preconditioner); :func:`matvec_grid` is the symmetric
product from the triangle. :func:`grid_isfinite` is kept for parity with
the JAX module, whose failed factor is all NaNs; here a failure shows only
in ``chol_grid``'s ``info``, so nothing on the route calls it.

Same functions and layout as ``sgdml_tpu.ops.blockchol``. A failed
factorization differs: XLA fills the factor with NaNs, while
``cholesky_ex`` returns ``info > 0`` and a finite, partial factor, so
:func:`chol_grid` reads each leaf's ``info`` and reports the failure.

Reference counterpart: scipy ``cho_factor/cho_solve`` on a dense host
matrix (sgdml/solvers/analytic.py:94-99).
"""

from __future__ import annotations

import numpy as np
import torch

from ._precision import _true_f32

__all__ = [
    'GridSpec',
    'grid_spec',
    'grid_from_dense',
    'grid_to_dense',
    'grid_diag_add',
    'chol_grid',
    'solve_grid',
    'matvec_grid',
]


class GridSpec:
    """Static description: side ``n = k * b``, ``k`` block rows of ``b``."""

    def __init__(self, n: int, k: int):
        if n % k != 0:
            raise ValueError('n must be divisible by k')
        self.n = n
        self.k = k
        self.b = n // k


def grid_spec(n: int, target_block: int = 8192, align: int = 1) -> GridSpec:
    """Pick ``k`` so blocks are ~``target_block`` and ``b % align == 0``."""
    if n % align != 0:
        raise ValueError('n must be a multiple of align')
    units = n // align
    k = max(1, -(-n // target_block))
    while units % k != 0:
        k += 1
    return GridSpec(n, k)


def grid_from_dense(A: torch.Tensor, spec: GridSpec):
    """The lower-triangle grid of ``A``, each block a contiguous copy."""
    b = spec.b
    return [
        [A[i * b:(i + 1) * b, j * b:(j + 1) * b].clone() for j in range(i + 1)]
        for i in range(spec.k)
    ]


def grid_to_dense(G, spec: GridSpec, full: bool = False) -> np.ndarray:
    """Host ``(n, n)`` array of the triangle (upper half zero), or of the
    symmetric matrix with ``full``."""
    b = spec.b
    out = torch.zeros((spec.n, spec.n), dtype=G[0][0].dtype)
    for i in range(spec.k):
        for j in range(i + 1):
            blk = G[i][j].cpu()
            out[i * b:(i + 1) * b, j * b:(j + 1) * b] = torch.tril(blk) if i == j else blk
    out = out.numpy()
    if full:
        out = out + np.tril(out, -1).T
    return out


def grid_diag_add(G, delta):
    """Add ``delta`` to the diagonal, in place; returns ``G``."""
    for i in range(len(G)):
        G[i][i].diagonal().add_(delta)
    return G


def grid_isfinite(G) -> bool:
    """Whether every entry is finite (one host read)."""
    ok = torch.ones((), dtype=torch.bool, device=G[0][0].device)
    for row in G:
        for blk in row:
            ok &= torch.isfinite(blk).all()
    return bool(ok)


def chol_grid(G):
    """Right-looking blocked Cholesky over the grid, in place.

    Overwrites ``G``'s blocks (and its leaf entries) with the factor ``L``
    and returns ``(G, info)``. ``info`` is 0 on success; otherwise the
    order of the first leading minor that is not positive definite at this
    precision, as LAPACK's ``potrf`` reports it, and the factorization
    stops in that block column: the blocks right of it hold partial
    results. Each leaf's ``info`` is read once, after its block column's
    updates are queued, so the device runs ahead of the host by one
    column.
    """
    k = len(G)
    b = G[0][0].shape[0]
    with _true_f32(G[0][0].dtype):
        for j in range(k):
            G[j][j], info = torch.linalg.cholesky_ex(G[j][j])
            ljj = G[j][j]
            for i in range(j + 1, k):
                # B <- B L_jj^{-T}
                G[i][j] = torch.linalg.solve_triangular(ljj.mT, G[i][j], upper=True, left=False)
            for c in range(j + 1, k):
                for r in range(c, k):
                    G[r][c].addmm_(G[r][j], G[c][j].mT, alpha=-1)
            info = int(info)
            if info != 0:
                return G, j * b + info
    return G, 0


def _split(y, k, b):
    return [y[i * b:(i + 1) * b] for i in range(k)]


def solve_grid(L, y: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = y``; ``y`` is ``(n,)`` or ``(n, m)``."""
    k = len(L)
    b = L[0][0].shape[0]
    was_vec = y.ndim == 1
    if was_vec:
        y = y[:, None]
    yb = _split(y, k, b)
    z, x = [], [None] * k
    with _true_f32(y.dtype):
        for j in range(k):
            rhs = yb[j].clone()
            for c in range(j):
                rhs.addmm_(L[j][c], z[c], alpha=-1)
            z.append(torch.linalg.solve_triangular(L[j][j], rhs, upper=False))
        for j in reversed(range(k)):
            rhs = z[j]
            for r in range(j + 1, k):
                rhs.addmm_(L[r][j].mT, x[r], alpha=-1)
            x[j] = torch.linalg.solve_triangular(L[j][j].mT, rhs, upper=True)
    out = torch.cat(x, dim=0)
    return out[:, 0] if was_vec else out


def matvec_grid(G, v: torch.Tensor) -> torch.Tensor:
    """Symmetric matvec from the lower-triangle grid; ``v`` is ``(n,)`` or
    ``(n, m)``."""
    k = len(G)
    b = G[0][0].shape[0]
    was_vec = v.ndim == 1
    if was_vec:
        v = v[:, None]
    vb = _split(v, k, b)
    out = [torch.zeros_like(vb[i]) for i in range(k)]
    for i in range(k):
        for j in range(i + 1):
            blk = G[i][j]
            if i == j:
                lo = torch.tril(blk, -1)
                out[i] += torch.tril(blk) @ vb[i] + lo.mT @ vb[i]
            else:
                out[i] += blk @ vb[j]
                out[j] += blk.mT @ vb[i]
    res = torch.cat(out, dim=0)
    return res[:, 0] if was_vec else res
