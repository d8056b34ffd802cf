"""Closed-form solver: dense f64 Cholesky factorization of the assembled
kernel system on the device (reference behavior:
sgdml/solvers/analytic.py:49-151).

The assembled kernel K is negated to make the system convex, shifted by
the ridge ``lam`` on its diagonal and factorized. The ladder mirrors the
reference: Cholesky -> LU -> least squares (for non-square systems). A
failed factorization shows as ``info != 0`` from
``torch.linalg.cholesky_ex``, read once after the factor.

Memory: ``K`` is negated and shifted in place, so the factor is the only
second ``n^2`` buffer. Of the analytic routes of ``sgdml_tpu`` only the dense
one is ported; a system whose ``24 n^2`` bytes exceed the device's budget
raises ``NotImplementedError``: the iterative solver
(``solvers/iterative.py``, ``solver='cg'``) trains it, and the large-M
analytic paths are ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import logging
import timeit

import numpy as np
import torch

from ..ops.kernel import assemble_kernel

__all__ = ['Analytic', 'memory_budget']

log = logging.getLogger(__name__)

# Budget on the CPU, where no allocator reports what is free.
CPU_BUDGET_BYTES = 12 * 1024**3


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


class Analytic:
    """Closed-form training on the device of its inputs.

    Parameters
    ----------
    gdml_train: the calling trainer (kept for API parity).
    callback: optional progress callback (unused by the dense route).
    mesh: multi-device solves are not ported; must be None.
    max_memory: budget in GB; None takes :func:`memory_budget` of the
        inputs' device.
    """

    def __init__(self, gdml_train=None, callback=None, mesh=None,
                 max_memory: float | None = None):
        if mesh is not None:
            raise NotImplementedError('mesh= (the sharded solve) is ROADMAP queue 1 item 13, multi-GPU')
        self.gdml_train = gdml_train
        self.callback = callback
        self._max_memory = max_memory
        self.t_assemble = self.t_solve = None

    def solve(self, task, R_desc, R_d_desc, desc_perms, y):
        """Assemble ``K``, solve ``(-K + lam I) x = y`` and return
        ``alphas = -x`` as a tensor on the inputs' device.

        R_desc: ``(M, D)``, R_d_desc: ``(M, D, 3)`` tensors on the device.
        desc_perms: ``(P, D)`` host ints. y: ``(n,)`` labels.
        """
        sig = float(np.squeeze(task['sig']))
        lam = float(np.squeeze(task['lam']))
        use_E_cstr = bool(task.get('use_E_cstr', False))
        device = R_desc.device

        n_train, dim_d = R_d_desc.shape[:2]
        n_atoms = int((1 + np.sqrt(8 * dim_d + 1)) / 2)
        budget = (memory_budget(device) if self._max_memory is None
                  else self._max_memory * 1024**3)
        need = Analytic.est_memory_requirement(n_train, n_atoms, use_E_cstr)
        if need > budget:
            raise NotImplementedError(
                'the dense analytic system of %d training points (%.1f GB) does not fit the '
                "budget of %.1f GB; solver='cg' (the iterative solver) trains it, and the large-M "
                'analytic paths are ROADMAP queue 1 item 12' % (n_train, need / 1e9, budget / 1e9))

        def sync():
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

        t0 = timeit.default_timer()
        K = assemble_kernel(R_desc, R_d_desc, desc_perms, sig, n_atoms, use_E_cstr=use_E_cstr)
        sync()
        self.t_assemble = timeit.default_timer() - t0
        log.info('Assembled %dx%d kernel in %.2f s', K.shape[0], K.shape[1], self.t_assemble)

        y = torch.as_tensor(y, dtype=K.dtype, device=device)
        t0 = timeit.default_timer()
        if K.shape[0] == K.shape[1]:
            A = _neg_shift_(K, lam)
            alphas, ok = _cho_solve_neg(A, y)
            if not ok:
                log.warning('Cholesky factorization failed (not PSD at lam=%g); falling back to LU.', lam)
                alphas = _lu_solve_neg(A, y)
        else:
            alphas = -torch.linalg.lstsq(-K, y[:, None]).solution[:, 0]
        sync()
        self.t_solve = timeit.default_timer() - t0
        log.info('Solved %d-dim linear system in %.2f s', K.shape[0], self.t_solve)
        return alphas

    @staticmethod
    def est_memory_requirement(n_train, n_atoms, use_E_cstr=False):
        """Bytes needed on the device for the dense f64 path: K + Cholesky
        factor + solve scratch (reference formula:
        sgdml/solvers/analytic.py:153-159)."""
        n = n_train * 3 * n_atoms + (n_train if use_E_cstr else 0)
        return 3 * n**2 * 8 + n * 8

    @staticmethod
    def est_memory_grid(n_train, n_atoms):
        """Bytes the JAX package's f32 packed-triangle grid route needs
        (``sgdml_tpu.solvers.analytic``; ROADMAP queue 1 item 12, not
        ported): the trainer's solver choice follows that package's rule."""
        n = (-(-n_train // 8) * 8) * 3 * n_atoms
        return 3 * n**2
