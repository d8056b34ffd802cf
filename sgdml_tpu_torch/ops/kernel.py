"""Matern-5/2 kernel coefficient functions.

The serving path needs only the scalar coefficient family (the energy
constraint's kernel value). Kernel-matrix assembly for training is not part
of this package yet.
"""

from __future__ import annotations

import torch

__all__ = ['Mat52Coeffs']


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
