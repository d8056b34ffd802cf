"""Plain reference for ``GDMLPredict.predict``: energies and forces of the
requested geometries from the raw model inputs (training geometries,
coefficients, sig, std, c), with the descriptors, Jacobians and
coefficient tables worked out again."""

from __future__ import annotations

import numpy as np
import torch

from . import gdml

__all__ = ['Model', 'judge', 'worst']


class Model:
    """The raw inputs of a served model, as tables in ``dtype``."""

    def __init__(self, R_train, alphas, sig, std, c, device, dtype):
        R = torch.as_tensor(np.asarray(R_train), dtype=dtype, device=device)
        self.x, jc = gdml.descriptors(R)
        alpha = torch.as_tensor(np.asarray(alphas), dtype=dtype, device=device).reshape(R.shape[0], -1)
        self.ja = gdml.jac_times(jc, alpha)
        self.sig, self.std, self.c = float(sig), float(std), float(c)
        self.device, self.dtype = device, dtype

    def forces(self, R):
        """(E (B,), F (B, 3N)) as tensors of geometries R (B, N, 3)."""
        R = torch.as_tensor(R, dtype=self.dtype, device=self.device)
        return gdml.predict(R, self.x, self.ja, self.sig, self.std, self.c)

    def predict(self, R):
        """(E (B,), F (B, 3N)) as float64 numpy."""
        E, F = self.forces(R)
        return E.double().cpu().numpy(), F.double().cpu().numpy()


def judge(model: Model, answers):
    """``answers``: [(R (B, N, 3), E (B,), F (B, 3N))] as served. Returns
    ``{'energy': max |E - E_ref| / max |E_ref|, 'forces': the same for F}``
    over all of them."""
    e_err = e_ref = f_err = f_ref = 0.0
    for R, E, F in answers:
        E_r, F_r = model.predict(R)
        e_err = max(e_err, worst(np.asarray(E) - E_r))
        f_err = max(f_err, worst(np.asarray(F).reshape(F_r.shape) - F_r))
        e_ref, f_ref = max(e_ref, worst(E_r)), max(f_ref, worst(F_r))
    return {'energy': e_err / e_ref, 'forces': f_err / f_ref}


def worst(a) -> float:
    """max |a|, with any value that is not finite read as infinite."""
    a = np.abs(np.asarray(a, dtype=np.float64))
    return float(np.max(np.where(np.isfinite(a), a, np.inf)))
