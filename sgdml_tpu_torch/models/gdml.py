"""Typed wrapper around the (s)GDML model artifact, and its tensors.

The on-disk format is the reference-compatible dict-of-ndarrays npz (keys
per sgdml/train.py:793-831), the same file ``sgdml_tpu`` writes, so a model
saved by either package loads in the other. :func:`model_to_torch` turns
such a dict into the tensors the engines serve from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import io

__all__ = ['GDMLModel', 'as_model_dict', 'model_to_torch']


def as_model_dict(model) -> dict:
    """Normalize any engine-facing model argument to the raw dict.

    Accepts a :class:`GDMLModel`, a model dict (reference npz layout), or
    a path to a model ``.npz`` file -- the typed front door used by
    ``GDMLPredict`` and ``MDEngine``.
    """
    if isinstance(model, GDMLModel):
        return model.data
    if isinstance(model, dict):
        return model
    if isinstance(model, (str, bytes)) or hasattr(model, '__fspath__'):
        return GDMLModel.load(model).data
    raise TypeError(
        'Expected a GDMLModel, a model dict, or a model file path; got %r'
        % type(model)
    )


def model_to_torch(model, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Carry a model's weights over to tensors on ``device``.

    Returns
    -------
    ``R_desc (M, D)``: training descriptors, transposed from the file's
    ``(D, M)``; ``R_d_desc_alpha (M, D)``; ``desc_perms (P, D)`` int64
    descriptor permutations; ``alphas_E_lin (M*P,)`` -- ``alphas_E``
    repeated over the permutations, table layout ``t = m * P + p`` -- when
    the model is energy-constrained; ``lattice`` and ``lattice_inv (3, 3)``
    when it is periodic. Floating tensors are in ``dtype``.
    """
    from ..predict import desc_perm_table

    model = as_model_dict(model)
    device = torch.device(device)

    def floats(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    perms = np.asarray(model['perms'])
    out = {
        'R_desc': floats(np.asarray(model['R_desc']).T).contiguous(),
        'R_d_desc_alpha': floats(model['R_d_desc_alpha']),
        'desc_perms': torch.as_tensor(desc_perm_table(perms), device=device),
    }
    if model.get('alphas_E') is not None:
        out['alphas_E_lin'] = torch.repeat_interleave(floats(model['alphas_E']), perms.shape[0])
    if 'lattice' in model:
        lat = np.asarray(model['lattice'], dtype=np.float64)
        out['lattice'] = floats(lat)
        out['lattice_inv'] = floats(np.linalg.inv(lat))
    return out


@dataclasses.dataclass
class GDMLModel:
    """A trained (s)GDML force-field model."""

    data: dict

    # -- constructors -------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> 'GDMLModel':
        data = io.load_dict(path)
        if not io.is_model(data):
            raise ValueError('%s is not a model file.' % path)
        return cls(data)

    def save(self, path: str):
        io.save_dict(path, self.data)

    # -- typed accessors -----------------------------------------------------

    @property
    def n_atoms(self) -> int:
        return int(self.data['z'].shape[0])

    @property
    def n_train(self) -> int:
        return int(np.asarray(self.data['R_desc']).shape[1])

    @property
    def n_perms(self) -> int:
        return int(np.asarray(self.data['perms']).shape[0])

    @property
    def sig(self) -> float:
        return float(np.squeeze(self.data['sig']))

    @property
    def lam(self) -> float:
        return float(np.squeeze(self.data['lam']))

    @property
    def std(self) -> float:
        return float(np.squeeze(self.data.get('std', 1.0)))

    @property
    def c(self) -> float:
        return float(np.squeeze(self.data.get('c', 0.0)))

    @property
    def uses_energies(self) -> bool:
        return bool(self.data.get('use_E', True))

    @property
    def uses_symmetries(self) -> bool:
        return self.n_perms > 1

    @property
    def solver(self) -> str:
        s = self.data.get('solver_name', 'analytic')
        return s.decode() if isinstance(s, bytes) else str(s)

    @property
    def f_err(self) -> dict:
        e = self.data.get('f_err', {})
        return e.item() if isinstance(e, np.ndarray) else e

    @property
    def e_err(self) -> dict:
        e = self.data.get('e_err', {})
        return e.item() if isinstance(e, np.ndarray) else e

    @property
    def lattice(self):
        return self.data.get('lattice')

    # -- engines -------------------------------------------------------------

    def predictor(self, **kwargs):
        """A :class:`~sgdml_tpu_torch.predict.GDMLPredict` (on the GPU unless ``device=`` says otherwise)."""
        from ..predict import GDMLPredict

        return GDMLPredict(self.data, **kwargs)

    def md_engine(self, **kwargs):
        """A :class:`~sgdml_tpu_torch.md.MDEngine` (on the GPU unless ``device=`` says otherwise)."""
        from ..md import MDEngine

        return MDEngine(self.data, **kwargs)

    def __repr__(self):
        return (
            'GDMLModel(n_atoms=%d, n_train=%d, n_perms=%d, sig=%g, '
            'solver=%s)'
            % (self.n_atoms, self.n_train, self.n_perms, self.sig, self.solver)
        )
