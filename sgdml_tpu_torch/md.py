"""Molecular dynamics on trained (s)GDML models, on one device.

The trajectory stays on the device: positions, velocities and forces are
tensors, and each step is a handful of device operations around one
(E, F) prediction (the fused kernel on a GPU). Only the snapshots come back
to the host, once, at the end.

Integrators: velocity Verlet (NVE) and Langevin (NVT, BAOAB splitting).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import resolve_device
from .models.gdml import as_model_dict, model_to_torch
from .ops import descriptor as desc_ops
from .predict import build_tables, center_tables, predict_from_tables
from .utils.io import ATOMIC_MASSES

__all__ = ['MDEngine']


class MDEngine:
    """MD over a trained model dict on one device.

    Parameters
    ----------
    model: model dict (reference-compatible npz layout), GDMLModel or path.
    masses: ``(N,)`` atomic masses in u. Defaults to the standard atomic
        weights of the model's elements (``model['z']``) -- the same
        convention as the reference's ASE-driven MD
        (sgdml/intf/ase_calc.py:93-106).
    dtype: computation dtype (``torch.float64`` default).
    device: the device to run on: the GPU unless the caller asks for the
        CPU (``device='cpu'``); without a card the default raises.
    """

    def __init__(self, model, masses=None, dtype=torch.float64, *, device='cuda'):
        model = as_model_dict(model)
        if masses is None:
            masses = ATOMIC_MASSES[np.asarray(model['z'], dtype=np.int64)]
        self.device = resolve_device(device)
        self.n_atoms = int(model['z'].shape[0])
        self.sig = float(np.squeeze(model['sig']))
        self.std = float(np.squeeze(model.get('std', 1.0)))
        self.c = float(np.squeeze(model.get('c', 0.0)))
        w = model_to_torch(model, self.device, dtype)
        self.tables = center_tables(*build_tables(w['R_desc'], w['R_d_desc_alpha'], w['desc_perms']))
        self.masses = torch.as_tensor(masses, dtype=dtype, device=self.device)
        self.dtype = dtype

    def energy_forces(self, r):
        """(E, F(N,3)) for a single geometry ``r (N, 3)`` tensor."""
        x, jc = desc_ops.descriptor_jacobian(r.reshape(-1), self.n_atoms)
        E, F = predict_from_tables(
            x[None], jc[None], self.tables, None,
            self.sig, self.std, self.c, n_atoms=self.n_atoms,
        )
        return E[0], F[0].reshape(self.n_atoms, 3)

    def _state(self, x):
        x = np.asarray(x).reshape(self.n_atoms, 3)
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _trajectory(self, r0, v0, n_steps, snapshot_every, substep):
        """Run ``n_steps // snapshot_every`` snapshots of ``snapshot_every``
        substeps each; return numpy (R (S,N,3), V, E_pot (S,), E_kin)."""
        r, v = self._state(r0), self._state(v0)
        _, f = self.energy_forces(r)
        snaps = []
        for _ in range(n_steps // snapshot_every):
            for _ in range(snapshot_every):
                r, v, f = substep(r, v, f)
            E, _ = self.energy_forces(r)
            ke = 0.5 * torch.sum(self.masses[:, None] * v * v)
            snaps.append((r, v, E, ke))
        return tuple(torch.stack(x).cpu().numpy() for x in zip(*snaps))

    def run_nve(self, r0, v0, dt, n_steps, snapshot_every: int = 1):
        """NVE (velocity Verlet). Returns (R (S,N,3), V, E_pot (S,), E_kin)."""
        inv_m = 1.0 / self.masses[:, None]

        def substep(r, v, f):
            v_half = v + 0.5 * dt * f * inv_m
            r = r + dt * v_half
            _, f = self.energy_forces(r)
            v = v_half + 0.5 * dt * f * inv_m
            return r, v, f

        return self._trajectory(r0, v0, n_steps, snapshot_every, substep)

    def run_langevin(
        self, r0, v0, dt, n_steps, friction=0.01, kT=0.1, seed=0,
        snapshot_every: int = 1,
    ):
        """Langevin (BAOAB) thermostatted dynamics on the device. The noise
        comes from a ``torch.Generator`` on the device seeded with ``seed``;
        its numbers differ from ``jax.random``'s."""
        inv_m = 1.0 / self.masses[:, None]
        c1 = math.exp(-friction * dt)
        sigma_v = torch.sqrt(kT * (1 - c1**2) / self.masses)[:, None]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def substep(r, v, f):
            v = v + 0.5 * dt * f * inv_m
            r = r + 0.5 * dt * v
            noise = torch.randn(r.shape, generator=gen, dtype=r.dtype, device=r.device)
            v = c1 * v + sigma_v * noise
            r = r + 0.5 * dt * v
            _, f = self.energy_forces(r)
            v = v + 0.5 * dt * f * inv_m
            return r, v, f

        return self._trajectory(r0, v0, n_steps, snapshot_every, substep)
