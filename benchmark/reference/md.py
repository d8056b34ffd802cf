"""Plain reference for ``MDEngine.run_nve``: velocity Verlet on the forces
of :mod:`.predict`'s plain model.

A snapshot of the trajectory is judged by its energies at its own
geometry, and a pair of consecutive snapshots by integrating the first
over the steps between them and comparing the second.
"""

from __future__ import annotations

import numpy as np
import torch

from .predict import Model, worst

__all__ = ['integrate', 'judge']


def integrate(model: Model, r, v, masses, dt: float, n_steps: int):
    """Velocity Verlet from positions r and velocities v (B, N, 3):
    v += dt/2 F/m, r += dt v, v += dt/2 F(r)/m, ``n_steps`` times, each of
    the B trajectories on its own. Returns (r, v, E_pot, E_kin) as float64
    numpy."""
    dev, dtype = model.device, model.dtype
    r = torch.as_tensor(np.asarray(r), dtype=dtype, device=dev).clone()
    v = torch.as_tensor(np.asarray(v), dtype=dtype, device=dev).clone()
    m = torch.as_tensor(np.asarray(masses), dtype=dtype, device=dev)[None, :, None]

    def forces(r):
        E, F = model.forces(r)
        return E, F.reshape(r.shape)

    _, f = forces(r)
    for _ in range(n_steps):
        v = v + 0.5 * dt * f / m
        r = r + dt * v
        _, f = forces(r)
        v = v + 0.5 * dt * f / m
    E, _ = forces(r)
    ke = 0.5 * torch.sum(m * v * v, dim=(1, 2))
    return tuple(x.double().cpu().numpy() for x in (r, v, E, ke))


def judge(model: Model, masses, dt: float, steps_between: int, pairs):
    """``pairs``: [(snapshot, next snapshot)], each a dict of ``r``, ``v``
    (N, 3), ``E_pot`` and ``E_kin`` as the program wrote them. Returns
    ``{'energy': the largest error of a snapshot's E_pot or E_kin over the
    largest |E_pot| or E_kin, 'step': the largest error of the next
    snapshot's r or v over the largest distance r moved or the largest
    |v|}``."""
    first = {k: np.stack([p[0][k] for p in pairs]) for k in ('r', 'v', 'E_pot', 'E_kin')}
    then = {k: np.stack([p[1][k] for p in pairs]) for k in ('r', 'v', 'E_pot', 'E_kin')}
    r, v, E, ke = integrate(model, first['r'], first['v'], masses, dt, steps_between)
    E0, _ = model.predict(first['r'])
    m = np.asarray(masses)[None, :, None]
    ke0 = 0.5 * np.sum(m * first['v'] ** 2, axis=(1, 2))
    e_scale = max(worst(E0), worst(E), worst(ke0), worst(ke))
    energy = max(worst(first['E_pot'] - E0), worst(then['E_pot'] - E), worst(first['E_kin'] - ke0),
                 worst(then['E_kin'] - ke)) / e_scale
    step = max(worst(then['r'] - r) / worst(r - first['r']), worst(then['v'] - v) / worst(v))
    return {'energy': energy, 'step': step}
