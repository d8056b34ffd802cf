"""Synthetic molecular-dynamics trajectories: the benchmark's own frozen copy
of ``sgdml_tpu_torch/datasets/synthetic.py`` (``make_molecule``,
``MorseField``, ``generate_md_dataset``), so that a change to the program
cannot change the benchmark's inputs.

A pairwise Morse potential whose equilibrium distances come from a random
chain-like reference geometry, sampled along a Langevin velocity-Verlet
trajectory (host numpy). One departure from the program's copy: the
molecule and the trajectory take separate seeds, so that a configuration
fixes the molecule and a run's seed draws the trajectory.
"""

from __future__ import annotations

import numpy as np

__all__ = ['MorseField', 'make_molecule', 'generate_md_dataset']


def make_molecule(n_atoms: int, seed: int = 0):
    """Random but well-separated reference geometry + species vector."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_atoms, 3))
    for i in range(1, n_atoms):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        pos[i] = pos[i - 1] + direction * (1.2 + 0.3 * rng.random())
        for _ in range(50):
            d = np.linalg.norm(pos[i] - pos[:i], axis=1)
            if d.min() > 1.0:
                break
            pos[i] += (pos[i] - pos[d.argmin()]) * 0.3
    z = rng.choice([1, 6, 7, 8], size=n_atoms)
    return pos, z


class MorseField:
    """E = sum_{a<b} w_ab (1 - exp(-k (r_ab - r0_ab)))^2, F = -dE/dR, with
    w_ab = 1 / r0_ab^2."""

    def __init__(self, ref_pos: np.ndarray, k: float = 1.5):
        self.r0 = np.linalg.norm(ref_pos[:, None] - ref_pos[None, :], axis=-1)
        self.k = k
        with np.errstate(divide='ignore'):
            w = 1.0 / np.maximum(self.r0, 1e-9) ** 2
        np.fill_diagonal(w, 0.0)
        self.w = w

    def energy_forces(self, R: np.ndarray):
        """R: (B, N, 3) -> (E (B,), F (B, N, 3))."""
        R = np.asarray(R)
        if R.ndim == 2:
            R = R[None]
        diff = R[:, :, None, :] - R[:, None, :, :]
        dist = np.linalg.norm(diff, axis=-1)
        np.einsum('bii->bi', dist)[:] = 1.0
        ex = np.exp(-self.k * (dist - self.r0[None]))
        pair_e = self.w[None] * (1.0 - ex) ** 2
        E = 0.5 * pair_e.sum(axis=(1, 2))
        dedr = self.w[None] * 2.0 * (1.0 - ex) * self.k * ex
        np.einsum('bii->bi', dedr)[:] = 0.0
        F = -np.einsum('bij,bijc->bic', dedr / dist, diff)
        return E, F


def generate_md_dataset(n_atoms: int, n_frames: int, molecule_seed: int, seed: int, dt: float = 0.05,
                        friction: float = 0.05, temperature: float = 0.06, burn_in: int = 200):
    """A dataset dict in the reference npz layout (z, R, E, F, name,
    theory, units) of ``n_frames`` frames after ``burn_in`` steps."""
    rng = np.random.default_rng(seed)
    ref_pos, z = make_molecule(n_atoms, seed=molecule_seed)
    field = MorseField(ref_pos)
    r = ref_pos.copy()
    v = rng.normal(size=r.shape) * np.sqrt(temperature)
    frames, energies, forces = [], [], []
    f = field.energy_forces(r[None])[1][0]
    c1 = np.exp(-friction * dt)
    for step in range(burn_in + n_frames):
        v = v + 0.5 * dt * f
        r = r + 0.5 * dt * v
        v = c1 * v + np.sqrt((1 - c1**2) * temperature) * rng.normal(size=v.shape)
        r = r + 0.5 * dt * v
        e, f = field.energy_forces(r[None])
        e, f = e[0], f[0]
        v = v + 0.5 * dt * f
        if step >= burn_in:
            frames.append(r.copy())
            energies.append(e)
            forces.append(f.copy())
    return {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array('synth%d' % n_atoms),
        'theory': np.array('morse'),
        'z': z,
        'R': np.array(frames),
        'E': np.array(energies),
        'F': np.array(forces),
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
