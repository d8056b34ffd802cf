"""Synthetic molecular-dynamics datasets for tests and benchmarks.

Real sGDML benchmark datasets (ethanol, aspirin, MD22) are DFT trajectories
downloaded from quantum-machine.org; tests and the GPU smoke run work
offline, so they use synthetic but *physically structured* data: a pairwise
Morse potential whose equilibrium distances come from a reference geometry,
sampled along a Langevin-thermostatted velocity-Verlet trajectory. Like the
real datasets, samples live on a low-dimensional manifold (correlated
frames), which is what makes kernel force-field reconstruction work.

Plain numpy, kept identical to ``sgdml_tpu.datasets.synthetic`` so that the
same seed gives the same geometries in both packages.

Standard systems mirror the reference benchmark sizes:
``ethanol``-like N=9, ``aspirin``-like N=21, ``AT-AT``-like N=60.
"""

from __future__ import annotations

import numpy as np

from ..utils import io

__all__ = [
    'SYSTEMS', 'make_molecule', 'MorseField', 'generate_md_dataset',
    'generate_symmetric_md_dataset',
]

SYSTEMS = {
    'ethanol_like': 9,
    'uracil_like': 12,
    'aspirin_like': 21,
    'atat_like': 60,
}


def make_molecule(n_atoms: int, seed: int = 0):
    """Random but well-separated reference geometry + species vector."""
    rng = np.random.default_rng(seed)
    # Grow a chain-like molecule: each atom placed near the previous one.
    pos = np.zeros((n_atoms, 3))
    for i in range(1, n_atoms):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        pos[i] = pos[i - 1] + direction * (1.2 + 0.3 * rng.random())
        # Nudge away from all previous atoms to avoid collisions.
        for _ in range(50):
            d = np.linalg.norm(pos[i] - pos[:i], axis=1)
            if d.min() > 1.0:
                break
            pos[i] += (pos[i] - pos[d.argmin()]) * 0.3
    z = rng.choice([1, 6, 7, 8], size=n_atoms)
    return pos, z


class MorseField:
    """Pairwise Morse potential with per-pair equilibrium distances.

    E = sum_{a<b} w_ab (1 - exp(-k (r_ab - r0_ab)))^2, F = -dE/dR.
    Bonded pairs (near in the reference geometry) get stiff wells; distant
    pairs get weak ones, giving molecule-like dynamics.
    """

    def __init__(self, ref_pos: np.ndarray, k: float = 1.5):
        n = ref_pos.shape[0]
        self.n_atoms = n
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
        diff = R[:, :, None, :] - R[:, None, :, :]  # (B, N, N, 3)
        dist = np.linalg.norm(diff, axis=-1)
        np.einsum('bii->bi', dist)[:] = 1.0  # avoid /0 on diagonal
        ex = np.exp(-self.k * (dist - self.r0[None]))
        morse = (1.0 - ex) ** 2
        pair_e = self.w[None] * morse
        E = 0.5 * pair_e.sum(axis=(1, 2))
        # dE/dr_ab = w * 2 (1 - ex) * k * ex ; direction diff/dist
        dedr = self.w[None] * 2.0 * (1.0 - ex) * self.k * ex
        np.einsum('bii->bi', dedr)[:] = 0.0
        F = -np.einsum('bij,bijc->bic', dedr / dist, diff)
        return E, F


def generate_md_dataset(
    n_atoms: int = 9,
    n_frames: int = 1500,
    seed: int = 0,
    dt: float = 0.05,
    friction: float = 0.05,
    temperature: float = 0.06,
    name: str | None = None,
):
    """Langevin velocity-Verlet trajectory dataset dict (type 'd').

    Returns a dataset in the reference npz layout: z (N,), R (n, N, 3),
    E (n,), F (n, N, 3), name/theory/md5.
    """
    rng = np.random.default_rng(seed)
    ref_pos, z = make_molecule(n_atoms, seed=seed)
    field = MorseField(ref_pos)

    r = ref_pos.copy()
    v = rng.normal(size=r.shape) * np.sqrt(temperature)
    frames, energies, forces = [], [], []

    _, f = field.energy_forces(r[None])
    f = f[0]
    burn_in = 200
    for step in range(burn_in + n_frames):
        # Langevin BAOAB-ish integration (host NumPy; data generation only).
        v = v + 0.5 * dt * f
        r = r + 0.5 * dt * v
        c1 = np.exp(-friction * dt)
        v = c1 * v + np.sqrt((1 - c1**2) * temperature) * rng.normal(size=v.shape)
        r = r + 0.5 * dt * v
        e, f = field.energy_forces(r[None])
        e, f = e[0], f[0]
        v = v + 0.5 * dt * f
        if step >= burn_in:
            frames.append(r.copy())
            energies.append(e)
            forces.append(f.copy())

    dataset = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array(name or ('synth%d' % n_atoms)),
        'theory': np.array('morse'),
        'z': z,
        'R': np.array(frames),
        'E': np.array(energies),
        'F': np.array(forces),
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
    dataset['md5'] = io.dataset_md5(dataset)
    dataset['E_min'], dataset['E_max'] = dataset['E'].min(), dataset['E'].max()
    dataset['E_mean'], dataset['E_var'] = dataset['E'].mean(), dataset['E'].var()
    dataset['F_min'], dataset['F_max'] = dataset['F'].min(), dataset['F'].max()
    dataset['F_mean'], dataset['F_var'] = dataset['F'].mean(), dataset['F'].var()
    return dataset


def generate_symmetric_md_dataset(n_frames: int = 800, seed: int = 0):
    """A molecule with an exact permutation symmetry (for sym-discovery
    tests): two identical 'methyl-like' H3 groups attached to a C-C core,
    mirroring why benzene/toluene need sGDML.

    Atoms: [C, C, H, H, H, H, H, H] — swapping the two CH3 groups and
    rotating each H3 triple are physical symmetries of the Morse field
    because equilibrium distances are built symmetric.
    """
    # Symmetric reference geometry.
    c1 = np.array([0.0, 0.0, 0.0])
    c2 = np.array([1.5, 0.0, 0.0])

    def h3(center, sign):
        out = []
        for ang in (0, 2 * np.pi / 3, 4 * np.pi / 3):
            out.append(
                center
                + np.array(
                    [sign * 0.36, 0.94 * np.cos(ang), 0.94 * np.sin(ang)]
                )
            )
        return out

    ref_pos = np.array([c1, c2] + h3(c1, -1) + h3(c2, +1))
    z = np.array([6, 6, 1, 1, 1, 1, 1, 1])

    rng = np.random.default_rng(seed)
    field = MorseField(ref_pos, k=2.0)

    r = ref_pos.copy()
    v = rng.normal(size=r.shape) * np.sqrt(0.02)
    frames, energies, forces = [], [], []
    _, f = field.energy_forces(r[None])
    f = f[0]
    dt, friction, temperature = 0.04, 0.05, 0.02
    for step in range(200 + n_frames):
        v = v + 0.5 * dt * f
        r = r + 0.5 * dt * v
        c1_ = np.exp(-friction * dt)
        v = c1_ * v + np.sqrt((1 - c1_**2) * temperature) * rng.normal(size=v.shape)
        r = r + 0.5 * dt * v
        e, f = field.energy_forces(r[None])
        e, f = e[0], f[0]
        v = v + 0.5 * dt * f
        if step >= 200:
            frames.append(r.copy())
            energies.append(e)
            forces.append(f.copy())

    # Real MD visits symmetry-equivalent basins (e.g. methyl rotations at
    # 500 K); emulate that by relabeling a random subset of frames with
    # exact group elements. Atoms: [C0, C1, H(C0) x3, H(C1) x3].
    # The field's symmetry group (order 6): swap the two CH3 units, and
    # correlated C3 rotations of both H triples.
    swap = np.array([1, 0, 5, 6, 7, 2, 3, 4])
    rot = np.array([0, 1, 3, 4, 2, 6, 7, 5])
    group = [np.arange(8), rot, rot[rot], swap, swap[rot], swap[rot[rot]]]

    frames = np.array(frames)
    forces = np.array(forces)
    for i in range(len(frames)):
        g = group[rng.integers(len(group))]
        frames[i] = frames[i][g]
        forces[i] = forces[i][g]

    dataset = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array('synth_sym'),
        'theory': np.array('morse'),
        'z': z,
        'R': np.array(frames),
        'E': np.array(energies),
        'F': np.array(forces),
    }
    dataset['md5'] = io.dataset_md5(dataset)
    return dataset
