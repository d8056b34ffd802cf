"""A synthetic molecule with a permutation group of order 6, for the
benchmark's symmetric configurations.

The reference geometry has the rigid point group C3v: N mod 6 atoms on
the z axis and N // 6 generic orbits of six atoms each (a point at azimuth
+phi and its mirror image at -phi, each turned by 0, 120 and 240 degrees):
at the MD17 aspirin width, N = 21, three on the axis and three orbits.
A point group acts on the atoms as a permutation group: element g maps
atom a onto the place of atom pi_g(a). Pair distances of the reference
are invariant under these six permutations, so the Morse field built on
them (``benchmark/synthetic.py``'s ``MorseField``) is too: E(R[pi]) = E(R)
and F(R[pi]) = F(R)[pi].

The trajectory is the Langevin velocity-Verlet loop of
``synthetic.generate_md_dataset``; as a real trajectory visits
symmetry-equivalent basins, each frame is then relabelled by a group
element drawn from the seed (as ``generate_symmetric_md_dataset`` of the
program's own synthetic module does). The dataset carries the six
permutations under ``perms``, so that a task takes them from there and no
symmetry search runs.

The molecule is fixed by ``molecule_seed``; the trajectory and the
relabelling come from ``seed``.
"""

from __future__ import annotations

import numpy as np

from benchmark.synthetic import MorseField

__all__ = ['GROUP_ORDER', 'generate_md_dataset', 'group_perms', 'layout', 'make_molecule']

GROUP_ORDER = 6
# Elements of the axis atoms and of the orbits, in turn.
AXIS_Z = (6, 7, 8, 6, 7)
ORBIT_Z = (6, 1, 8)


def _rotation(deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    return np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0], [0.0, 0.0, 1.0]])


def _group_matrices() -> list:
    """The six elements of C3v as 3x3 matrices: the turns by 0, 120 and
    240 degrees about z, and each after the mirror y -> -y."""
    mirror = np.diag([1.0, -1.0, 1.0])
    turns = [_rotation(a) for a in (0.0, 120.0, 240.0)]
    return turns + [t @ mirror for t in turns]


def layout(n_atoms: int):
    """(atoms on the axis, orbits of six) of an ``n_atoms`` molecule."""
    if n_atoms < 6:
        raise ValueError('a C3v molecule here has at least one orbit of six atoms, not %d atoms' % n_atoms)
    return n_atoms % 6, n_atoms // 6


def make_molecule(n_atoms: int, seed: int = 0, min_dist: float = 1.0):
    """(positions (N, 3), species (N,)) of a C3v molecule: axis atoms
    first, then each orbit as [+phi turned 0, 120, 240; -phi turned 0, 120,
    240]. Radii, heights and azimuths are drawn from ``seed`` until every
    pair of atoms is at least ``min_dist`` apart."""
    n_axis, k = layout(n_atoms)
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        axis = np.zeros((n_axis, 3))
        axis[:, 2] = np.sort(rng.uniform(-2.0, 2.0, size=n_axis)) + 0.8 * np.arange(n_axis) - 0.4 * (n_axis - 1)
        pos = [axis]
        for _ in range(k):
            r, h, phi = rng.uniform(1.6, 3.0), rng.uniform(-2.5, 2.5), np.deg2rad(rng.uniform(20.0, 40.0))
            base = [np.array([r * np.cos(s * phi), r * np.sin(s * phi), h]) for s in (1, -1)]
            pos.append(np.array([_rotation(a) @ b for b in base for a in (0.0, 120.0, 240.0)]))
        pos = np.concatenate(pos)
        dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        if dist[np.triu_indices(n_atoms, 1)].min() >= min_dist:
            z = np.array(list(AXIS_Z[:n_axis]) + [ORBIT_Z[i % len(ORBIT_Z)] for i in range(k) for _ in range(6)])
            return pos, z
    raise RuntimeError('no well-separated C3v molecule from seed %d' % seed)


def group_perms(pos: np.ndarray) -> np.ndarray:
    """(6, N) atom permutations of the group, the identity first: row g
    holds pi_g with g(pos[a]) = pos[pi_g(a)]."""
    out = []
    for g in _group_matrices():
        moved = pos @ g.T
        dist = np.linalg.norm(moved[:, None] - pos[None], axis=-1)
        perm = np.argmin(dist, axis=1)
        if not np.allclose(dist[np.arange(len(pos)), perm], 0.0, atol=1e-9):
            raise ValueError('the geometry is not invariant under the group')
        out.append(perm)
    perms = np.array(out, dtype=np.int64)
    if len({tuple(p) for p in perms}) != GROUP_ORDER:
        raise ValueError('the group acts on the atoms with fewer than %d permutations' % GROUP_ORDER)
    return perms


def generate_md_dataset(n_atoms: int, n_frames: int, molecule_seed: int, seed: int, dt: float = 0.05,
                        friction: float = 0.05, temperature: float = 0.06, burn_in: int = 200):
    """A dataset dict in the reference npz layout (z, R, E, F, perms, name,
    theory, units): ``n_frames`` frames after ``burn_in`` Langevin steps,
    each relabelled by a group element drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ref_pos, z = make_molecule(n_atoms, seed=molecule_seed)
    perms = group_perms(ref_pos)
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
    R, F = np.array(frames), np.array(forces)
    labels = perms[rng.integers(GROUP_ORDER, size=n_frames)]
    rows = np.arange(n_frames)[:, None]
    return {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array('synth_c3v_%d' % n_atoms),
        'theory': np.array('morse'),
        'z': z,
        'R': R[rows, labels],
        'E': np.array(energies),
        'F': F[rows, labels],
        'perms': perms,
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
