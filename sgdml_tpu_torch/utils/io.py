"""File schemas, fingerprints and schema checks.

On-disk formats are dict-of-ndarray ``.npz`` files discriminated by a
``type`` key -- ``'d'`` dataset / ``'t'`` task / ``'m'`` model -- in the
reference implementation's key layout (sgdml/utils/io.py), the same files
``sgdml_tpu.utils.io`` reads and writes. Plain numpy, re-homed here so that
the port never imports the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = [
    'ATOMIC_MASSES',
    'dataset_md5',
    'load_dict',
    'save_dict',
    'artifact_type',
    'is_dataset',
    'is_task',
    'is_model',
    'validate_dataset',
]

# Standard atomic weights (u), indexed by nuclear charge Z (IUPAC 2021
# abridged values; most-stable isotope for the unstable elements). Same
# numbers ASE ships, so MD trajectories match the reference's ASE-driven
# dynamics (sgdml/intf/ase_calc.py).
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999,
    18.998, 20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06,
    35.45, 39.948, 39.098, 40.078, 44.956, 47.867, 50.942, 51.996,
    54.938, 55.845, 58.933, 58.693, 63.546, 65.38, 69.723, 72.630,
    74.922, 78.971, 79.904, 83.798, 85.468, 87.62, 88.906, 91.224,
    92.906, 95.95, 97.0, 101.07, 102.91, 106.42, 107.87, 112.41,
    114.82, 118.71, 121.76, 127.60, 126.90, 131.29, 132.91, 137.33,
    138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96, 157.25,
    158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
    180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
    204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0,
    232.04, 231.04, 238.03, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0,
    252.0, 257.0, 258.0, 259.0, 262.0, 267.0, 270.0, 269.0, 270.0,
    270.0, 278.0, 281.0, 281.0, 285.0, 286.0, 289.0, 289.0, 293.0,
    293.0, 294.0,
])


def dataset_md5(dataset: dict) -> bytes:
    """MD5 fingerprint over ``z, R, [E], F`` (matches the reference's
    algorithm, sgdml/utils/io.py:208-230, for cross-framework provenance)."""
    md5_hash = hashlib.md5()
    keys = ['z', 'R']
    if 'E' in dataset:
        keys.append('E')
    keys.append('F')
    for k in keys:
        d = dataset[k]
        if isinstance(d, np.ndarray):
            d = np.ascontiguousarray(d).ravel()
        md5_hash.update(hashlib.md5(d).digest())
    return md5_hash.hexdigest().encode('utf-8')


def load_dict(path: str) -> dict:
    """Load an npz artifact into a plain dict (0-d object arrays unwrapped
    where the reference stores scalars)."""
    with np.load(path, allow_pickle=True) as handle:
        out = dict(handle)
    for k, v in out.items():
        if isinstance(v, np.ndarray) and v.ndim == 0:
            out[k] = v[()] if v.dtype == object else v.item()
    return out


def save_dict(path: str, data: dict):
    np.savez_compressed(path, **data)


def artifact_type(data: dict) -> str:
    t = data.get('type')
    if isinstance(t, bytes):
        t = t.decode()
    if isinstance(t, np.ndarray):
        t = str(np.squeeze(t).item() if t.ndim == 0 else t)
    return str(t)


def is_dataset(data) -> bool:
    return artifact_type(data) == 'd'


def is_task(data) -> bool:
    return artifact_type(data) == 't'


def is_model(data) -> bool:
    return artifact_type(data) == 'm'


def validate_dataset(dataset: dict):
    """Schema check for dataset dicts (reference: sgdml/utils/io.py:327-411)."""
    if not is_dataset(dataset):
        raise ValueError("Not a dataset ('type' != 'd').")
    for key in ('z', 'R', 'F', 'name'):
        if key not in dataset:
            raise ValueError("Dataset is missing key '%s'." % key)
    R, F, z = dataset['R'], dataset['F'], dataset['z']
    if R.ndim != 3 or R.shape[2] != 3:
        raise ValueError('R must have shape (n_geoms, n_atoms, 3).')
    if F.shape != R.shape:
        raise ValueError('F must match the shape of R.')
    if z.shape[0] != R.shape[1]:
        raise ValueError('z length must equal the number of atoms.')
    if 'E' in dataset and dataset['E'].shape[0] != R.shape[0]:
        raise ValueError('E must have one entry per geometry.')
    if 'lattice' in dataset:
        lat = dataset['lattice']
        if lat.shape != (3, 3):
            raise ValueError('lattice must be 3x3 (vectors as columns).')
        if abs(np.linalg.det(lat)) < 1e-12:
            raise ValueError('lattice vectors are not invertible.')
    return dataset
