"""File schemas, fingerprints, artifact naming, xyz files and argument types.

On-disk formats are dict-of-ndarray ``.npz`` files discriminated by a
``type`` key -- ``'d'`` dataset / ``'t'`` task / ``'m'`` model -- in the
reference implementation's key layout (sgdml/utils/io.py), the same files
``sgdml_tpu.utils.io`` reads and writes, under the same names. Plain numpy,
re-homed here so that the port never imports the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re

import numpy as np

__all__ = [
    'ATOMIC_MASSES',
    'SYMBOL_TO_Z',
    'Z_TO_SYMBOL',
    'dataset_md5',
    'train_dir_name',
    'task_file_name',
    'model_file_name',
    'load_dict',
    'save_dict',
    'artifact_type',
    'is_dataset',
    'is_task',
    'is_model',
    'validate_dataset',
    'read_xyz',
    'write_xyz',
    'generate_xyz_str',
    'lattice_vec_to_par',
    'parse_list_or_range',
    'filter_file_type',
    'is_file_type',
    'is_valid_file_type',
    'is_dir_with_file_type',
    'is_strict_pos_int',
    'is_task_dir_resumable',
]

# Element symbol <-> nuclear charge tables (standard periodic table).
_Z_STR = (
    'X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe '
    'Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn '
    'Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W '
    'Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf '
    'Es Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og'
).split()

Z_TO_SYMBOL = {z: s for z, s in enumerate(_Z_STR)}
SYMBOL_TO_Z = {s: z for z, s in enumerate(_Z_STR)}

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


def train_dir_name(dataset, n_train, use_sym, use_E, use_E_cstr) -> str:
    """Deterministic training-run directory name (parity:
    sgdml/utils/io.py:162-180)."""
    theory = re.sub(r'[^\w\-_\.]', '.', str(np.asarray(dataset['theory']).item()
                                             if hasattr(dataset['theory'], 'item')
                                             else dataset['theory']))
    theory = re.sub(r'\.\.', '.', theory)
    parts = '-sym' if use_sym else ''
    parts += '' if use_E else '-noE'
    parts += '-Ecstr' if use_E_cstr else ''
    name = np.asarray(dataset['name']).astype(str)
    name = name.item() if name.ndim == 0 else str(name)
    return 'sgdml_cv_%s-%s-train%d%s' % (name, theory, n_train, parts)


def task_file_name(task: dict) -> str:
    n_train = task['idxs_train'].shape[0]
    n_perms = task['perms'].shape[0]
    sig = np.squeeze(task['sig'])
    return 'task-train%d-sym%d-sig%04d.npz' % (n_train, n_perms, sig)


def model_file_name(task_or_model: dict, is_extended: bool = False) -> str:
    n_train = task_or_model['idxs_train'].shape[0]
    n_perms = task_or_model['perms'].shape[0]
    sig = np.squeeze(task_or_model['sig'])
    if is_extended:
        dataset = np.squeeze(task_or_model['dataset_name'])
        theory = re.sub(
            r'[^\w\-_\.]', '.', str(np.squeeze(task_or_model['dataset_theory']))
        )
        theory = re.sub(r'\.\.', '.', theory)
        return '%s-%s-train%d-sym%d.npz' % (dataset, theory, n_train, n_perms)
    return 'model-train%d-sym%d-sig%04d.npz' % (n_train, n_perms, sig)


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


def read_xyz(path: str):
    """Read a (multi-frame) xyz file -> (R (n, 3N), z (N,))."""
    R, z = [], []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    n_atoms = None
    first = True
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip().split()[0])
        frame = lines[i + 2 : i + 2 + n_atoms]
        for row in frame:
            cols = row.split()
            R.append([float(c) for c in cols[1:4]])
            if first:
                z.append(SYMBOL_TO_Z[cols[0]])
        first = False
        i += 2 + n_atoms
    R = np.array(R).reshape(-1, 3 * n_atoms)
    return R, np.array(z)


def write_xyz(path: str, r, z, comment: str = ''):
    r = np.asarray(r).reshape(-1, 3)
    with open(path, 'w') as f:
        f.write('%d\n%s' % (len(r), comment))
        for zi, row in zip(z, r):
            f.write('\n%s\t%s' % (Z_TO_SYMBOL[int(zi)], '\t'.join(str(x) for x in row)))


def generate_xyz_str(r, z, e=None, f=None, lattice=None) -> str:
    """Extended-xyz frame string (reference: sgdml/utils/io.py:278-300)."""
    comment = ''
    if lattice is not None:
        comment += 'Lattice="{}" '.format(
            ' '.join('{:.12g}'.format(v) for v in np.asarray(lattice).T.ravel())
        )
    if e is not None:
        comment += 'Energy={:.12g} '.format(float(e))
    comment += 'Properties=species:S:1:pos:R:3'
    if f is not None:
        comment += ':forces:R:3'
    r = np.asarray(r).reshape(-1, 3)
    f_arr = None if f is None else np.asarray(f).reshape(-1, 3)
    lines = ['%d' % len(r), comment]
    for i, (zi, row) in enumerate(zip(z, r)):
        cells = [Z_TO_SYMBOL[int(zi)]] + ['%.12g' % x for x in row]
        if f_arr is not None:
            cells += ['%.12g' % x for x in f_arr[i]]
        lines.append('\t'.join(cells))
    return '\n'.join(lines)


def lattice_vec_to_par(lat):
    """Lattice vectors (columns) -> (lengths, angles) in degrees."""
    lat = np.asarray(lat).T
    lengths = [float(np.linalg.norm(v)) for v in lat]
    angles = []
    for i in range(3):
        j, k = i - 1, i - 2
        ll = lengths[j] * lengths[k]
        if ll > 1e-16:
            x = np.dot(lat[j], lat[k]) / ll
            angles.append(float(180.0 / np.pi * np.arccos(np.clip(x, -1, 1))))
        else:
            angles.append(90.0)
    return lengths, angles


def parse_list_or_range(arg: str):
    """Parse '1,2,3' or '0:5:100' CLI range arguments
    (reference: sgdml/utils/io.py:667-708)."""
    if re.match(r'^\d+$', arg):
        return int(arg)
    if re.match(r'^[\d,]+$', arg):
        return [int(x) for x in arg.split(',') if x != '']
    m = re.match(r'^(\d+):(\d+):(\d+)$', arg)
    if m:
        start, step, stop = (int(m.group(i)) for i in (1, 2, 3))
        return list(range(start, stop + 1, step))
    raise ValueError("'%s' is not an integer, list, or range (start:step:stop)" % arg)


# ---------------------------------------------------------------------------
# Validating argparse types (reference: sgdml/utils/io.py:327-708)
# ---------------------------------------------------------------------------

_MD5_RE = re.compile(r'^[a-f0-9]{32}$')
_KIND_CODE = {'dataset': 'd', 'task': 't', 'model': 'm'}


def _arg_error(msg):
    return argparse.ArgumentTypeError(msg)


def filter_file_type(directory: str, kind: str, md5_match=None):
    """File names in ``directory`` whose npz artifact type matches ``kind``
    ('dataset' | 'task' | 'model'), optionally restricted to dataset files
    whose MD5 fingerprint equals ``md5_match``
    (reference behavior: sgdml/utils/io.py:414-461).
    """
    code = _KIND_CODE[kind]
    if md5_match is not None and isinstance(md5_match, str):
        md5_match = md5_match.encode('utf-8')
    names = []
    for name in sorted(os.listdir(directory)):
        if not name.endswith('.npz'):
            continue
        path = os.path.join(directory, name)
        try:
            data = load_dict(path)
        except Exception:
            raise _arg_error('%s contains unreadable .npz files' % directory)
        if artifact_type(data) != code:
            continue
        if md5_match is None:
            names.append(name)
        else:
            md5 = data.get('md5')
            if isinstance(md5, str):
                md5 = md5.encode('utf-8')
            if md5 == md5_match:
                names.append(name)
    return names


def is_file_type(arg: str, kind: str):
    """Validate a file path of the given artifact kind; dataset arguments
    may also be an MD5 fingerprint (optionally prefixed with a directory),
    which is resolved against the matching dataset file
    (reference behavior: sgdml/utils/io.py:327-411).

    Returns ``(path, data_dict)``; raises ``argparse.ArgumentTypeError``.
    """
    if kind == 'dataset' and not arg.endswith('.npz') and not os.path.isdir(arg):
        if _MD5_RE.match(arg):
            directory, md5_str = '.', arg
        else:
            md5_str = os.path.basename(os.path.normpath(arg))
            directory = os.path.dirname(os.path.normpath(arg))
            if directory == '':
                raise _arg_error('%s is not a .npz file' % arg)
            if _MD5_RE.match(md5_str) and not os.path.isdir(directory):
                raise _arg_error('%s is not a directory' % directory)

        matches = filter_file_type(directory, kind, md5_match=md5_str)
        if not matches:
            raise _arg_error(
                "No %s files with fingerprint '%s' found in '%s'"
                % (kind, md5_str, directory)
            )
        if len(matches) > 1:
            raise _arg_error(
                "Multiple %s files with fingerprint '%s' found in '%s':\n%s"
                % (kind, md5_str, directory, '\n'.join('  ' + m for m in matches))
            )
        arg = os.path.join(directory, matches[0])

    if not arg.endswith('.npz'):
        raise _arg_error('%s is not a .npz file' % arg)
    try:
        data = load_dict(arg)
    except Exception:
        raise _arg_error('%s is not readable' % arg)
    if artifact_type(data) != _KIND_CODE[kind]:
        raise _arg_error('%s is not a %s file' % (arg, kind))
    return arg, data


def is_valid_file_type(arg: str):
    """Accept any of dataset/task/model
    (reference: sgdml/utils/io.py:464-511)."""
    for kind in ('dataset', 'task', 'model'):
        try:
            return is_file_type(arg, kind)
        except Exception:
            continue
    raise _arg_error('%s is neither a dataset, task, nor model file' % arg)


def is_dir_with_file_type(arg: str, kind: str, or_file: bool = False):
    """Validate a directory containing files of the given kind; with
    ``or_file`` a single file path acts as a one-file directory
    (reference: sgdml/utils/io.py:514-569).

    Returns ``(dir_path, [file_names])``.
    """
    if or_file and os.path.isfile(arg):
        is_file_type(arg, kind)  # raises on problems
        return os.path.dirname(arg), [os.path.basename(arg)]
    if not os.path.isdir(arg):
        raise _arg_error('%s is not a directory' % arg)
    return arg, filter_file_type(arg, kind)


def is_strict_pos_int(arg: str) -> int:
    """Validate a strictly positive integer CLI argument
    (reference: sgdml/utils/io.py:642-664)."""
    try:
        value = int(arg)
    except ValueError:
        raise _arg_error('%s is not an integer' % arg)
    if value <= 0:
        raise _arg_error('%s must be strictly positive' % arg)
    return value


def is_task_dir_resumable(
    task_dir, train_dataset, valid_dataset, n_train, n_valid, sigs, use_E_cstr
):
    """Check that an existing task directory matches the requested run
    configuration, so training can resume (reference: io.py:572-636)."""
    md5_train = dataset_md5(train_dataset)
    md5_valid = dataset_md5(valid_dataset)
    names = [n for n in os.listdir(task_dir) if n.startswith('task-')]
    found_sigs = set()
    for name in names:
        try:
            task = load_dict(os.path.join(task_dir, name))
        except Exception:
            return False
        if (
            task.get('md5_train') != md5_train
            or task.get('md5_valid') != md5_valid
            or task['idxs_train'].shape[0] != n_train
            or task['idxs_valid'].shape[0] != n_valid
            or bool(task.get('use_E_cstr', False)) != use_E_cstr
        ):
            return False
        found_sigs.add(int(np.squeeze(task['sig'])))
    return found_sigs == set(int(s) for s in sigs) if names else False
