"""Create a dataset npz from an extended-xyz trajectory file.

Parses the de-facto extxyz convention (reference:
scripts/sgdml_dataset_from_extxyz.py:95-126): per-frame comment lines with
``Lattice="..."``, ``Energy=...`` (or a bare number) and a
``Properties=species:S:1:pos:R:3:forces:R:3`` column layout.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

from ..utils import io


def _parse_info_line(line: str):
    """Extract (energy, lattice, properties-spec) from an extxyz comment."""
    info = {}
    # Quoted or bare key=value tokens.
    for m in re.finditer(r'(\w+)=("([^"]*)"|(\S+))', line):
        key = m.group(1)
        val = m.group(3) if m.group(3) is not None else m.group(4)
        info[key.lower()] = val

    energy = None
    for key in ('energy', 'e'):
        if key in info:
            try:
                energy = float(info[key])
            except ValueError:
                pass
    if energy is None:
        # Some producers put a bare number as the whole comment.
        try:
            energy = float(line.strip())
        except ValueError:
            energy = None

    lattice = None
    if 'lattice' in info:
        vals = np.fromstring(info['lattice'], sep=' ')
        if vals.size == 9:
            lattice = vals.reshape(3, 3).T  # row-major input, columns out

    return energy, lattice


def read_extxyz(path: str):
    """Parse a multi-frame extended-xyz file.

    Returns (z, R (n,N,3), E (n,) or None, F (n,N,3), lattice or None).
    """
    R, E, F = [], [], []
    z, lattice = None, None
    has_E = True
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip().split()[0])
        e, lat = _parse_info_line(lines[i + 1])
        if lat is not None:
            lattice = lat
        if e is None:
            has_E = False
        else:
            E.append(e)
        frame_z, r, f = [], [], []
        for row in lines[i + 2 : i + 2 + n_atoms]:
            cols = row.split()
            frame_z.append(io.SYMBOL_TO_Z[cols[0]])
            r.append([float(x) for x in cols[1:4]])
            if len(cols) >= 7:
                f.append([float(x) for x in cols[-3:]])
        if z is None:
            z = np.array(frame_z)
        if not f:
            raise ValueError(
                'Frame without force columns — datasets need forces.'
            )
        R.append(r)
        F.append(f)
        i += 2 + n_atoms
    return (
        z,
        np.array(R),
        np.array(E) if has_E and E else None,
        np.array(F),
        lattice,
    )


def create_dataset(xyz_path, name=None, theory='unknown', r_unit='Ang',
                   e_unit='kcal/mol'):
    z, R, E, F, lattice = read_extxyz(xyz_path)
    dataset = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array(name or os.path.splitext(os.path.basename(xyz_path))[0]),
        'theory': np.array(theory),
        'z': z,
        'R': R,
        'F': F,
        'r_unit': np.array(r_unit),
        'e_unit': np.array(e_unit),
    }
    if E is not None:
        dataset['E'] = E
        dataset['E_min'], dataset['E_max'] = E.min(), E.max()
        dataset['E_mean'], dataset['E_var'] = E.mean(), E.var()
    if lattice is not None:
        dataset['lattice'] = lattice
    dataset['F_min'], dataset['F_max'] = F.min(), F.max()
    dataset['F_mean'], dataset['F_var'] = F.mean(), F.var()
    dataset['md5'] = io.dataset_md5(dataset)
    return dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Create an sGDML dataset from an extended-xyz file.'
    )
    p.add_argument('xyz_file')
    p.add_argument('-o', '--out', default=None)
    p.add_argument('--name', default=None)
    p.add_argument('--theory', default='unknown')
    p.add_argument('--r_unit', default='Ang')
    p.add_argument('--e_unit', default='kcal/mol')
    args = p.parse_args(argv)

    ds = create_dataset(
        args.xyz_file, args.name, args.theory, args.r_unit, args.e_unit
    )
    out = args.out or (str(np.squeeze(ds['name'])) + '.npz')
    io.save_dict(out, ds)
    print(
        'Saved %s: %d geometries, %d atoms%s.'
        % (out, ds['R'].shape[0], ds['R'].shape[1],
           ', with energies' if 'E' in ds else '')
    )


if __name__ == '__main__':
    main()
