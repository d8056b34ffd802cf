"""Create a dataset npz from any ASE-readable trajectory
(parity: reference scripts/sgdml_dataset_via_ase.py). Requires the
optional ASE dependency."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import io


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Create an sGDML dataset from any ASE-supported format.'
    )
    p.add_argument('traj_file')
    p.add_argument('-o', '--out', default=None)
    p.add_argument('--name', default=None)
    p.add_argument('--format', default=None, help='ASE format hint')
    args = p.parse_args(argv)

    try:
        from ase.io import iread
        from ase.units import kcal, mol
    except ImportError:
        raise SystemExit(
            'Optional ASE dependency not found! Install ase to use this '
            'converter.'
        )

    R, E, F = [], [], []
    z, lattice = None, None
    for atoms in iread(args.traj_file, format=args.format):
        if z is None:
            z = atoms.get_atomic_numbers()
            if atoms.pbc.any():
                lattice = np.asarray(atoms.get_cell().T)
        R.append(atoms.get_positions())
        F.append(atoms.get_forces() / (kcal / mol))
        try:
            E.append(atoms.get_potential_energy() / (kcal / mol))
        except Exception:
            pass

    name = args.name or os.path.splitext(os.path.basename(args.traj_file))[0]
    ds = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array(name),
        'theory': np.array('unknown'),
        'z': z,
        'R': np.array(R),
        'F': np.array(F),
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
    if len(E) == len(R):
        ds['E'] = np.array(E)
    if lattice is not None:
        ds['lattice'] = lattice
    ds['md5'] = io.dataset_md5(ds)
    out = args.out or name + '.npz'
    io.save_dict(out, ds)
    print('Saved %s: %d frames.' % (out, len(R)))


if __name__ == '__main__':
    main()
