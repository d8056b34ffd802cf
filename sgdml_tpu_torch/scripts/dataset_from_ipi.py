"""Create a dataset npz from i-PI trajectory output
(parity: reference scripts/sgdml_dataset_from_ipi.py): positions and
forces come as separate xyz trajectories, energies from a (optionally
column-selected) properties file."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import io

BOHR_TO_ANG = 0.52917721067
HA_TO_KCAL_MOL = 627.509474


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Create an sGDML dataset from i-PI output files.'
    )
    p.add_argument('pos_xyz', help='positions trajectory (xyz)')
    p.add_argument('frc_xyz', help='forces trajectory (xyz)')
    p.add_argument('properties', nargs='?', default=None,
                   help='i-PI properties file with potential energies')
    p.add_argument('--e_col', type=int, default=3,
                   help='1-based column of the potential energy')
    p.add_argument('--atomic_units', action='store_true',
                   help='convert Bohr/Hartree -> Ang/kcal/mol')
    p.add_argument('-o', '--out', default=None)
    p.add_argument('--name', default=None)
    args = p.parse_args(argv)

    R, z = io.read_xyz(args.pos_xyz)
    F, _ = io.read_xyz(args.frc_xyz)
    n_atoms = z.size
    R = R.reshape(-1, n_atoms, 3)
    F = F.reshape(-1, n_atoms, 3)
    n = min(len(R), len(F))
    R, F = R[:n], F[:n]

    E = None
    if args.properties:
        rows = []
        with open(args.properties) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith('#'):
                    continue
                rows.append(float(line.split()[args.e_col - 1]))
        E = np.array(rows)[:n]

    if args.atomic_units:
        R = R * BOHR_TO_ANG
        F = F * (HA_TO_KCAL_MOL / BOHR_TO_ANG)
        if E is not None:
            E = E * HA_TO_KCAL_MOL

    name = args.name or os.path.splitext(os.path.basename(args.pos_xyz))[0]
    ds = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array(name),
        'theory': np.array('i-PI'),
        'z': z,
        'R': R,
        'F': F,
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
    if E is not None:
        ds['E'] = E
    ds['md5'] = io.dataset_md5(ds)
    out = args.out or name + '.npz'
    io.save_dict(out, ds)
    print('Saved %s: %d frames%s.' % (out, n, '' if E is None else ' (+E)'))


if __name__ == '__main__':
    main()
