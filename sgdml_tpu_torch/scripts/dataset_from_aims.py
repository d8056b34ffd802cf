"""Create a dataset npz from FHI-aims MD output
(parity: reference scripts/sgdml_dataset_from_aims.py; eV -> kcal/mol
conversion as in the reference, :37)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import io

EV_TO_KCAL_MOL = 23.06054783061903


def read_aims_output(path: str):
    """Parse geometries, total energies and forces from an FHI-aims
    standard-output file."""
    R, E, F = [], [], []
    z = None
    with open(path) as fh:
        lines = fh.read().splitlines()

    i = 0
    cur_r, cur_z, cur_f, cur_e = [], [], [], None
    while i < len(lines):
        line = lines[i]
        if 'atom ' in line and ('Atomic structure' in lines[max(0, i - 2)] or
                                line.strip().startswith('atom ')):
            cols = line.split()
            if len(cols) >= 5 and cols[0] == 'atom':
                cur_r.append([float(c) for c in cols[1:4]])
                cur_z.append(io.SYMBOL_TO_Z.get(cols[4], 0))
        elif 'Total energy corrected' in line:
            cur_e = float(line.split()[5])
        elif 'Total atomic forces' in line:
            cur_f = []
            j = i + 1
            while j < len(lines) and '|' in lines[j]:
                cols = lines[j].replace('|', ' ').split()
                if len(cols) >= 4:
                    cur_f.append([float(c) for c in cols[-3:]])
                j += 1
            if cur_r and cur_f and cur_e is not None:
                if z is None:
                    z = np.array(cur_z)
                R.append(cur_r)
                F.append(cur_f)
                E.append(cur_e)
                cur_r, cur_z, cur_f, cur_e = [], [], [], None
            i = j - 1
        i += 1

    if not R:
        raise ValueError('No complete geometry/energy/force frames found.')
    return z, np.array(R), np.array(E), np.array(F)


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Create an sGDML dataset from FHI-aims output.'
    )
    p.add_argument('aims_out')
    p.add_argument('-o', '--out', default=None)
    p.add_argument('--name', default=None)
    args = p.parse_args(argv)

    z, R, E, F = read_aims_output(args.aims_out)
    name = args.name or os.path.splitext(os.path.basename(args.aims_out))[0]
    ds = {
        'type': 'd',
        'code_version': '0.1.0',
        'name': np.array(name),
        'theory': np.array('FHI-aims'),
        'z': z,
        'R': R,
        'E': E * EV_TO_KCAL_MOL,
        'F': F * EV_TO_KCAL_MOL,
        'r_unit': np.array('Ang'),
        'e_unit': np.array('kcal/mol'),
    }
    ds['md5'] = io.dataset_md5(ds)
    out = args.out or name + '.npz'
    io.save_dict(out, ds)
    print('Saved %s: %d frames.' % (out, R.shape[0]))


if __name__ == '__main__':
    main()
