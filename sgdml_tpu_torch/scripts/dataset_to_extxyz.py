"""Export a dataset npz to an extended-xyz trajectory file
(parity: reference scripts/sgdml_dataset_to_extxyz.py)."""

from __future__ import annotations

import argparse
import os


from ..utils import io


def main(argv=None):
    p = argparse.ArgumentParser(description='Export dataset to extended xyz.')
    p.add_argument('dataset')
    p.add_argument('-o', '--out', default=None)
    args = p.parse_args(argv)

    ds = io.load_dict(args.dataset)
    if not io.is_dataset(ds):
        raise SystemExit('Not a dataset file.')

    out = args.out or os.path.splitext(args.dataset)[0] + '.xyz'
    n = ds['R'].shape[0]
    lattice = ds.get('lattice')
    with open(out, 'w') as fh:
        for i in range(n):
            frame = io.generate_xyz_str(
                ds['R'][i],
                ds['z'],
                e=ds['E'][i] if 'E' in ds else None,
                f=ds['F'][i],
                lattice=lattice,
            )
            fh.write(frame + '\n')
    print('Wrote %d frames to %s.' % (n, out))


if __name__ == '__main__':
    main()
