"""Extract the train/validation subsets referenced by a model file back
into standalone dataset npz files
(parity: reference scripts/sgdml_datasets_from_model.py)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import io


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Extract train/valid subsets used by a model.'
    )
    p.add_argument('model')
    p.add_argument('dataset')
    p.add_argument('-o', '--out_prefix', default=None)
    args = p.parse_args(argv)

    model = io.load_dict(args.model)
    dataset = io.load_dict(args.dataset)
    if not io.is_model(model):
        raise SystemExit('Not a model file.')
    if io.dataset_md5(dataset) != model.get('md5_train'):
        raise SystemExit(
            'Dataset fingerprint does not match the one the model was '
            'trained on.'
        )

    prefix = args.out_prefix or os.path.splitext(args.model)[0]
    for kind in ('train', 'valid'):
        idxs = np.asarray(model['idxs_%s' % kind])
        sub = {
            'type': 'd',
            'code_version': dataset.get('code_version', ''),
            'name': np.array('%s_%s' % (np.squeeze(dataset['name']), kind)),
            'theory': dataset['theory'],
            'z': dataset['z'],
            'R': dataset['R'][idxs],
            'F': dataset['F'][idxs],
        }
        if 'E' in dataset:
            sub['E'] = dataset['E'][idxs]
        if 'lattice' in dataset:
            sub['lattice'] = dataset['lattice']
        sub['md5'] = io.dataset_md5(sub)
        out = '%s_%s.npz' % (prefix, kind)
        io.save_dict(out, sub)
        print('Wrote %s (%d geometries).' % (out, len(idxs)))


if __name__ == '__main__':
    main()
