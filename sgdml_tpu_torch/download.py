"""Dataset/model downloader (``sgdml-tpu-torch-get``).

Parity with the reference's ``sgdml-get`` (sgdml/get.py): fuzzy name
resolution against the public benchmark catalog and HTTP download from
quantum-machine.org. Network access is attempted lazily and fails with a
clear message in offline environments.
"""

from __future__ import annotations

import argparse
import difflib
import os
import sys

BASE_URL = 'http://www.quantum-machine.org/gdml/data/npz/'
MODELS_URL = 'http://www.quantum-machine.org/gdml/models/'

# Catalog of the published sGDML benchmark datasets (MD17 / MD22 families).
DATASETS = {
    'ethanol': 'md17_ethanol.npz',
    'aspirin': 'md17_aspirin.npz',
    'benzene': 'md17_benzene2017.npz',
    'malonaldehyde': 'md17_malonaldehyde.npz',
    'naphthalene': 'md17_naphthalene.npz',
    'salicylic': 'md17_salicylic.npz',
    'toluene': 'md17_toluene.npz',
    'uracil': 'md17_uracil.npz',
    'paracetamol': 'paracetamol_dft.npz',
    'azobenzene': 'azobenzene_dft.npz',
    'ac_ala3_nhme': 'md22_Ac-Ala3-NHMe.npz',
    'dha': 'md22_DHA.npz',
    'stachyose': 'md22_stachyose.npz',
    'at_at': 'md22_AT-AT.npz',
    'at_at_cg_cg': 'md22_AT-AT-CG-CG.npz',
    'buckyball_catcher': 'md22_buckyball-catcher.npz',
    'dw_nanotube': 'md22_dw_nanotube.npz',
}


def resolve(name: str) -> str:
    key = name.lower().replace('-', '_')
    if key in DATASETS:
        return DATASETS[key]
    close = difflib.get_close_matches(key, DATASETS.keys(), n=3)
    if len(close) == 1:
        print("Assuming you meant '%s'." % close[0])
        return DATASETS[close[0]]
    if close:
        raise SystemExit(
            "Unknown dataset '%s'. Did you mean: %s?" % (name, ', '.join(close))
        )
    raise SystemExit(
        "Unknown dataset '%s'. Available: %s" % (name, ', '.join(sorted(DATASETS)))
    )


def download(filename: str, dest_dir: str = '.', base_url: str = BASE_URL) -> str:
    import urllib.request

    url = base_url + filename
    dest = os.path.join(dest_dir, filename)
    print('Downloading %s ...' % url)
    try:
        with urllib.request.urlopen(url, timeout=30) as resp, open(
            dest, 'wb'
        ) as out:
            total = int(resp.headers.get('Content-Length', 0))
            done = 0
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
                done += len(chunk)
                if total:
                    sys.stdout.write('\r%3d%%' % (100 * done // total))
                    sys.stdout.flush()
            print()
    except OSError as e:
        if os.path.exists(dest):
            os.remove(dest)
        raise SystemExit(
            'Download failed (%s). This environment may be offline; '
            'datasets can also be converted locally with the '
            'sgdml-tpu-torch-dataset-* tools.' % e
        )
    return dest


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Download public sGDML benchmark datasets and '
        'pre-trained models (reference parity: sgdml-get dataset|model).'
    )
    p.add_argument('command', choices=['dataset', 'model', 'list'])
    p.add_argument('name', nargs='?', default=None)
    p.add_argument('-d', '--dest', default='.')
    args = p.parse_args(argv)

    if args.command == 'list' or args.name is None:
        for key, fname in sorted(DATASETS.items()):
            print('%-20s %s' % (key, fname))
        return
    base = MODELS_URL if args.command == 'model' else BASE_URL
    dest = download(resolve(args.name), args.dest, base_url=base)
    print('Saved to %s' % dest)


if __name__ == '__main__':
    main()
