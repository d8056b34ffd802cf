"""The README's quick start, ``sgdml-tpu all <dataset> 200 1000 5000``, run by
the JAX package on the CPU in f64 on the synthetic ethanol data of
``chip_smoke.py`` phase 7c: the reference that phase 9a holds the port's
``sgdml-tpu-torch all`` to on the GPU (``QUICKSTART_JAX`` there).

    JAX_PLATFORMS=cpu python tests/dev_quickstart_jax.py [--port]

Prints the sigmas trained before the grid stopped, the selected sigma and
the recorded test errors. ``--port`` runs the port's CLI on the CPU on the
same data as well, for comparison.
"""

import os
import sys
import tempfile

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from sgdml_tpu import cli  # noqa: E402
from sgdml_tpu.datasets.synthetic import generate_md_dataset  # noqa: E402
from sgdml_tpu.utils import io  # noqa: E402


def run(main, argv, tmp, tag):
    os.makedirs(os.path.join(tmp, tag))
    os.chdir(os.path.join(tmp, tag))
    np.random.seed(1)
    main(argv)
    task_dir = [d for d in os.listdir('.') if os.path.isdir(d)][0]
    sigs = sorted(int(f[-8:-4]) for f in os.listdir(task_dir) if f.startswith('model-'))
    final = [f for f in os.listdir('.') if f.endswith('.npz')][0]
    model = io.load_dict(final)
    err = {k: model[k].item() if isinstance(model[k], np.ndarray) else model[k] for k in ('f_err', 'e_err')}
    print('%s: trained sigmas %s; selected sig=%s (%s); test n=%d force MAE %r RMSE %r energy MAE %r' % (
        tag, sigs, np.squeeze(model['sig']), final, model['n_test'], err['f_err']['mae'], err['f_err']['rmse'],
        err['e_err']['mae']))


def main():
    with tempfile.TemporaryDirectory() as tmp:
        ds = generate_md_dataset(n_atoms=9, n_frames=12000, seed=0)
        path = os.path.join(tmp, 'ethanol.npz')
        io.save_dict(path, ds)
        print('mean |F| component %r' % float(np.abs(ds['F']).mean()))
        run(cli.main, ['all', path, '200', '1000', '5000'], tmp, 'jax')
        if '--port' in sys.argv:
            from sgdml_tpu_torch import cli as port_cli

            run(port_cli.main, ['--device', 'cpu', 'all', path, '200', '1000', '5000'], tmp, 'port')


if __name__ == '__main__':
    main()
