"""A dry run of the whole sharded training and serving path on tiny shapes.

The port's counterpart of ``__graft_entry__.dryrun_multichip``: over a
mesh of ``n_devices`` ranks of the current world (a world of one is made
here when none exists), it trains a small symmetric, energy-constrained
task analytically and by CG, serves the analytic model batch-sharded, and
holds the sharded forces against a single-device training of the same task.
Every rank of the mesh calls it.

    python -c "from sgdml_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(1)"
    torchrun --nproc-per-node 4 -m sgdml_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys

import numpy as np
import torch.distributed as dist

from ..datasets.synthetic import generate_md_dataset
from ..predict import GDMLPredict
from ..train import GDMLTrain
from .mesh import default_mesh, init_distributed, is_writer

__all__ = ['dryrun_multichip']

FORCE_TOL = 1e-6  # sharded against single-device forces, relative to max |F|


def dryrun_multichip(n_devices: int, device='cuda') -> float:
    """Train (analytic and CG) and serve on a mesh of ``n_devices`` ranks,
    ``m = 2 n_devices + 3`` points (never a multiple of the ranks), with
    symmetries and energy constraints. Returns the largest force difference
    from the single-device model over ``max |F|``; raises ``AssertionError``
    past :data:`FORCE_TOL` or on a non-finite result."""
    if not dist.is_initialized():
        init_distributed(world_size=1, rank=0, device=device)
    mesh = default_mesh(n_devices, device=device)
    n_atoms, m = 5, 2 * n_devices + 3
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=4 * m, seed=1)

    trainer = GDMLTrain(mesh=mesh, device=device)
    task = trainer.create_task(ds, m, ds, 8, sig=5.0, use_sym=True, use_E=True, use_E_cstr=True,
                               rng=np.random.RandomState(0))
    # Sharded assembly and the distributed blocked Cholesky.
    model = trainer.train(task, solver='analytic')
    # Nystrom-preconditioned CG: batch-sharded matvec, column-sharded factor.
    model_cg = trainer.train(task, solver='cg')
    Rq = ds['R'][m:3 * m + 1]
    E, F = GDMLPredict(model, mesh=mesh, device=trainer.device).predict(Rq.reshape(len(Rq), -1))
    for what, x in (('analytic alphas', model['alphas_F']), ('CG alphas', model_cg['alphas_F']), ('energies', E),
                    ('forces', F)):
        if not np.isfinite(x).all():
            raise AssertionError('dryrun_multichip: non-finite %s' % what)

    single = GDMLTrain(device=trainer.device)
    E1, F1 = GDMLPredict(single.train(task, solver='analytic'), device=trainer.device).predict(
        Rq.reshape(len(Rq), -1))
    df = float(np.abs(F - F1).max() / np.abs(F1).max())
    if not df < FORCE_TOL:
        raise AssertionError('sharded vs single-device force mismatch: %.3e' % df)
    if is_writer():
        print('dryrun_multichip OK on %d devices: analytic+cg trained, sharded-vs-single max rel force diff %.2e'
              % (n_devices, df))
    return df


if __name__ == '__main__':
    init_distributed(device=sys.argv[2] if len(sys.argv) > 2 else 'cuda')
    dryrun_multichip(int(sys.argv[1]), device=sys.argv[2] if len(sys.argv) > 2 else 'cuda')
