"""Large-system benchmarks, the counterpart of the repository's ``bench_large.py``.

Run one mode on the GPU (the default), or on the CPU only when asked:

    python3 -m sgdml_tpu_torch.bench_large <mode> [--device cpu]

Modes, each on its recipe of synthetic data and printing one JSON line:

* ``aspirin``: aspirin-sized (N=21) M=1000 training by Nystrom-pCG (lam
  1e-8, 1200 s budget) + held-out force MAE.
* ``aspirin_analytic``: the same size by the analytic solver (lam 1e-10);
  ``config`` names the route ``Analytic.solve`` took at the card's budget.
* ``atat``: AT-AT-sized (N=60) M=600 by CG (``SGDML_BENCH_MAXS``, default
  1200 s).
* ``atat3000``: N=60, M=3000 by CG (``SGDML_BENCH_M``, ``SGDML_BENCH_MAXS``,
  default 1800 s; ``SGDML_BENCH_CKPT`` checkpoints and resumes).
* ``atat3000_mesh``: the same task on the launched mesh (a world of one in
  this process without ``torchrun``), the Nystrom factor column-sharded at
  ``SGDML_BENCH_PERDEV`` GB a device (default 12; ``SGDML_BENCH_MAXS``
  default 14400 s).
* ``ozaki_mesh``: the mesh's int8 slice-stack route end to end
  (``SGDML_BENCH_N_ATOMS`` default 24, ``SGDML_BENCH_M`` 300,
  ``SGDML_BENCH_PERDEV`` 2.0, ``SGDML_BENCH_MAXS`` 7200).
* ``sym``: symmetry discovery + sGDML-vs-GDML force MAE.
* ``md``: NVE molecular dynamics steps/s + energy drift.

Every line also carries ``device`` (the card's ``nvidia-smi`` name and
power limit, or ``'cpu'``) and ``k1_launches`` (the fused kernel's launches
during the mode). On a mesh only rank 0 prints; the mesh modes say how many
ranks they ran on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import timeit

import numpy as np
import torch
import torch.distributed as dist

from . import perm as perm_mod
from . import resolve_device
from .bench import device_line, warm_device
from .datasets.synthetic import generate_md_dataset, generate_symmetric_md_dataset
from .md import MDEngine
from .ops import descriptor as desc_ops
from .ops import fused_predict
from .parallel import mesh as mesh_mod
from .predict import GDMLPredict, desc_perm_table
from .solvers.analytic import Analytic
from .solvers.iterative import Iterative
from .train import GDMLTrain

log = logging.getLogger(__name__)


def _save_cb(ckpt):
    """A checkpoint writer for ``train()``'s CG (atomic rename), or None."""
    if not ckpt:
        return None

    def save(model):
        tmp = ckpt + '.tmp.npz'
        np.savez_compressed(tmp, **model)
        os.replace(tmp, ckpt)

    return save


def _train(ds, m_train, sig, solver, lam=1e-10, use_sym=False, max_seconds=None, ckpt=None, device='cuda',
           trainer=None):
    """Train on the recipe's split (seed 1; 200 validation frames), by
    default at the device's own memory budget (``trainer``: a ``GDMLTrain``
    with a budget or a mesh); returns ``(task, model, train() seconds)``.
    Where the checkpoint ``ckpt`` exists, the task is rebuilt from its
    unconverged model and its CG resumes; only the writer checkpoints."""
    trainer = trainer or GDMLTrain(device=resolve_device(device))
    np.random.seed(1)
    if ckpt and os.path.isfile(ckpt):
        model0 = dict(np.load(ckpt, allow_pickle=True))
        log.info('Warm-starting from %s (%s CG iterations so far).', ckpt, model0.get('solver_iters', '?'))
        task = trainer.create_task_from_model(model0, ds)
    else:
        task = trainer.create_task(ds, m_train, ds, 200, sig=sig, lam=lam, use_sym=use_sym, use_E=True)
    save_cb = _save_cb(ckpt) if _is_writer() else None
    warm_device(trainer.device)
    t0 = timeit.default_timer()
    model = trainer.train(task, solver=solver, solver_max_seconds=max_seconds, save_progr_callback=save_cb)
    t_train = timeit.default_timer() - t0
    if save_cb is not None:
        save_cb(model)  # the final state, converged or ended by the budget
    return task, model, t_train


def _force_mae(ds, task, model, n_test=500, device='cuda'):
    """(force MAE, mean |F|) on the first ``n_test`` frames outside the
    training split."""
    ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:n_test]
    pred = GDMLPredict(model, batch_size=min(len(ti), 512), device=device)
    _, F = pred.predict(ds['R'][ti].reshape(len(ti), -1))
    f_ref = ds['F'][ti].reshape(len(ti), -1)
    return float(np.abs(F - f_ref).mean()), float(np.abs(f_ref).mean())


def _converged(model) -> bool:
    return bool(model['solver_resid'] <= model['solver_tol'] * model['norm_y_train'])


@contextlib.contextmanager
def _analytic_solvers():
    """Yields the list of ``Analytic`` instances that solve inside the
    block (``Analytic.solve`` wrapped), whose ``route`` names the route
    taken; ``train()`` keeps its solver to itself."""
    made = []
    solve = Analytic.solve

    def watched(self, *args, **kw):
        made.append(self)
        return solve(self, *args, **kw)

    Analytic.solve = watched
    try:
        yield made
    finally:
        Analytic.solve = solve


@contextlib.contextmanager
def _mesh_world(device):
    """A 1-D mesh over the world: the one that exists, else ``torchrun``'s,
    else a world of this process alone; a world made here is destroyed at
    the end."""
    made = not dist.is_initialized()
    if made and not mesh_mod.init_distributed(device=device):
        mesh_mod.init_distributed(world_size=1, rank=0, device=device)
    try:
        yield mesh_mod.default_mesh(device=device)
    finally:
        if made:
            dist.destroy_process_group()


def _is_writer() -> bool:
    """Rank 0 of the world, or of ``torchrun``'s world after a mode has
    destroyed the one it made, or a process outside any."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get('RANK', 0)) == 0


def _ranks(n):
    return 'one rank' if n == 1 else '%d ranks' % n


def _cg_chunks(device, mesh=False):
    """How a mode's CG chunks run, for its ``config``: replayed from CUDA
    graphs on one card; the eager loop on a mesh and on the CPU."""
    if mesh:
        return 'eager CG chunks on the mesh'
    return 'CG chunks replayed from CUDA graphs' if torch.device(device).type == 'cuda' else 'eager CG chunks'


def _cg_line(config, t_train, model, mae, scale, **extra):
    return dict({'config': config, 'train_s': t_train, 'cg_iters': int(model.get('solver_iters', -1))}, **extra,
                converged=_converged(model), force_mae=mae, force_scale=scale)


def bench_aspirin(device):
    ds = generate_md_dataset(n_atoms=21, n_frames=2200, seed=10)
    task, model, t_train = _train(ds, 1000, sig=15.0, solver='cg', lam=1e-8, max_seconds=1200, device=device)
    mae, scale = _force_mae(ds, task, model, device=device)
    return _cg_line('aspirin-sized N=21 M=1000 iterative (Nystrom-pCG, %s)' % _cg_chunks(device), t_train, model, mae,
                    scale)


def bench_atat(device):
    """AT-AT width at M=600 by CG; ``SGDML_BENCH_MAXS`` (the CG's
    wall-clock budget, default 1200 s)."""
    max_seconds = float(os.environ.get('SGDML_BENCH_MAXS', 1200))
    ds = generate_md_dataset(n_atoms=60, n_frames=1400, seed=11)
    task, model, t_train = _train(ds, 600, sig=25.0, solver='cg', max_seconds=max_seconds, device=device)
    mae, scale = _force_mae(ds, task, model, n_test=300, device=device)
    return _cg_line('AT-AT-sized N=60 M=600 iterative (Nystrom-pCG, %s)' % _cg_chunks(device), t_train, model, mae,
                    scale, max_seconds=max_seconds)


def bench_atat3000(device):
    """MD22 AT-AT scale: N=60, M=3000 by CG end to end.
    ``SGDML_BENCH_M`` (default 3000), ``SGDML_BENCH_MAXS`` (the CG's
    wall-clock budget, default 1800 s), ``SGDML_BENCH_CKPT`` (a checkpoint
    path: the unconverged model is saved there and resumed from)."""
    m_train = int(os.environ.get('SGDML_BENCH_M', 3000))
    max_seconds = float(os.environ.get('SGDML_BENCH_MAXS', 1800))
    ckpt = os.environ.get('SGDML_BENCH_CKPT') or None
    ds = generate_md_dataset(n_atoms=60, n_frames=m_train + 600, seed=11)
    task, model, t_train = _train(ds, m_train, sig=25.0, solver='cg', max_seconds=max_seconds, ckpt=ckpt,
                                  device=device)
    mae, scale = _force_mae(ds, task, model, n_test=300, device=device)
    return _cg_line('MD22 AT-AT-sized N=60 M=%d iterative (Nystrom-pCG, %s)' % (m_train, _cg_chunks(device)), t_train,
                    model, mae, scale, max_seconds=max_seconds)


def bench_aspirin_analytic(device):
    """Aspirin-sized M=1000 by the analytic solver at the device's budget
    (63,000 unknowns, past the dense bound of an 80 GB card)."""
    ds = generate_md_dataset(n_atoms=21, n_frames=1600, seed=10)
    with _analytic_solvers() as solvers:
        task, model, t_train = _train(ds, 1000, sig=20.0, solver='analytic', device=device)
    mae, scale = _force_mae(ds, task, model, device=device)
    return {
        'config': 'aspirin-sized N=21 M=1000 analytic (%s route%s)' % (
            solvers[-1].route,
            ', refinement %s' % _cg_chunks(device) if solvers[-1].route in ('grid', 'pair') else ''),
        'train_s': t_train,
        'force_mae': mae,
        'force_scale': scale,
    }


def bench_atat3000_mesh(device):
    """MD22 AT-AT scale by CG on the mesh: the Nystrom factor is
    column-sharded, so its inducing-point budget grows with the ranks.
    ``SGDML_BENCH_M`` (default 3000), ``SGDML_BENCH_MAXS`` (default 14400
    s), ``SGDML_BENCH_PERDEV`` (GB a device, default 12),
    ``SGDML_BENCH_CKPT``."""
    m_train = int(os.environ.get('SGDML_BENCH_M', 3000))
    max_seconds = float(os.environ.get('SGDML_BENCH_MAXS', 14400))
    per_dev_gb = float(os.environ.get('SGDML_BENCH_PERDEV', 12.0))
    ckpt = os.environ.get('SGDML_BENCH_CKPT') or None
    ds = generate_md_dataset(n_atoms=60, n_frames=m_train + 600, seed=11)
    with _mesh_world(device) as mesh:
        n_dev = mesh_mod.mesh_info(mesh).size
        k1 = Iterative.max_n_inducing_pts(m_train, 60, per_dev_gb * 1024**3, 1)
        k_mesh = Iterative.max_n_inducing_pts(m_train, 60, per_dev_gb * 1024**3, n_dev)
        trainer = GDMLTrain(max_memory=per_dev_gb, mesh=mesh, device=device)
        task, model, t_train = _train(ds, m_train, sig=25.0, solver='cg', max_seconds=max_seconds, ckpt=ckpt,
                                      trainer=trainer)
        mae, scale = _force_mae(ds, task, model, n_test=300, device=trainer.device)
    return _cg_line('MD22 AT-AT-sized N=60 M=%d iterative, mesh of %s (sharded Nystrom factor, %s)'
                    % (m_train, _ranks(n_dev), _cg_chunks(device, mesh=True)), t_train, model, mae, scale,
                    k_inducing_pts=int(len(model['inducing_pts_idxs']) // 180), k_cap_single_device=int(k1),
                    k_cap_mesh=int(k_mesh), n_ranks=n_dev, max_seconds=max_seconds)


def bench_mesh_ozaki(device):
    """The mesh's int8 route end to end: the column-sharded streamed
    slice-stack factor preconditions CG (``Iterative(factor_mode='ozaki')``
    on the mesh). ``SGDML_BENCH_N_ATOMS`` (default 24), ``SGDML_BENCH_M``
    (300), ``SGDML_BENCH_PERDEV`` (GB a device, 2.0), ``SGDML_BENCH_MAXS``
    (7200 s)."""
    n_atoms = int(os.environ.get('SGDML_BENCH_N_ATOMS', 24))
    m_train = int(os.environ.get('SGDML_BENCH_M', 300))
    per_dev_gb = float(os.environ.get('SGDML_BENCH_PERDEV', 2.0))
    max_seconds = float(os.environ.get('SGDML_BENCH_MAXS', 7200))
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=m_train + 400, seed=21)
    with _mesh_world(device) as mesh:
        n_dev = mesh_mod.mesh_info(mesh).size
        trainer = GDMLTrain(max_memory=per_dev_gb, mesh=mesh, device=device)
        np.random.seed(1)
        task = trainer.create_task(ds, m_train, ds, 100, sig=12.0, lam=1e-10, use_sym=False, use_E=True)
        dev = trainer.device
        R = torch.as_tensor(task['R_train'].reshape(m_train, -1), dtype=torch.float64, device=dev)
        X, Jc = desc_ops.descriptor_batch(R, n_atoms)
        y = task['F_train'].ravel()
        y_std = float(np.std(y))
        solver = Iterative(trainer, max_memory=per_dev_gb, mesh=mesh, factor_mode='ozaki')
        warm_device(dev)
        t0 = timeit.default_timer()
        alphas, tol, iters, resid, _, idxs, is_conv = solver.solve(
            task, X, Jc, desc_perm_table(task['perms']), y / y_std, y_std, max_seconds=max_seconds)
        t_train = timeit.default_timer() - t0
        model = trainer.create_model(task, 'cg', X, Jc, y_std, alphas)
        model.update(solver_tol=tol, solver_resid=resid, norm_y_train=float(np.linalg.norm(y / y_std)),
                     solver_iters=iters, inducing_pts_idxs=np.asarray(idxs))
        pred = GDMLPredict(model, device=dev)
        pred.set_R_desc(X)
        pred.set_R_d_desc(Jc)
        E_pred, _ = pred.predict()
        model['c'] = float(np.mean(np.squeeze(task['E_train']) - E_pred))
        mae, scale = _force_mae(ds, task, model, n_test=200, device=dev)
    return {
        'config': 'mesh-ozaki end-to-end N=%d M=%d, mesh of %s (column-sharded int8 slice-stack factor + '
                  'int8 CG matvec, %s)' % (n_atoms, m_train, _ranks(n_dev), _cg_chunks(device, mesh=True)),
        'train_s': t_train,
        'cg_iters': int(iters),
        'k_inducing_pts': int(len(idxs) // (3 * n_atoms)),
        'n_slices': int(solver._ns()),
        'n_ranks': n_dev,
        'converged': bool(is_conv),
        'force_mae': mae,
        'force_scale': scale,
    }


def bench_sym(device, n_frames=600, m_train=100, n_test=300):
    ds = generate_symmetric_md_dataset(n_frames=n_frames, seed=0)
    t0 = timeit.default_timer()
    perms = perm_mod.find_perms(ds['R'][:100], ds['z'])
    t_perm = timeit.default_timer() - t0
    maes = {}
    for use_sym in (False, True):
        task, model, _ = _train(ds, m_train, sig=6.0, solver='analytic', use_sym=use_sym, device=device)
        maes[use_sym], scale = _force_mae(ds, task, model, n_test=n_test, device=device)
    return {
        'config': 'symmetry discovery + sGDML vs GDML (synthetic CH3-CH3)',
        'n_perms_found': int(perms.shape[0]),
        'discovery_s': t_perm,
        'force_mae_gdml': maes[False],
        'force_mae_sgdml': maes[True],
        'force_scale': scale,
    }


def bench_md(device, n_frames=600, m_train=200, n_steps=2000):
    ds = generate_md_dataset(n_atoms=9, n_frames=n_frames, seed=0)
    _, model, _ = _train(ds, m_train, sig=10.0, solver='analytic', device=device)
    engine = MDEngine(model, device=device)
    r0 = ds['R'][0]
    v0 = np.zeros_like(r0)
    engine.run_nve(r0, v0, dt=0.01, n_steps=100, snapshot_every=100)  # warm
    t0 = timeit.default_timer()
    _, _, E_pot, E_kin = engine.run_nve(r0, v0, dt=0.01, n_steps=n_steps, snapshot_every=100)
    dt = timeit.default_timer() - t0  # numpy snapshots: the loop has ended on the device
    E_tot = E_pot + E_kin
    return {
        'config': 'NVE MD on the device, %s (N=9, trained model)' % (
            'each block of 100 steps a replayed CUDA graph' if engine._graphs else 'a host loop of device steps'),
        'md_steps_per_sec': n_steps / dt,
        'energy_drift': float(np.abs(E_tot - E_tot[0]).max()),
        'kinetic_scale': float(np.abs(E_kin).max()),
    }


MODES = {
    'aspirin': bench_aspirin,
    'aspirin_analytic': bench_aspirin_analytic,
    'atat': bench_atat,
    'atat3000': bench_atat3000,
    'atat3000_mesh': bench_atat3000_mesh,
    'ozaki_mesh': bench_mesh_ozaki,
    'sym': bench_sym,
    'md': bench_md,
}


def run_mode(mode, device='cuda', **sizes):
    """Run one mode and return its result, with ``device`` and
    ``k1_launches``; rank 0 (or a process outside a world) prints it."""
    device = resolve_device(device)
    line = device_line(device)
    launches0 = fused_predict.LAUNCHES
    out = MODES[mode](device, **sizes)
    out.update(device=line, k1_launches=fused_predict.LAUNCHES - launches0)
    if _is_writer():
        print(json.dumps(out))
        sys.stdout.flush()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m sgdml_tpu_torch.bench_large',
                                 description=__doc__.split('\n\n')[0])
    ap.add_argument('mode', nargs='?', default='sym', choices=sorted(MODES))
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    return run_mode(args.mode, args.device)


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='[%(levelname)s] %(message)s')
    main()
