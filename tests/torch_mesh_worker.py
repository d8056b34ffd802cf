"""Rank functions for the port's mesh tests: gloo worlds on the CPU.

A test starts a world with :func:`run_world`, which spawns one process a
rank (``torch.multiprocessing``, spawn), joins them under a deadline and
kills them when it passes. Each rank sets up its world from a file store in
the test's temporary directory (no TCP port to collide with other test
workers), runs one scenario of this module with a single thread, and writes
what it computed to ``<scenario>-<rank>.npz`` there; the test then holds
those arrays against the JAX package. This module imports only ``torch``,
numpy and ``sgdml_tpu_torch``: a rank never imports JAX.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

WORLD_TIMEOUT_S = 60  # every collective of a test world
JOIN_DEADLINE_S = 150  # a whole test world


def run_world(scenario: str, world: int, tmp_path, deadline: float = JOIN_DEADLINE_S, **kwargs):
    """Run ``scenario`` on a gloo world of ``world`` ranks; returns each
    rank's arrays, in rank order. Raises when a rank fails, and kills the
    ranks when ``deadline`` seconds pass."""
    import torch.multiprocessing as mp

    tmp_path = str(tmp_path)
    store = os.path.join(tmp_path, 'store-%s' % scenario)
    ctx = mp.start_processes(_rank_main, args=(world, store, scenario, tmp_path, kwargs), nprocs=world,
                             join=False, start_method='spawn')
    t_end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                raise TimeoutError('%s: the %d-rank world did not finish in %.0f s' % (scenario, world, deadline))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(os.path.join(tmp_path, '%s-%d.npz' % (scenario, r)), allow_pickle=True))
            for r in range(world)]


def _rank_main(rank, world, store, scenario, out_dir, kwargs):
    torch.set_num_threads(1)
    from sgdml_tpu_torch.parallel.mesh import init_distributed

    init_distributed(init_method='file://' + store, world_size=world, rank=rank, device='cpu',
                     timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        out = globals()['scenario_' + scenario](out_dir=out_dir, **kwargs)
        np.savez(os.path.join(out_dir, '%s-%d.npz' % (scenario, rank)), **out)
    finally:
        torch.distributed.destroy_process_group()


def _gather_strip(K_loc, mesh):
    from sgdml_tpu_torch.parallel.mesh import all_gather_rows, mesh_info

    return all_gather_rows(K_loc, mesh_info(mesh)).numpy()


# -- tests/test_torch_linalg.py ----------------------------------------------


def scenario_linalg(out_dir, n, nb):
    """The blocked factor and solves on row strips (a 1-D mesh of all ranks)
    and the solve on a 2 x 2 mesh."""
    from sgdml_tpu_torch.ops import linalg
    from sgdml_tpu_torch.parallel.mesh import default_mesh, mesh_2d, mesh_info

    inp = np.load(os.path.join(out_dir, 'linalg_inputs.npz'))
    A, b, A2, b2 = (torch.as_tensor(inp[k]) for k in ('A', 'b', 'A2', 'b2'))
    mesh = default_mesh(device='cpu')
    info = mesh_info(mesh)
    rloc = n // info.size
    rows = slice(info.rank * rloc, (info.rank + 1) * rloc)
    L_loc = linalg.blocked_cholesky(A[rows].clone(), nb, mesh=mesh)
    out = {'L': _gather_strip(L_loc, mesh)}
    out['y'] = linalg.blocked_tri_solve(L_loc, b, nb, mesh=mesh).numpy()
    out['z'] = linalg.blocked_tri_solve(L_loc, b, nb, trans=True, mesh=mesh).numpy()
    out['x'] = linalg.cho_solve_blocked(A[rows].clone(), b, nb=nb, mesh=mesh).numpy()
    m2 = mesh_2d(2, info.size // 2, device='cpu')
    r2 = A2.shape[0] // info.size
    out['x2'] = linalg.cho_solve_blocked(A2[info.rank * r2:(info.rank + 1) * r2].clone(), b2, nb=16,
                                         mesh=m2).numpy()
    return out


# -- tests/test_torch_parallel.py --------------------------------------------


def scenario_parallel(out_dir):
    """Assembly, the interleaved solve, serving and the Nystrom factor of
    ``parallel/spmd.py`` over a 1-D mesh of all ranks, then the CG solver's
    factor plan and column shards on the mesh. The assembly runs at a tile
    budget of 120 kB, 3 x 4 points at N=5, so that each rank's strip takes
    several row and column tiles, the last ones short."""
    from sgdml_tpu_torch.ops import kernel as ker
    from sgdml_tpu_torch.parallel import spmd
    from sgdml_tpu_torch.parallel.mesh import all_gather_rows, default_mesh, mesh_info
    from sgdml_tpu_torch.predict import GDMLPredict, build_tables, center_tables
    from sgdml_tpu_torch.solvers.iterative import Iterative
    from sgdml_tpu_torch.utils import io

    inp = {k: v for k, v in np.load(os.path.join(out_dir, 'parallel_inputs.npz')).items()}
    X, Jc = torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc'])
    dperms, n_atoms, sig, lam = inp['dperms'], 5, 5.0, 1e-10
    mesh = default_mesh(device='cpu')
    info = mesh_info(mesh)
    ker.TILE_BUDGET_BYTES = 120_000
    out = {'tiles': np.asarray(ker.default_tile_sizes(X.shape[0], n_atoms, len(dperms)))}
    for e in (False, True):
        K_loc, lay = spmd.assemble_kernel_sharded(X, Jc, dperms, sig, n_atoms, mesh, use_E_cstr=e)
        out['K_%d' % e] = _gather_strip(K_loc, mesh)
    K_loc, lay = spmd.assemble_kernel_sharded(X, Jc, dperms, sig, n_atoms, mesh)
    out['alphas'] = spmd.solve_interleaved(K_loc, inp['y'], lam, lay, mesh).numpy()

    tables = center_tables(*build_tables(X, torch.as_tensor(inp['JA']), dperms))
    E, F = spmd.predict_sharded(X, Jc, tables, sig, 1.3, -2.0, n_atoms, mesh,
                                alphas_E_lin=torch.as_tensor(inp['aE']))
    out['E'], out['F'] = E.numpy(), F.numpy()
    E, F = spmd.predict_sharded(X, Jc, tables, sig, 1.3, -2.0, n_atoms, mesh,
                                alphas_E_lin=torch.as_tensor(inp['aE']), batch_size=4)
    out['E_chunked'], out['F_chunked'] = E.numpy(), F.numpy()
    model = io.load_dict(os.path.join(out_dir, 'lattice_model.npz'))
    out['E_lat'], out['F_lat'] = GDMLPredict(model, mesh=mesh, device='cpu').predict(inp['Rq_lat'])

    cols = inp['cols']
    C_loc = spmd.assemble_kernel_columns_sharded(X, Jc, dperms, sig, n_atoms, cols, mesh)
    out['C'] = _gather_strip(C_loc, mesh)
    F_loc, lev, ok = spmd.nystrom_factor_sharded(C_loc.neg(), cols, lam, 0.0, 0.0, mesh)
    out['ok'] = np.asarray(ok)
    out['Fny'] = all_gather_rows(F_loc.T.contiguous(), info).T.numpy()
    out['lev'] = lev.numpy()

    solver = Iterative(mesh=mesh, max_memory=15.5, device='cpu')
    out['plan'] = np.asarray([solver._factor_plan(3000, 60, use_E_cstr=e) for e in (False, True)])
    F_whole = torch.as_tensor(inp['F_whole'])
    out['F_shard_cols'] = np.asarray(solver._shard_factor(F_whole).F.shape[1])
    out['F_shards'] = all_gather_rows(solver._shard_factor(F_whole).F.T.contiguous(), info).T.numpy()
    return out


# -- tests/test_torch_mesh_train.py ------------------------------------------


def scenario_train(out_dir):
    """``GDMLTrain(mesh=)`` analytic and CG, ``GDMLPredict(mesh=)`` of the
    mesh model and of the JAX package's mesh model, then ``cli all
    --devices N`` in the same world."""
    from sgdml_tpu_torch import cli
    from sgdml_tpu_torch.parallel.mesh import default_mesh, is_writer
    from sgdml_tpu_torch.predict import GDMLPredict
    from sgdml_tpu_torch.train import GDMLTrain
    from sgdml_tpu_torch.utils import io

    task = io.load_dict(os.path.join(out_dir, 'task.npz'))
    Rq = np.load(os.path.join(out_dir, 'train_inputs.npz'))['Rq']
    mesh = default_mesh(device='cpu')
    trainer = GDMLTrain(mesh=mesh, device='cpu')
    out = {}
    for solver in ('analytic', 'cg'):
        model = trainer.train(task, solver=solver)
        out['E_' + solver], out['F_' + solver] = GDMLPredict(model, mesh=mesh, device='cpu').predict(Rq)
        out['alphas_F_' + solver] = model['alphas_F']
        if solver == 'analytic' and is_writer():
            io.save_dict(os.path.join(out_dir, 'mesh_model.npz'), model)
    jax_model = io.load_dict(os.path.join(out_dir, 'jax_mesh_model.npz'))
    out['E_jax'], out['F_jax'] = GDMLPredict(jax_model, mesh=mesh, device='cpu').predict(Rq)

    cwd = os.getcwd()
    os.makedirs(os.path.join(out_dir, 'cli_mesh'), exist_ok=True)
    os.chdir(os.path.join(out_dir, 'cli_mesh'))
    np.random.seed(1)  # the task's split comes from numpy's global generator
    try:
        cli.main(['--device', 'cpu', 'all', os.path.join(out_dir, 'cli_ds.npz'), '20', '10', '-s', '5,10',
                  '--task_dir', 't', '--model_file', 'm.npz', '--devices', '2'])
    finally:
        os.chdir(cwd)
    torch.distributed.barrier()
    out['cli_files'] = np.asarray(sorted(os.listdir(os.path.join(out_dir, 'cli_mesh', 't'))))
    return out


def scenario_dryrun(out_dir):
    from sgdml_tpu_torch.parallel.dryrun import dryrun_multichip

    return {'df': np.asarray(dryrun_multichip(torch.distributed.get_world_size(), device='cpu'))}
