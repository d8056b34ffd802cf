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

import contextlib
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


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of this process alone (its store in the process), for the
    duration of the block; yields its one-rank CPU mesh."""
    from sgdml_tpu_torch.parallel.mesh import default_mesh, init_distributed

    assert not torch.distributed.is_initialized()
    init_distributed(world_size=1, rank=0, device='cpu', timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        yield default_mesh(1, device='cpu')
    finally:
        torch.distributed.destroy_process_group()


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


# -- tests/test_torch_meshchol.py --------------------------------------------


def scenario_meshchol(out_dir):
    """The pair Cholesky and its solves on row strips (a 1-D mesh of all
    ranks), the interleaved solve with ``precision='pair'`` at two block
    sizes (``spmd.NB`` at 1024, whose largest divisor of the 360 rows is
    360, and at 45), and ``Analytic(mesh_precision='pair')`` with and
    without energy constraints."""
    from sgdml_tpu_torch.ops import meshchol
    from sgdml_tpu_torch.ops.pairchol import pair_split, pair_to_f64
    from sgdml_tpu_torch.parallel import spmd
    from sgdml_tpu_torch.parallel.mesh import default_mesh, mesh_info
    from sgdml_tpu_torch.solvers.analytic import Analytic

    inp = np.load(os.path.join(out_dir, 'meshchol_inputs.npz'))
    mesh = default_mesh(device='cpu')
    info = mesh_info(mesh)
    out = {}
    for i in range(int(inp['n_cases'])):
        A, nb, B = inp['A%d' % i], int(inp['nb%d' % i]), torch.as_tensor(inp['B%d' % i])
        rloc = A.shape[0] // info.size
        hi, lo = pair_split(torch.as_tensor(A[info.rank * rloc:(info.rank + 1) * rloc]))
        Lh, Ll, bad = meshchol.blocked_cholesky_pair(hi, lo, nb, mesh=mesh)
        out['info%d' % i] = np.asarray(bad)
        out['L%d' % i] = _gather_strip(pair_to_f64(Lh, Ll), mesh)
        out['x%d' % i] = meshchol.cho_solve_pair(Lh, Ll, B[:, 0], nb, mesh=mesh).numpy()
        out['Y%d' % i] = meshchol.tri_solve_pair(Lh, Ll, B, nb, mesh=mesh).numpy()
        out['Z%d' % i] = meshchol.tri_solve_pair(Lh, Ll, B, nb, trans=True, mesh=mesh).numpy()

    X, Jc = torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc'])
    dperms, n_atoms, sig, lam = inp['dperms'], 5, 5.0, 1e-10
    for nb in (spmd.NB, 45):
        spmd.NB = nb
        K_loc, lay = spmd.assemble_kernel_sharded(X, Jc, dperms, sig, n_atoms, mesh)
        stats = {}
        key = 'pair_%s' % nb
        out[key] = spmd.solve_interleaved(K_loc, inp['y'], lam, lay, mesh, precision='pair', stats=stats).numpy()
        out[key + '_rung'] = np.asarray(stats['lam_p'] / stats['lmax'])
        out[key + '_lmax'] = np.asarray(stats['lmax'])
        out[key + '_fallback'] = np.asarray(stats['fallback'])
    for e in (False, True):
        y = inp['y_E'] if e else inp['y']
        solver = Analytic(mesh=mesh, mesh_precision='pair')
        out['analytic_%d' % e] = solver.solve({'sig': sig, 'lam': 1e-8, 'use_E_cstr': e}, X, Jc, dperms, y).numpy()
        out['analytic_%d_rungs' % e] = np.asarray(solver.timer.counts['rungs'])
        out['analytic_%d_iters' % e] = np.asarray(solver.pcg_iters)
    return out


# -- tests/test_torch_cyclic.py ----------------------------------------------


def scenario_cyclic(out_dir):
    """The block-cyclic factor and solve on contiguous row strips (a 1-D mesh
    of all ranks), and the interleaved solve with ``layout='cyclic'``
    against the masked one, at ``spmd.NB`` and at 30 (12 blocks)."""
    from sgdml_tpu_torch.ops import cyclic
    from sgdml_tpu_torch.parallel import spmd
    from sgdml_tpu_torch.parallel.mesh import default_mesh, mesh_info

    inp = np.load(os.path.join(out_dir, 'cyclic_inputs.npz'))
    mesh = default_mesh(device='cpu')
    info = mesh_info(mesh)
    out = {}
    for i in range(int(inp['n_cases'])):
        A, nb = inp['A%d' % i], int(inp['nb%d' % i])
        rloc = A.shape[0] // info.size
        L_loc = cyclic.blocked_cholesky_cyclic(torch.as_tensor(A[info.rank * rloc:(info.rank + 1) * rloc]), nb,
                                               mesh=mesh)
        out['L%d' % i] = _gather_strip(L_loc, mesh)
    A, b = inp['A_pad'], torch.as_tensor(inp['b_pad'])
    rloc = A.shape[0] // info.size
    out['x_pad'] = cyclic.cho_solve_cyclic(torch.as_tensor(A[info.rank * rloc:(info.rank + 1) * rloc]), b, 8,
                                           mesh=mesh).numpy()
    X, Jc = torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc'])
    for layout in ('masked', 'cyclic'):
        K_loc, lay = spmd.assemble_kernel_sharded(X, Jc, inp['dperms'], 5.0, 5, mesh)
        out[layout] = spmd.solve_interleaved(K_loc, inp['y'], 1e-10, lay, mesh, layout=layout).numpy()
    spmd.NB = 30
    K_loc, lay = spmd.assemble_kernel_sharded(X, Jc, inp['dperms'], 5.0, 5, mesh)
    out['cyclic_nb30'] = spmd.solve_interleaved(K_loc, inp['y'], 1e-10, lay, mesh, layout='cyclic').numpy()
    return out


# -- tests/test_torch_mesh_ozaki.py ------------------------------------------


def scenario_mesh_ozaki(out_dir):
    """The column-sharded streamed slice-stack factor (force-only and
    bordered, 8 and 6 slices) and its applies, the mesh CG with
    ``factor_mode='ozaki'`` on the JAX tests' two tasks, and the mesh plan."""
    from sgdml_tpu_torch.parallel import spmd
    from sgdml_tpu_torch.parallel.mesh import all_gather_rows, default_mesh, mesh_info
    from sgdml_tpu_torch.solvers.iterative import Iterative
    from sgdml_tpu_torch.utils import io

    inp = np.load(os.path.join(out_dir, 'mesh_ozaki_inputs.npz'))
    mesh = default_mesh(device='cpu')
    info = mesh_info(mesh)
    X, Jc, dperms = torch.as_tensor(inp['X']), torch.as_tensor(inp['Jc']), inp['dperms']
    out = {}
    for ns in (8, 6):
        for e in (False, True):
            tag = '%s%d' % ('e' if e else 'f', ns)
            cols = inp['cols_e'] if e else inp['cols']
            C_E = torch.as_tensor(inp['C_E']) if e else None
            F, lev = spmd.nystrom_factor_sharded_streamed(X, Jc, dperms, 6.0, 1e-10, cols, 5, mesh, n_slices=ns,
                                                          C_E_psd=C_E)
            out[tag + '_sig'] = all_gather_rows(F.F.sig, info).numpy()
            out[tag + '_lev'] = lev
            if e:
                out[tag + '_FE'] = F.F_E.numpy()
                out[tag + '_apply'] = spmd.ozaki_factor_apply_sharded_bordered(F, torch.as_tensor(inp['v_e'])).numpy()
            else:
                out[tag + '_apply'] = spmd.ozaki_factor_apply_sharded(F, torch.as_tensor(inp['v_pad'])).numpy()
            out[tag + '_stack_cols'] = np.asarray(F.F.s.shape[2])
    for name in ('F', 'E'):
        task = io.load_dict(os.path.join(out_dir, 'ozaki_task_%s.npz' % name))
        sys_ = np.load(os.path.join(out_dir, 'ozaki_system_%s.npz' % name))
        res = Iterative(mesh=mesh, factor_mode='ozaki', device='cpu').solve(
            task, sys_['X'], sys_['Jc'], sys_['dperms'], sys_['y'], float(sys_['y_std']))
        out['cg_%s_alphas' % name] = res[0].numpy()
        out['cg_%s_iters' % name] = np.asarray(res[2])
        out['cg_%s_idxs' % name] = res[5]
        out['cg_%s_conv' % name] = np.asarray(res[6])
    solver = Iterative(mesh=mesh, factor_mode='ozaki', max_memory=15.5, device='cpu')
    out['plan'] = np.asarray([solver._factor_plan(3000, 60, use_E_cstr=e) for e in (False, True)])
    out['plan_ns'] = np.asarray(solver._ns())
    return out
