"""Command-line workflow assistant.

Mirrors the reference's 9-subcommand UX (sgdml/cli.py) and ``sgdml-tpu``
step for step: ``all`` chains create -> train -> select -> test; tasks/models
are npz artifacts in a deterministic directory layout, under the same file
names, with MD5 provenance checks at every step.

    sgdml-tpu-torch all    <dataset> <n_train> <n_valid> [<n_test>] [options]
    sgdml-tpu-torch create <dataset> <n_train> <n_valid> [options]
    sgdml-tpu-torch train  <task_dir_or_file> [<valid_dataset>]
    sgdml-tpu-torch validate <model_dir_or_file> <dataset>
    sgdml-tpu-torch test   <model> <dataset> [<n_test>]
    sgdml-tpu-torch select <model_dir>
    sgdml-tpu-torch resume <model> <dataset>
    sgdml-tpu-torch show   <file>
    sgdml-tpu-torch reset

Every training and prediction runs on ``--device`` (``cuda`` by default; it
may come before or after the subcommand): on a GPU each validation and test
prediction, the integration constant and every CG matvec run the fused
(E, F) kernel. Without a card the default raises before any file is
written; nothing falls back to the CPU unasked.

``--devices N`` trains and tests over a mesh of N devices, one process
each: ``torchrun --nproc-per-node N -m sgdml_tpu_torch.cli ... --devices N``
(``-1``: the launched world; ``1`` needs no launcher). A world of another
size raises before any work. Every rank runs the command; rank 0 alone
writes files and prints, and the others wait for its writes.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import sys

import numpy as np
import torch.distributed as dist

from . import __version__
from .parallel.mesh import is_writer
from .predict import GDMLPredict
from .train import GDMLTrain
from .utils import io

log = logging.getLogger('sgdml_tpu_torch.cli')


def _dataset_path(arg):
    """Argparse type: dataset file path OR an MD5 fingerprint (optionally
    '<dir>/<md5>') resolved against the matching dataset file — so
    `sgdml-tpu-torch test model.npz <md5>` works like the reference
    (sgdml/utils/io.py:327-411)."""
    path, _ = io.is_file_type(arg, 'dataset')
    return path


def _make_mesh(n_devices, device='cuda'):
    """The device mesh of ``--devices`` on ``device``'s type: None/0 -> a
    single device (no mesh); N -> a 1-D mesh over a world of N processes;
    -1 -> over the launched world. :func:`main` makes it once, before any
    work, and the subcommands read it as ``args.mesh``.

    The world comes from ``torchrun``'s environment; without one it has
    this process alone, and is made here when N is 1 or -1. A world of
    another size than N raises ``ValueError``.
    """
    if not n_devices:
        return None
    from .parallel import mesh as mesh_mod

    mesh_mod.init_distributed(device=device)  # from torchrun's environment, if any
    world = dist.get_world_size() if dist.is_initialized() else 1
    want = world if n_devices < 0 else n_devices
    if want != world:
        raise ValueError(
            '--devices %d: the launched world has %d process(es); launch one process a device with '
            '`torchrun --nproc-per-node %d -m sgdml_tpu_torch.cli ... --devices %d`' % (
                n_devices, world, want, want))
    if not dist.is_initialized():
        mesh_mod.init_distributed(world_size=1, rank=0, device=device)
    return mesh_mod.default_mesh(want, device=device)


def _write(fn, *args):
    """``fn(*args)`` (a file write) on rank 0 alone, between two barriers:
    no rank is still reading the file when it is written, nor reads it
    before."""
    if dist.is_initialized():
        dist.barrier()
    if is_writer():
        fn(*args)
    if dist.is_initialized():
        dist.barrier()


def _from_writer(fn, *args):
    """``fn(*args)`` on rank 0 alone; its result, or its exception, on
    every rank."""
    if not dist.is_initialized():
        return fn(*args)
    out = [None]
    if dist.get_rank() == 0:
        try:
            out[0] = (True, fn(*args))
        except BaseException as exc:  # SystemExit too: every rank stops alike
            out[0] = (False, exc)
    dist.broadcast_object_list(out, src=0)
    ok, value = out[0]
    if not ok:
        raise value
    return value


def _device(args):
    """The engines' device: ``--device``, the GPU when not given."""
    return getattr(args, 'device', 'cuda')


# ---------------------------------------------------------------------------
# Error metrics (reference definitions: sgdml/cli.py:1556-1605,1170-1180)
# ---------------------------------------------------------------------------


def force_error_metrics(F_pred, F_ref, n_atoms):
    """MAE/RMSE for force components, magnitudes and angular deviation."""
    F_pred = np.asarray(F_pred).reshape(len(F_pred), n_atoms, 3)
    F_ref = np.asarray(F_ref).reshape(len(F_ref), n_atoms, 3)

    diff = (F_pred - F_ref).reshape(-1)
    mae = np.abs(diff).mean()
    rmse = np.sqrt((diff**2).mean())

    mag_pred = np.linalg.norm(F_pred, axis=2).reshape(-1)
    mag_ref = np.linalg.norm(F_ref, axis=2).reshape(-1)
    mag_d = mag_pred - mag_ref
    mag_mae, mag_rmse = np.abs(mag_d).mean(), np.sqrt((mag_d**2).mean())

    dot = np.einsum('bnc,bnc->bn', F_pred, F_ref)
    denom = np.maximum(
        np.linalg.norm(F_pred, axis=2) * np.linalg.norm(F_ref, axis=2), 1e-30
    )
    cos = np.clip(dot / denom, -1.0, 1.0)
    ang = (np.arccos(cos) / np.pi).reshape(-1)
    ang_mae, ang_rmse = np.abs(ang).mean(), np.sqrt((ang**2).mean())

    return {
        'mae': float(mae),
        'rmse': float(rmse),
        'mag_mae': float(mag_mae),
        'mag_rmse': float(mag_rmse),
        'ang_mae': float(ang_mae),
        'ang_rmse': float(ang_rmse),
    }


def energy_error_metrics(E_pred, E_ref):
    d = np.asarray(E_pred) - np.asarray(E_ref)
    return {'mae': float(np.abs(d).mean()), 'rmse': float(np.sqrt((d**2).mean()))}


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def _load_perms_file(path):
    """Load an externally provided permutation table (reference parity:
    the ``--perms`` parser option feeding create_task(perms=...)).

    Accepts a ``.npy`` array or an ``.npz`` containing a ``perms`` key
    (datasets and models both carry one, so either can be used directly).
    """
    if path.endswith('.npy'):
        perms = np.load(path)
    else:
        data = np.load(path, allow_pickle=True)
        if 'perms' not in data:
            raise argparse.ArgumentTypeError(
                "%s contains no 'perms' array." % path
            )
        perms = data['perms']
    perms = np.asarray(perms)
    if perms.ndim != 2 or perms.dtype.kind not in 'iu':
        raise argparse.ArgumentTypeError(
            '%s: permutations must be a 2-D integer array.' % path
        )
    return perms.astype(np.int64)


def create(args):
    """Create the task files of a sigma grid (on rank 0; every rank returns
    the task directory)."""
    return _from_writer(_create, args)


def _create(args):
    # The trainer first: it resolves the device, so a missing card raises
    # before the task directory exists.
    trainer = GDMLTrain(max_memory=args.max_memory, device=_device(args))
    dataset = io.validate_dataset(io.load_dict(args.dataset))
    sigs = args.sig if isinstance(args.sig, list) else [args.sig]

    # Separate validation dataset (reference: sgdml all/create
    # valid_dataset argument, sgdml/cli.py:612-740); defaults to the
    # training dataset.
    valid_dataset = dataset
    if getattr(args, 'valid_dataset', None):
        valid_dataset = io.validate_dataset(io.load_dict(args.valid_dataset))

    perms = None
    if getattr(args, 'perms', None):
        perms = _load_perms_file(args.perms)

    task_dir = args.task_dir or io.train_dir_name(
        dataset,
        args.n_train,
        use_sym=not args.gdml,
        use_E=not args.no_E,
        use_E_cstr=args.E_cstr,
    )
    if os.path.exists(task_dir):
        if args.overwrite:
            shutil.rmtree(task_dir)
        elif io.is_task_dir_resumable(
            task_dir, dataset, valid_dataset, args.n_train, args.n_valid,
            sigs, args.E_cstr,
        ):
            log.info('Resuming existing task directory %s.', task_dir)
            return task_dir
        else:
            print(
                'Task directory %s exists and does not match the requested '
                'configuration. Use -o to overwrite.' % task_dir
            )
            sys.exit(1)
    os.makedirs(task_dir, exist_ok=True)

    template = trainer.create_task(
        dataset,
        args.n_train,
        valid_dataset,
        args.n_valid,
        sig=sigs[0],
        lam=args.lam,
        perms=perms,
        use_sym=not args.gdml,
        use_E=not args.no_E,
        use_E_cstr=args.E_cstr,
    )
    for sig in sigs:
        task = dict(template)
        task['sig'] = sig
        path = os.path.join(task_dir, io.task_file_name(task))
        io.save_dict(path, task)
        log.info('Wrote %s', path)
    print('Created %d task(s) in %s.' % (len(sigs), task_dir))
    return task_dir


def train(args):
    path = args.task
    tasks = []
    if os.path.isdir(path):
        tasks = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.startswith('task-') and f.endswith('.npz')
        )
    else:
        tasks = [path]
    if not tasks:
        print('No task files found in %s.' % path)
        sys.exit(1)

    trainer = GDMLTrain(
        max_memory=args.max_memory, mesh=getattr(args, 'mesh', None),
        device=_device(args),
    )
    valid_dataset = (
        io.load_dict(args.valid_dataset) if args.valid_dataset else None
    )

    lazy = bool(getattr(args, 'lazy', False))
    prev_valid_rmse = None
    model_paths = []
    # Cross-sigma warm starts: tasks produced by `create` share one
    # training split, and the solution vector moves smoothly with sigma,
    # so each iterative solve warm-starts from the previous sigma's
    # coefficients. Measured 1.06x fewer total CG iterations over a
    # converging 5-sigma grid (BENCH_NOTES r5) — a small free win, never
    # worse than cold (the solver falls back to a cold start on any
    # split/shape mismatch). The reference re-solves every sigma from
    # scratch (sgdml/cli.py:1078-1136).
    warm = None
    for task_path in tasks:
        task = io.load_dict(task_path)
        model_path = os.path.join(
            os.path.dirname(task_path), io.model_file_name(task)
        )
        if os.path.exists(model_path) and not args.overwrite:
            log.info('Model exists, skipping: %s', model_path)
            model_paths.append(model_path)
            continue
        # --lazy: give up on tasks whose training was attempted before but
        # produced no model (reference: sgdml/cli.py:87 --lazy flag and the
        # tried_training marker, cli.py:1065-1075).
        if lazy and bool(task.get('tried_training', False)):
            log.info(
                'Skipping task with a previously failed training attempt '
                '(--lazy): %s', task_path,
            )
            continue

        def save_progress(unconv_model, _path=model_path):
            if is_writer():
                io.save_dict(_path.replace('model-', '_unconv_model-'), unconv_model)

        # Mark the attempt up front, so a crash mid-training leaves the
        # marker behind for --lazy runs to skip.
        task['tried_training'] = True
        _write(io.save_dict, task_path, task)

        log.info('Training task %s', task_path)
        if (
            warm is not None
            and task.get('md5_train') == warm['md5']
            and np.array_equal(task.get('idxs_train'), warm['idxs'])
            and bool(task.get('use_E_cstr', False)) == (warm['E'] is not None)
        ):
            # Set AFTER the tried_training save above, so warm-start
            # coefficients never bloat the on-disk task file.
            task['alphas0_F'] = warm['F']
            if warm['E'] is not None:
                task['alphas0_E'] = warm['E']
            log.info(
                'Warm-starting from the previous sigma\'s coefficients.'
            )
        model = trainer.train(
            task, solver=args.solver, save_progr_callback=save_progress,
            solver_max_seconds=getattr(args, 'max_seconds', None),
            factor_slices=getattr(args, 'factor_slices', None),
        )
        if 'alphas_F' in model:
            warm = {
                'md5': task.get('md5_train'),
                'idxs': task.get('idxs_train'),
                'F': model['alphas_F'],
                'E': model.get('alphas_E'),
            }
        unconv = model_path.replace('model-', '_unconv_model-')
        _write(_save_model, model_path, model, unconv)
        model_paths.append(model_path)
        print('Trained %s' % model_path)

        # Early stopping over the sigma grid: validation force RMSE rising
        # (reference: sgdml/cli.py:1138-1150).
        if valid_dataset is not None and len(tasks) > 1:
            res = _from_writer(lambda: _validate_model(io.load_dict(model_path), valid_dataset,
                                                       device=_device(args)))
            rmse = res['f_err']['rmse']
            log.info('Validation force RMSE at sig=%s: %.5f', task['sig'], rmse)
            if prev_valid_rmse is not None and rmse > prev_valid_rmse:
                log.info('Validation error rising; stopping sigma search.')
                break
            prev_valid_rmse = rmse
    return model_paths


def _save_model(path, model, unconv):
    """Write a trained model and drop its checkpoint."""
    io.save_dict(path, model)
    if os.path.exists(unconv):
        os.remove(unconv)


def _validate_model(model, dataset, n_test=None, batch=250, mesh=None, device='cuda'):
    """Shared validate/test core (reference: one function for both,
    sgdml/cli.py:1327-1794; n_test=None => validation split)."""
    md5 = io.dataset_md5(dataset)
    if n_test is None and model.get('md5_valid') != md5:
        # Validation must run on the exact dataset the split came from
        # (reference: sgdml/cli.py:1431-1434).
        raise ValueError(
            'Dataset fingerprint does not match the validation dataset this '
            'model was created with.'
        )

    n_atoms = dataset['R'].shape[1]
    if n_test is None:
        idxs = np.asarray(model['idxs_valid'])
    else:
        # Testing may use a different dataset; train/validation indices are
        # excluded only when the fingerprint shows they refer to *this*
        # dataset (reference: sgdml/cli.py:1439-1448).
        excl = np.empty((0,), dtype=np.int64)
        if model.get('md5_train') == md5:
            excl = np.concatenate([excl, np.asarray(model['idxs_train'])])
        if model.get('md5_valid') == md5:
            excl = np.concatenate([excl, np.asarray(model['idxs_valid'])])
        cands = np.setdiff1d(np.arange(dataset['R'].shape[0]), excl)
        if n_test > 0:
            np.random.seed(0)
            idxs = np.random.choice(cands, min(n_test, len(cands)), replace=False)
        else:
            idxs = cands

    pred = GDMLPredict(model, mesh=mesh, device=device)
    use_E = bool(model.get('use_E', True)) and 'E' in dataset

    E_pred_all, F_pred_all = [], []
    for b0 in range(0, len(idxs), batch):
        sl = idxs[b0 : b0 + batch]
        E, F = pred.predict(dataset['R'][sl].reshape(len(sl), -1))
        E_pred_all.append(E)
        F_pred_all.append(F)
    E_pred = np.concatenate(E_pred_all)
    F_pred = np.concatenate(F_pred_all)

    out = {
        'n': len(idxs),
        'f_err': force_error_metrics(
            F_pred, dataset['F'][idxs].reshape(len(idxs), -1), n_atoms
        ),
    }
    if use_E:
        out['e_err'] = energy_error_metrics(E_pred, dataset['E'][idxs])
    return out


def validate(args):
    return test(args, n_test=None)


def test(args, n_test='arg'):
    if n_test == 'arg':
        n_test = getattr(args, 'n_test', 0) or 0
    dataset = io.validate_dataset(io.load_dict(args.dataset))

    paths = []
    if os.path.isdir(args.model):
        paths = sorted(
            os.path.join(args.model, f)
            for f in os.listdir(args.model)
            if f.startswith('model-') and f.endswith('.npz')
        )
    else:
        paths = [args.model]

    results = []
    for path in paths:
        model = io.load_dict(path)
        if not io.is_model(model):
            continue
        # Provenance checks (reference: cli.py:1385-1398).
        if not np.array_equal(np.sort(model['z']), np.sort(dataset['z'])):
            raise ValueError('Atom composition of model and dataset differ.')
        if ('lattice' in model) != ('lattice' in dataset):
            raise ValueError('Lattice presence differs between model/dataset.')

        res = _validate_model(
            model, dataset, n_test=n_test,
            mesh=getattr(args, 'mesh', None), device=_device(args),
        )
        kind = 'validation' if n_test is None else 'test'
        print(
            '%s  [%s n=%d]  force MAE %.5f RMSE %.5f%s'
            % (
                os.path.basename(path),
                kind,
                res['n'],
                res['f_err']['mae'],
                res['f_err']['rmse'],
                (
                    '  energy MAE %.5f RMSE %.5f'
                    % (res['e_err']['mae'], res['e_err']['rmse'])
                    if 'e_err' in res
                    else ''
                ),
            )
        )
        # Record errors in the model file (reference: cli.py:1750-1772):
        # test errors always; validation errors only into a model that has
        # never been validated/tested (so they never clobber test errors).
        f_err_cur = model.get('f_err', {'mae': np.nan})
        if isinstance(f_err_cur, np.ndarray):
            f_err_cur = f_err_cur.item()
        never_validated = not np.isfinite(f_err_cur.get('mae', np.nan))
        if n_test is not None:
            model['n_test'] = res['n']
            model['md5_test'] = io.dataset_md5(dataset)
            model['f_err'] = res['f_err']
            if 'e_err' in res:
                model['e_err'] = res['e_err']
            _write(io.save_dict, path, model)
        elif never_validated:
            model['f_err'] = res['f_err']
            if 'e_err' in res:
                model['e_err'] = res['e_err']
            _write(io.save_dict, path, model)
        results.append((path, res))
    return results


def select(args):
    """Pick the model with minimal validation force RMSE over the sigma
    grid (reference: sgdml/cli.py:1797-1937), on rank 0; every rank returns
    the selected model's path."""
    return _from_writer(_select, args)


def _select(args):
    dataset = io.load_dict(args.dataset) if args.dataset else None
    paths = sorted(
        os.path.join(args.model_dir, f)
        for f in os.listdir(args.model_dir)
        if f.startswith('model-') and f.endswith('.npz')
    )
    if not paths:
        print('No model files found in %s.' % args.model_dir)
        sys.exit(1)

    rows = []
    for path in paths:
        model = io.load_dict(path)
        if dataset is not None:
            res = _validate_model(model, dataset, n_test=None, device=_device(args))
            rmse = res['f_err']['rmse']
        else:
            rmse = float(model['f_err'].item()['rmse']) if isinstance(
                model['f_err'], np.ndarray
            ) else float(model['f_err']['rmse'])
        rows.append((path, float(np.squeeze(model['sig'])), rmse))

    rows.sort(key=lambda r: r[1])
    sigs = [r[1] for r in rows]
    rmses = [r[2] for r in rows]
    best = int(np.nanargmin(rmses))
    if best in (0, len(rows) - 1) and len(rows) > 1:
        log.warning(
            'Optimal sigma lies on the boundary of the search grid — '
            'extend the grid (-s) for a better model.'
        )
    best_path = rows[best][0]

    out_path = args.out or io.model_file_name(
        io.load_dict(best_path), is_extended=True
    )
    shutil.copy(best_path, out_path)
    print(
        'Selected sig=%g (force RMSE %.5f) -> %s'
        % (rows[best][1], rows[best][2], out_path)
    )
    return out_path


def all_cmd(args):
    """create -> train -> select -> test (reference: sgdml/cli.py:612-740).

    Validation runs against ``--valid_dataset`` and the final test against
    ``--test_dataset`` (each defaulting to the training dataset), matching
    the reference's separate-dataset ``all`` signature.
    """
    valid_path = getattr(args, 'valid_dataset', None) or args.dataset
    test_path = getattr(args, 'test_dataset', None) or args.dataset

    task_dir = create(args)

    targs = argparse.Namespace(
        task=task_dir,
        valid_dataset=valid_path,
        overwrite=False,
        max_memory=args.max_memory,
        solver=args.solver,
        mesh=getattr(args, 'mesh', None),
        lazy=getattr(args, 'lazy', False),
        max_seconds=getattr(args, 'max_seconds', None),
        factor_slices=getattr(args, 'factor_slices', None),
        device=_device(args),
    )
    train(targs)

    sargs = argparse.Namespace(
        model_dir=task_dir, dataset=valid_path, out=args.model_file,
        device=_device(args),
    )
    best = select(sargs)

    if args.n_test is None or args.n_test != 0:
        xargs = argparse.Namespace(
            model=best, dataset=test_path,
            mesh=getattr(args, 'mesh', None), device=_device(args),
        )
        test(xargs, n_test=args.n_test or 0)
    print('Model saved to %s' % best)


def resume(args):
    """Warm-start continuation of an unconverged iterative model
    (reference: sgdml/cli.py:1183-1285)."""
    model = io.load_dict(args.model)
    dataset = io.validate_dataset(io.load_dict(args.dataset))
    if model.get('md5_train') != io.dataset_md5(dataset):
        raise ValueError(
            'Dataset fingerprint does not match the one this model was '
            'trained on.'
        )
    solver = model.get('solver_name', 'analytic')
    if isinstance(solver, bytes):
        solver = solver.decode()
    if str(solver) == 'analytic':
        print('Analytically solved models cannot be resumed (already exact).')
        sys.exit(1)

    trainer = GDMLTrain(
        max_memory=args.max_memory, mesh=getattr(args, 'mesh', None),
        device=_device(args),
    )
    task = trainer.create_task_from_model(model, dataset)
    new_model = trainer.train(
        task, solver='cg',
        solver_max_seconds=getattr(args, 'max_seconds', None),
        factor_slices=getattr(args, 'factor_slices', None),
    )
    out = args.out or args.model
    _write(io.save_dict, out, new_model)
    print('Resumed model saved to %s' % out)


def show(args):
    """Pretty-print any npz artifact (reference: sgdml/cli.py:1940-1952)."""
    data = io.load_dict(args.file)
    kind = {'d': 'dataset', 't': 'task', 'm': 'model'}.get(
        io.artifact_type(data), 'unknown'
    )
    print('type: %s' % kind)
    for k in sorted(data.keys()):
        v = data[k]
        if isinstance(v, np.ndarray) and v.size > 8:
            desc = '  %-20s array%s %s' % (k, list(v.shape), v.dtype)
            if v.dtype.kind in 'fiu':
                desc += '  [%.4g .. %.4g]' % (v.min(), v.max())
            print(desc)
        elif isinstance(v, np.ndarray):
            print('  %-20s %s' % (k, np.array2string(v.ravel())))
        else:
            print('  %-20s %s' % (k, v))
    if kind == 'dataset' and 'lattice' in data:
        from .utils import ui

        print('lattice:')
        ui.print_lattice(data['lattice'])


def reset(args):
    """Purge cached benchmark results and compiled artifacts
    (reference: sgdml/cli.py:1955-1976 purges _bmark_cache.npz): the tune
    cache and the built CUDA kernels, which are rebuilt at their next use."""
    from .ops import _build
    from .tune import reset_cache

    removed = False
    if reset_cache():
        print('Removed benchmark cache.')
        removed = True

    build_dir = _build.BUILD_DIR
    if os.path.isdir(build_dir):
        shutil.rmtree(build_dir)
        _build.load_library.cache_clear()
        print('Removed built kernels %s.' % build_dir)
        removed = True
    if not removed:
        print('No caches to remove.')


# ---------------------------------------------------------------------------
# Argument parsing
# ---------------------------------------------------------------------------


def _add_common_train_args(p):
    p.add_argument(
        'dataset', type=_dataset_path,
        help='dataset npz file (or MD5 fingerprint to resolve)',
    )
    p.add_argument('n_train', type=io.is_strict_pos_int)
    p.add_argument('n_valid', type=io.is_strict_pos_int)
    p.add_argument(
        '-s',
        '--sig',
        default='10:10:100',
        help="sigma grid 'start:step:stop', list '10,20', or single value",
    )
    p.add_argument('--lam', type=float, default=1e-10)
    p.add_argument('--gdml', action='store_true', help='disable symmetries')
    p.add_argument('--no_E', action='store_true', help='ignore energy labels')
    p.add_argument(
        '--E_cstr', action='store_true', help='include energy constraints'
    )
    p.add_argument('-o', '--overwrite', action='store_true')
    p.add_argument(
        '-v', '--valid_dataset', '--validation_dataset',
        type=_dataset_path, default=None,
        help='draw the validation split from this dataset instead of the '
        'training one (reference: -v/--validation_dataset, cli.py:2061)',
    )
    p.add_argument(
        '--perms', '--perms_from', default=None,
        help='npz/npy file providing the permutation table (skips '
        'symmetry discovery; reference: --perms_from, cli.py:2094)',
    )
    p.add_argument('--task_dir', default=None)
    p.add_argument('--max_memory', type=float, default=None, help='GB budget')
    p.add_argument(
        '--solver', choices=['analytic', 'cg'], default=None,
        help='force solver choice (default: by memory estimate)',
    )
    p.add_argument(
        '--devices', type=int, default=None,
        help='train and test over a mesh of N devices, one process each (launch '
        'with torchrun --nproc-per-node N; -1: the launched world; default: one '
        'device)',
    )
    _add_device_arg(p)
    _add_max_seconds_arg(p)


def _add_device_arg(p, default=argparse.SUPPRESS):
    # Accepted before and after the subcommand; the subcommand's copy only
    # overrides the top-level value when given.
    p.add_argument(
        '--device', default=default,
        help="torch device for training and prediction, e.g. 'cuda', 'cuda:1' "
        "or 'cpu' (default: cuda; without a card 'cuda' raises)",
    )


def _factor_slices_arg(v):
    return v if v == 'auto' else int(v)


def _add_max_seconds_arg(p):
    p.add_argument(
        '--max_seconds', '--solver_budget', type=float, default=None,
        help='wall-clock budget (s) for the iterative solver\'s CG loop; '
        'an unconverged best iterate is returned when it expires '
        '(default: no budget — the stagnation policy alone decides)',
    )
    p.add_argument(
        '--factor_slices', type=_factor_slices_arg, default=None,
        help="int8 slice count of the iterative solver's preconditioner "
        'factor (3-10); default auto-selects the count whose memory '
        'budget affords the largest inducing-point cap',
    )


def main(argv=None):
    from .utils.ui import init_logging

    init_logging()
    parser = argparse.ArgumentParser(
        prog='sgdml-tpu-torch',
        description='sGDML force-field reconstruction on PyTorch and CUDA (v%s)'
        % __version__,
    )
    parser.add_argument(
        '--version', action='version',
        version='%%(prog)s %s' % __version__,
    )
    _add_device_arg(parser, default='cuda')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('all', help='create + train + select + test')
    _add_common_train_args(p)
    p.add_argument('n_test', type=int, nargs='?', default=None)
    p.add_argument('--model_file', default=None)
    p.add_argument(
        '-t', '--test_dataset', type=_dataset_path, default=None,
        help='run the final test on this dataset instead of the training '
        'one (reference: -t/--test_dataset, cli.py:2069)',
    )
    p.add_argument(
        '--lazy', action='store_true',
        help='skip tasks whose training previously failed',
    )

    p = sub.add_parser('create', help='create training task(s)')
    _add_common_train_args(p)

    p = sub.add_parser('train', help='train model(s) from task(s)')
    p.add_argument('task', help='task file or task directory')
    p.add_argument('valid_dataset', nargs='?', default=None)
    p.add_argument(
        '--lazy', action='store_true',
        help='skip tasks whose training previously failed',
    )
    p.add_argument('-o', '--overwrite', action='store_true')
    p.add_argument('--max_memory', type=float, default=None)
    p.add_argument('--solver', choices=['analytic', 'cg'], default=None)
    p.add_argument('--devices', type=int, default=None)
    _add_device_arg(p)
    _add_max_seconds_arg(p)

    p = sub.add_parser('validate', help='validate model(s)')
    p.add_argument('model', help='model file or directory')
    p.add_argument('dataset', type=_dataset_path)
    p.add_argument('--devices', type=int, default=None)
    _add_device_arg(p)

    p = sub.add_parser('test', help='test a model')
    p.add_argument('model')
    p.add_argument('dataset', type=_dataset_path)
    p.add_argument('n_test', type=int, nargs='?', default=0)
    p.add_argument('--devices', type=int, default=None)
    _add_device_arg(p)

    p = sub.add_parser('select', help='select best model from directory')
    p.add_argument('model_dir')
    p.add_argument('dataset', nargs='?', default=None, type=_dataset_path)
    p.add_argument('--out', default=None)
    _add_device_arg(p)

    p = sub.add_parser('resume', help='resume iterative training')
    p.add_argument('model')
    p.add_argument('dataset', type=_dataset_path)
    p.add_argument('--out', default=None)
    p.add_argument('--max_memory', type=float, default=None)
    p.add_argument('--devices', type=int, default=None)
    _add_device_arg(p)
    _add_max_seconds_arg(p)

    p = sub.add_parser('show', help='inspect an npz artifact')
    p.add_argument('file')

    sub.add_parser('reset', help='purge caches')

    args = parser.parse_args(argv)

    if hasattr(args, 'sig'):
        args.sig = io.parse_list_or_range(args.sig)
    args.mesh = _make_mesh(getattr(args, 'devices', None), _device(args))  # before any work

    cmd = {
        'all': all_cmd,
        'create': create,
        'train': train,
        'validate': validate,
        'test': test,
        'select': select,
        'resume': resume,
        'show': show,
        'reset': reset,
    }[args.command]
    if is_writer():
        return cmd(args)
    # The other ranks of a mesh compute alike, but print nothing.
    level = logging.getLogger('sgdml_tpu_torch').level
    logging.getLogger('sgdml_tpu_torch').setLevel(logging.WARNING)
    try:
        with open(os.devnull, 'w') as devnull, contextlib.redirect_stdout(devnull):
            return cmd(args)
    finally:
        logging.getLogger('sgdml_tpu_torch').setLevel(level)


if __name__ == '__main__':
    main()
