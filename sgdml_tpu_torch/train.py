"""Training orchestrator: tasks -> kernel solve -> model.

API and artifact layout mirror ``sgdml_tpu.train`` and the reference's
``GDMLTrain`` (sgdml/train.py:305-1088): task dicts are training recipes
with MD5 provenance and stratified train/validation splits; model dicts hold
everything inference needs, in the file layout both packages read. Training
runs in float64 on the trainer's device (the GPU unless the caller asks for
the CPU): descriptors, then the analytic solver (the dense kernel assembly
and its Cholesky solve; past the dense bound the same kernel factored in
place, or past that the f32 block-grid or pair-precision Cholesky and an f64
refinement CG) or the Nystrom-preconditioned CG solver, the
alpha-contracted Jacobians and the integration constant. On a GPU the
prediction passes (every CG matvec, the integration constant) launch the
fused (E, F) kernel.

With a ``mesh`` (``parallel/mesh.py``: one process per device, every rank
calling :meth:`GDMLTrain.train` alike) the analytic solve is the sharded
assembly and distributed f64 Cholesky of ``parallel/spmd.py``, and the CG
solve shards its matvec and factor; every rank gets the whole model.
"""

from __future__ import annotations

import logging
import timeit

import numpy as np
import torch

from . import __version__, resolve_device
from .ops import descriptor as desc_ops
from .predict import GDMLPredict, desc_perm_table
from .solvers.analytic import Analytic, memory_budget
from .solvers.iterative import Iterative
from .utils import io
from .utils.profiling import PhaseTimer

__all__ = ['GDMLTrain', 'desc_perm_table']

log = logging.getLogger(__name__)

_F64 = torch.float64


class GDMLTrain:
    """Train (s)GDML force-field models.

    Parameters
    ----------
    max_memory: device-memory budget in GB for the solver choice, the dense
        solve and the CG preconditioner; None takes the device's free memory
        (12 GB on the CPU).
    mesh: a ``DeviceMesh`` to train over (see the module docstring); the
        trainer then runs on this rank's device of the mesh, and ``device``,
        where given, must name it. None: one device.
    device: where training runs: the GPU unless the caller asks for the CPU
        (``device='cpu'``); without a card the default raises.

    After :meth:`train`, ``times`` holds its seconds by phase and
    ``'total'``; the analytic solve is split as ``Analytic.timer`` splits it
    (dense: ``'assembly'`` and ``'cholesky'``; in-place f64 and the mesh:
    ``'assembly'``, ``'factor'`` and ``'solve'``; grid: ``'lmax'``,
    ``'assembly'``, ``'factor'``, ``'border'`` with energy constraints, and
    ``'cg'``; pair: the grid's and ``'repack'``), the CG solve into
    ``'leverage scores'``, ``'factor'`` and ``'cg'``.
    """

    def __init__(self, max_memory: float | None = None, mesh=None, *, device='cuda'):
        self._max_memory = max_memory
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from .parallel.mesh import mesh_device, mesh_info

            self.device = mesh_device(mesh_info(mesh), device)
        self.times: dict[str, float] = {}

    # ------------------------------------------------------------------
    # Task creation
    # ------------------------------------------------------------------

    def create_task(
        self, train_dataset, n_train, valid_dataset, n_valid, sig, lam=1e-10,
        perms=None, use_sym=True, use_E=True, use_E_cstr=False, callback=None, rng=None,
    ):
        """Create a training-task dict (recipe + provenance).

        Matches the reference's sampling and key layout
        (sgdml/train.py:370-647): energy-stratified train/valid splits
        without overlap, dataset MD5 fingerprints, and permutation-symmetry
        discovery when ``use_sym`` and no perms are available.

        rng: a ``np.random.RandomState`` to draw the splits from, or None for
        numpy's global one (what the JAX package draws from). Both give the
        JAX package's splits: ``RandomState(7)`` draws what
        ``np.random.seed(7)`` followed by the global draws does.
        """
        rng = np.random if rng is None else rng
        if use_E and 'E' not in train_dataset:
            raise ValueError(
                'No energy labels found in dataset! Energies are required unless use_E=False.'
            )
        use_E_cstr = use_E and use_E_cstr

        md5_train = io.dataset_md5(train_dataset)
        md5_valid = io.dataset_md5(valid_dataset)

        if 'E' in train_dataset:
            idxs_train = self.draw_strat_sample(train_dataset['E'], n_train, rng=rng)
        else:
            idxs_train = rng.choice(np.arange(train_dataset['F'].shape[0]), n_train, replace=False)

        excl_idxs = idxs_train if md5_train == md5_valid else np.array([], dtype=np.uint)
        if 'E' in valid_dataset:
            idxs_valid = self.draw_strat_sample(valid_dataset['E'], n_valid, excl_idxs=excl_idxs, rng=rng)
        else:
            cands = np.setdiff1d(np.arange(valid_dataset['F'].shape[0]), excl_idxs, assume_unique=True)
            idxs_valid = rng.choice(cands, n_valid, replace=False)

        R_train = train_dataset['R'][idxs_train, :, :]
        task = {
            'type': 't',
            'code_version': __version__,
            'dataset_name': np.asarray(train_dataset['name']).astype(str),
            'dataset_theory': np.asarray(train_dataset['theory']).astype(str),
            'z': train_dataset['z'],
            'R_train': R_train,
            'F_train': train_dataset['F'][idxs_train, :, :],
            'idxs_train': idxs_train,
            'md5_train': md5_train,
            'idxs_valid': idxs_valid,
            'md5_valid': md5_valid,
            'sig': sig,
            'lam': lam,
            'use_E': use_E,
            'use_E_cstr': use_E_cstr,
            'use_sym': use_sym,
        }
        if use_E:
            task['E_train'] = train_dataset['E'][idxs_train]

        lat_and_inv = None
        if 'lattice' in train_dataset:
            task['lattice'] = train_dataset['lattice']
            try:
                lat_and_inv = (task['lattice'], np.linalg.inv(task['lattice']))
            except np.linalg.LinAlgError:
                raise ValueError('Dataset contains non-invertible lattice vectors.')
        if 'r_unit' in train_dataset and 'e_unit' in train_dataset:
            task['r_unit'] = train_dataset['r_unit']
            task['e_unit'] = train_dataset['e_unit']

        if use_sym:
            if perms is not None:
                perms = np.asarray(perms)
                if perms.shape[1] != len(task['z']):
                    raise ValueError('Provided permutations do not match the number of atoms.')
                log.info('Using %d externally provided permutations.', len(perms))
                task['perms'] = perms
            elif 'perms' in train_dataset:
                log.info('Using %d permutations included in dataset.', train_dataset['perms'].shape[0])
                task['perms'] = train_dataset['perms']
            else:
                from .perm import find_perms

                R_sync = R_train
                if R_train.shape[0] > 1000:
                    R_sync = R_train[rng.choice(R_train.shape[0], 1000, replace=False)]
                    log.info('Symmetry search restricted to a random subset of 1000/%d training points.',
                             R_train.shape[0])
                task['perms'] = find_perms(R_sync, train_dataset['z'], lat_and_inv=lat_and_inv)
        else:
            task['perms'] = np.arange(train_dataset['R'].shape[1])[None, :]

        return task

    def create_task_from_model(self, model, dataset):
        """Rebuild a task from an (unconverged) model for warm-started
        resumption (reference: sgdml/train.py:649-725)."""
        idxs_train = model['idxs_train']
        task = {
            'type': 't',
            'code_version': __version__,
            'dataset_name': model['dataset_name'],
            'dataset_theory': model['dataset_theory'],
            'z': model['z'],
            'R_train': dataset['R'][idxs_train, :, :],
            'F_train': dataset['F'][idxs_train, :, :],
            'idxs_train': idxs_train,
            'md5_train': model['md5_train'],
            'idxs_valid': model['idxs_valid'],
            'md5_valid': model['md5_valid'],
            'sig': model['sig'],
            'lam': model['lam'],
            'use_E': model['use_E'],
            'use_E_cstr': 'alphas_E' in model,
            'use_sym': model['perms'].shape[0] > 1,
            'perms': model['perms'],
        }
        if task['use_E']:
            task['E_train'] = dataset['E'][idxs_train]
        for key in ('lattice', 'r_unit', 'e_unit'):
            if key in model:
                task[key] = model[key]
        if 'alphas_F' in model:
            task['alphas0_F'] = model['alphas_F']
        if 'alphas_E' in model:
            task['alphas0_E'] = model['alphas_E']
        for key in ('solver_iters', 'inducing_pts_idxs', 'solver_mv_mm'):
            if key in model:
                task[key] = model[key]
        return task

    # ------------------------------------------------------------------
    # Model creation
    # ------------------------------------------------------------------

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=_F64, device=self.device)

    def create_model(self, task, solver, R_desc, R_d_desc, std, alphas_F, alphas_E=None):
        """Package trained coefficients into a model dict
        (key layout parity: sgdml/train.py:793-831; ``R_desc`` stored
        transposed (D, M) and the Jacobian pre-contracted with alpha on the
        device). Array arguments may be tensors or numpy arrays."""
        R_desc, R_d_desc = self._tensor(R_desc), self._tensor(R_d_desc)
        n_train, dim_d = R_d_desc.shape[:2]
        n_atoms = int((1 + np.sqrt(8 * dim_d + 1)) / 2)
        alphas_F = self._tensor(alphas_F)
        R_d_desc_alpha = desc_ops.jac_dot_vec(R_d_desc, alphas_F.reshape(-1, 3 * n_atoms), n_atoms)

        # tril_perms_lin: reference-compatible flattened permutation index
        # table (sgdml/train.py:903-904), stored for model interchange.
        dperms = desc_perm_table(task['perms'])
        n_perms = dperms.shape[0]
        tril_perms_lin = (dperms + np.arange(n_perms)[:, None] * dim_d).flatten('F')

        model = {
            'type': 'm',
            'code_version': __version__,
            'dataset_name': task['dataset_name'],
            'dataset_theory': task['dataset_theory'],
            'solver_name': solver,
            'z': task['z'],
            'idxs_train': task['idxs_train'],
            'md5_train': task['md5_train'],
            'idxs_valid': task['idxs_valid'],
            'md5_valid': task['md5_valid'],
            'n_test': 0,
            'md5_test': None,
            'f_err': {'mae': np.nan, 'rmse': np.nan},
            'R_desc': R_desc.cpu().numpy().T,
            'R_d_desc_alpha': R_d_desc_alpha.cpu().numpy(),
            'c': 0.0,
            'std': std,
            'sig': task['sig'],
            'lam': task['lam'],
            'alphas_F': alphas_F.cpu().numpy(),
            'perms': task['perms'],
            'tril_perms_lin': tril_perms_lin,
            'use_E': task['use_E'],
        }
        if task['use_E']:
            model['e_err'] = {'mae': np.nan, 'rmse': np.nan}
            if task.get('use_E_cstr', False):
                model['alphas_E'] = self._tensor(alphas_E).cpu().numpy()
        for key in ('lattice', 'r_unit', 'e_unit'):
            if key in task:
                model[key] = task[key]
        return model

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train(self, task, solver=None, save_progr_callback=None, callback=None,
              solver_max_seconds=None, factor_slices=None):
        """Train a model from a task dict.

        Solver selection follows the JAX package's (itself the reference's
        memory heuristic, sgdml/train.py:949-971): the analytic solver when
        the dense system's ``24 n^2`` bytes or the f32 grid route's ``3 n^2``
        fit the budget (it takes the dense route where that fits, the
        in-place f64 route past it where that fits; ``Analytic.solve``),
        Nystrom-preconditioned CG otherwise. Pass ``solver='analytic'`` or
        ``'cg'`` to override. ``solver_max_seconds`` bounds the CG wall clock (an
        unconverged model is returned, and flagged); ``save_progr_callback``
        receives CG checkpoints; ``factor_slices`` goes to the CG solver, where
        it sets the slices of the int8 slice-stack factor
        (``Iterative(factor_mode='ozaki')``; the default factor is f64).
        """
        t_start = timeit.default_timer()
        timer = PhaseTimer(self.device)
        task = dict(task)
        n_train, n_atoms = task['R_train'].shape[:2]
        use_E_cstr = bool(task['use_E'] and task.get('use_E_cstr', False))

        if solver is None:
            budget = (memory_budget(self.device) if self._max_memory is None
                      else self._max_memory * 1024**3)
            if self.mesh is not None:
                from .parallel.mesh import agree, mesh_info

                budget = float(agree([budget], mesh_info(self.mesh))[0])  # every rank picks alike
            use_analytic = (Analytic.est_memory_requirement(n_train, n_atoms, use_E_cstr) < budget
                            or Analytic.est_memory_grid(n_train, n_atoms) < budget)
            solver = 'analytic' if use_analytic else 'cg'
        if solver not in ('analytic', 'cg'):
            raise ValueError("solver must be None, 'analytic' or 'cg', got %r" % (solver,))

        lat_and_inv = None
        if 'lattice' in task:
            lat = np.asarray(task['lattice'], dtype=np.float64)
            lat_and_inv = (self._tensor(lat), self._tensor(np.linalg.inv(lat)))

        with timer.phase('descriptors'):
            R = self._tensor(task['R_train'].reshape(n_train, -1))
            R_desc, R_d_desc = desc_ops.descriptor_batch(R, n_atoms, lat_and_inv)

        dperms = desc_perm_table(task['perms'])

        # Label vector: raveled forces (optionally energy constraints),
        # normalized by their standard deviation (sgdml/train.py:937-947).
        E_train_mean = None
        y = task['F_train'].ravel().copy()
        if use_E_cstr:
            E_train = np.asarray(task['E_train']).ravel()
            E_train_mean = float(np.mean(E_train))
            y = np.hstack((y, -E_train + E_train_mean))
        y_std = float(np.std(y))
        y = y / y_std

        solver_keys = {}
        if solver == 'analytic':
            log.info('Using analytic solver.')
            analytic = Analytic(self, callback=callback, mesh=self.mesh, max_memory=self._max_memory)
            with timer.phase('solve (analytic: assembly + Cholesky)'):
                alphas = analytic.solve(task, R_desc, R_d_desc, dperms, y)
            solve_times = dict(analytic.timer.durations)
        else:
            log.info('Using iterative solver (Nystrom-preconditioned CG).')
            iterative = Iterative(self, callback=callback, max_memory=self._max_memory, mesh=self.mesh,
                                  factor_slices=factor_slices, device=self.device)
            with timer.phase('solve (iterative: Nystrom-pCG)'):
                (alphas, solver_keys['solver_tol'], solver_keys['solver_iters'], solver_keys['solver_resid'],
                 _, solver_keys['inducing_pts_idxs'], is_conv) = iterative.solve(
                    task, R_desc, R_d_desc, dperms, y, y_std,
                    save_progr_callback=save_progr_callback, max_seconds=solver_max_seconds)
            solver_keys['norm_y_train'] = float(np.linalg.norm(y))
            solve_times = dict(iterative.timer.durations)
            if not is_conv:
                log.warning(
                    'Iterative solver did not converge! Continuing with the unconverged model; its '
                    'accuracy will likely be poor. Tips: (1) are the geometries highly correlated? '
                    '(2) try a larger sigma.'
                )

        alphas_E = None
        alphas_F = alphas
        if use_E_cstr:
            alphas_E, alphas_F = alphas[-n_train:], alphas[:-n_train]

        with timer.phase('model creation'):
            model = self.create_model(task, solver, R_desc, R_d_desc, y_std, alphas_F, alphas_E=alphas_E)
            model.update(solver_keys)

        if model['use_E']:
            with timer.phase('integration constant'):
                model['c'] = (
                    self._recov_int_const(model, task, R_desc, R_d_desc)
                    if E_train_mean is None
                    else E_train_mean
                )
        timer.log_summary(logging.DEBUG)
        self.times = dict(timer.durations, **solve_times, total=timeit.default_timer() - t_start)
        return model

    def _recov_int_const(self, model, task, R_desc, R_d_desc) -> float:
        """Least-squares integration constant + label self-diagnosis
        (reference: sgdml/train.py:1090-1258). The prediction on the
        training set runs on the trainer's device (and mesh): the fused
        (E, F) kernel on a GPU."""
        pred = GDMLPredict(model, mesh=self.mesh, device=self.device)
        pred.set_R_desc(R_desc)
        pred.set_R_d_desc(R_d_desc)

        E_pred, _ = pred.predict()
        E_ref = np.squeeze(np.asarray(task['E_train']))

        e_fact = np.linalg.lstsq(np.column_stack((E_pred, np.ones(E_ref.shape))), E_ref, rcond=-1)[0][0]
        corrcoef = np.corrcoef(E_ref, E_pred)[0, 1]

        if np.sign(e_fact) == -1:
            log.warning(
                'The dataset may contain gradients instead of force labels '
                '(flipped sign). Verify the sign of your force labels.'
            )
        if corrcoef < 0.95:
            log.warning(
                'Potentially inconsistent energy labels detected! Predicted '
                'training energies correlate only weakly with the reference '
                'labels (correlation coefficient %.2f). Check geometry/label '
                'correspondence, force/energy consistency and data spread.',
                corrcoef,
            )
        if np.abs(e_fact - 1) > 1e-1:
            log.warning(
                'Potentially inconsistent scales in energy vs. force labels '
                'detected (ratio ~%.2f). Check units of energy and force labels.',
                e_fact,
            )
        return float(np.sum(E_ref - E_pred) / E_ref.shape[0])

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def draw_strat_sample(self, T, n, excl_idxs=None, rng=None):
        """Energy-stratified sampling with Freedman-Diaconis binning.

        Transcribed step for step from ``sgdml_tpu.train`` (itself the
        reference sampler, sgdml/train.py:1537-1646): seeded splits are
        identical across the packages only while the RNG draws come in the
        same order, so the rebalancing loop must not be re-expressed.
        ``rng``: a ``np.random.RandomState``, or None for the global one.
        """
        rng = np.random if rng is None else rng
        if excl_idxs is None or len(excl_idxs) == 0:
            excl_idxs = None

        if n == 0:
            return np.array([], dtype=np.uint)
        if T.size == n:
            assert excl_idxs is None
            return np.arange(n)
        if n == 1:
            idxs_all_non_excl = np.setdiff1d(np.arange(T.size), excl_idxs, assume_unique=True)
            return np.array([rng.choice(idxs_all_non_excl)])

        # Freedman-Diaconis bin width, bins capped at n/2.
        h = 2 * np.subtract(*np.percentile(T, [75, 25])) / np.cbrt(n)
        n_bins = int(np.ceil((np.max(T) - np.min(T)) / h)) if h > 0 else 1
        n_bins = min(n_bins, int(n / 2))

        bins = np.linspace(np.min(T), np.max(T), n_bins, endpoint=False)
        idxs = np.digitize(T, bins)

        if excl_idxs is not None and excl_idxs.size > 0:
            idxs[excl_idxs] = n_bins + 1  # sentinel bin, removed below

        uniq_all, cnts_all = np.unique(idxs, return_counts=True)
        if excl_idxs is not None and excl_idxs.size > 0:
            excl_bin_idx = np.where(uniq_all == n_bins + 1)
            cnts_all = np.delete(cnts_all, excl_bin_idx)
            uniq_all = np.delete(uniq_all, excl_bin_idx)

        # Proportional per-bin quota, then rebalance to exactly n.
        reduced_cnts = np.ceil(cnts_all / np.sum(cnts_all, dtype=float) * n).astype(int)
        reduced_cnts = np.minimum(reduced_cnts, cnts_all)

        reduced_cnts_delta = n - np.sum(reduced_cnts)
        while np.abs(reduced_cnts_delta) > 0:
            max_bin_reduction = np.min(reduced_cnts[np.where(reduced_cnts > 1)]) - 1
            outstanding = rng.choice(
                uniq_all,
                min(max_bin_reduction, np.abs(reduced_cnts_delta)),
                p=(reduced_cnts - 1) / np.sum(reduced_cnts - 1, dtype=float),
                replace=True,
            )
            uniq_outstanding, cnts_outstanding = np.unique(outstanding, return_counts=True)
            outstanding_bucket_idx = np.where(np.isin(uniq_all, uniq_outstanding, assume_unique=True))[0]
            reduced_cnts[outstanding_bucket_idx] += np.sign(reduced_cnts_delta) * cnts_outstanding
            reduced_cnts_delta = n - np.sum(reduced_cnts)

        idxs_train = np.empty((0,), dtype=int)
        for uniq_idx, bin_cnt in zip(uniq_all, reduced_cnts):
            idx_in_bin_all = np.where(idxs.ravel() == uniq_idx)[0]
            idxs_train = np.append(idxs_train, rng.choice(idx_in_bin_all, bin_cnt, replace=False))
        return idxs_train
