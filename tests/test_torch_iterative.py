"""The port's iterative solver (solvers/iterative.py) and its column assembly
(ops/kernel.py) on the CPU against the JAX package: columns, the Nystrom
factor and its leverage scores, inducing sets, the matvec, the CG chunk,
whole solves (iteration counts and coefficients), seeded randomness, energy
constraints, warm starts and checkpoints, the restart and stagnation
policies, the trainer's solver choice and the routes that are not ported.

Setup: the recipe of tests/test_iterative.py (N=6, 400 frames, seed 4,
M=60, sig 8, lam 1e-10). Tolerances are stated where they are used.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import kernel as jax_kernel
from sgdml_tpu.solvers import iterative as jax_it
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.predict import GDMLPredict, build_tables, center_tables, desc_perm_table, predict_from_tables
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.solvers.analytic import Analytic
from sgdml_tpu_torch.train import GDMLTrain

from torch_mesh_worker import one_rank_world

N_ATOMS = 6
LOGGER = 'sgdml_tpu_torch.solvers.iterative'
PERMS = {1: np.arange(N_ATOMS)[None], 2: np.stack([np.arange(N_ATOMS), np.r_[1, 0, 2, 3, 4, 5]])}


@pytest.fixture(scope='module')
def ds():
    return generate_md_dataset(n_atoms=N_ATOMS, n_frames=400, seed=4)


def _task(ds, n_train, seed, **kw):
    """A task of the port's trainer, split as the JAX package's
    ``np.random.seed(seed)`` would split it."""
    kw = dict(dict(sig=8.0, lam=1e-10, use_sym=False, use_E=True), **kw)
    return GDMLTrain(device='cpu').create_task(ds, n_train, ds, 8, rng=np.random.RandomState(seed), **kw)


def _system(task):
    """Descriptors (torch and numpy), the identity permutation table and the
    normalized labels of a task's force-only system."""
    n_train = task['R_train'].shape[0]
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(task['R_train'].reshape(n_train, -1)), N_ATOMS)
    dperms = np.arange(desc_ops.descriptor_dim(N_ATOMS))[None, :]
    y = task['F_train'].ravel()
    y_std = float(np.std(y))
    return X, Jc, dperms, y / y_std, y_std


def _perms_key(dperms):
    return np.ascontiguousarray(dperms.astype(np.int64)).tobytes(), dperms.shape


def _true_resid(alphas, X, Jc, dperms, task, y):
    tab = it_mod.matvec_tables(X, Jc, dperms)
    r = torch.as_tensor(y) - it_mod._matvec_A(-torch.as_tensor(alphas), tab, float(task['sig']),
                                              float(task['lam']), n_atoms=N_ATOMS, use_E_cstr=False)
    return float(torch.linalg.vector_norm(r))


# -- column assembly, matvec, factor, CG chunk --------------------------------


@pytest.mark.parametrize('use_E_cstr', [False, True])
@pytest.mark.parametrize('n_perms', [1, 2])
def test_assemble_kernel_columns_matches_jax_and_dense(ds, use_E_cstr, n_perms):
    """K[:, cols] (with and without E rows, one and two permutations) equals
    the columns of the port's dense assembly and the JAX package's columns
    (rtol 1e-9), at a ragged row tile."""
    R = ds['R'][:9].reshape(9, -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R), N_ATOMS)
    dperms = desc_perm_table(PERMS[n_perms])
    cols = np.array([0, 17, 55, 100, 143, 161])
    K = kernel_ops.assemble_kernel(X, Jc, dperms, 6.0, N_ATOMS, use_E_cstr=use_E_cstr).numpy()
    K_cols = kernel_ops.assemble_kernel_columns(X, Jc, dperms, 6.0, N_ATOMS, cols, tile_i=4,
                                                use_E_cstr=use_E_cstr).numpy()
    ref = np.asarray(jax_kernel.assemble_kernel_columns(
        jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy()), dperms, 6.0, N_ATOMS, cols, use_E_cstr=use_E_cstr))
    assert K_cols.shape == (9 * 18 + (9 if use_E_cstr else 0), len(cols))
    np.testing.assert_allclose(K_cols, K[:, cols], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(K_cols, ref, rtol=1e-9, atol=1e-12)
    # The tile size changes nothing but the summation grouping.
    whole = kernel_ops.assemble_kernel_columns(X, Jc, dperms, 6.0, N_ATOMS, cols, use_E_cstr=use_E_cstr)
    np.testing.assert_allclose(whole.numpy(), K_cols, rtol=1e-12, atol=1e-15)


def test_column_tile_rows():
    """The staging budget bounds the rows of a column tile; the last tile
    may be ragged, so any count from 1 to M is allowed."""
    per_row = 5 * 3600 * 180 * 8  # P = 1, C = 3600, N = 60: AT-AT width
    assert kernel_ops.column_tile_rows(3000, 3600, 60, 1) == kernel_ops.COLUMN_TILE_BUDGET_BYTES // per_row
    assert kernel_ops.column_tile_rows(3000, 3600, 60, 1, budget=1.5e9) == int(1.5e9 // per_row)
    assert kernel_ops.column_tile_rows(10, 5, 3, 1) == 10
    assert kernel_ops.column_tile_rows(10, 10**9, 60, 1) == 1


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_matvec_matches_center_tables_and_jax(ds, use_E_cstr):
    """The per-solve tables give the bits of center_tables, and A v agrees
    with the JAX package's matvec (rtol 1e-12), P = 2."""
    m = 12
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:m].reshape(m, -1)), N_ATOMS)
    dperms = desc_perm_table(PERMS[2])
    v = np.random.default_rng(0).normal(size=m * 18 + (m if use_E_cstr else 0))
    tab = it_mod.matvec_tables(X, Jc, dperms)

    JA = desc_ops.jac_dot_vec(Jc, torch.as_tensor(v[:m * 18]).reshape(m, 18), N_ATOMS)
    ref = center_tables(*build_tables(X, JA, dperms))
    assert torch.equal(tab.mu, ref.mu) and torch.equal(tab.Xt, ref.Xt) and torch.equal(tab.xt_sq, ref.xt_sq)

    Av = it_mod._matvec_A(torch.as_tensor(v), tab, 5.0, 1e-6, n_atoms=N_ATOMS, use_E_cstr=use_E_cstr)
    aE = None if not use_E_cstr else torch.repeat_interleave(torch.as_tensor(v[-m:]), 2)
    E, F = predict_from_tables(X, Jc, ref, aE, 5.0, 1.0, 0.0, n_atoms=N_ATOMS)
    pred = torch.cat([F.reshape(-1), -E]) if use_E_cstr else F.reshape(-1)
    assert torch.equal(Av, -pred + 1e-6 * torch.as_tensor(v))

    Av_j = np.asarray(jax_it._matvec_A(
        jnp.asarray(v), jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy()), jnp.asarray(X.numpy()),
        jnp.asarray(Jc.numpy()), 5.0, 1e-6, n_atoms=N_ATOMS, desc_perms_key=_perms_key(dperms),
        use_E_cstr=use_E_cstr))
    np.testing.assert_allclose(Av.numpy(), Av_j, rtol=1e-12, atol=1e-12 * np.abs(Av_j).max())


@pytest.fixture(scope='module')
def factor_case(ds):
    """PSD columns of 4 inducing points at M=60 and both packages' factors."""
    task = _task(ds, 60, 21)
    X, Jc, dperms, y, _ = _system(task)
    cols = np.sort(np.random.default_rng(3).choice(60 * 18, 4 * 18, replace=False))
    C = kernel_ops.assemble_kernel_columns(X, Jc, dperms, 8.0, N_ATOMS, cols).neg_()
    C_np = C.numpy().copy()
    F, lev, ok = it_mod._nystrom_factor_from_cols(C, cols, 1e-10, 0.0, 0.0)
    F_j, lev_j, ok_j = jax_it._nystrom_factor_from_cols(jnp.asarray(C_np), cols, 1e-10, 0.0, 0.0)
    assert ok and bool(ok_j)
    return task, X, Jc, dperms, y, F, lev, np.asarray(F_j), np.asarray(lev_j)


def test_nystrom_factor_matches_jax(factor_case):
    """F and the leverage scores of the one-pass f64 build agree with the
    JAX package's (1e-8 of their largest magnitude), and F F^T has the
    spectrum of a Woodbury factor (below 1)."""
    *_, F, lev, F_j, lev_j = factor_case
    assert F.shape == F_j.shape == (72, 60 * 18)
    assert np.abs(F.numpy() - F_j).max() <= 1e-8 * np.abs(F_j).max()
    assert np.abs(lev.numpy() - lev_j).max() <= 1e-8 * np.abs(lev_j).max()
    np.testing.assert_allclose(lev.numpy(), (F * F).sum(0).numpy(), rtol=1e-12)
    assert float(torch.linalg.matrix_norm(F, ord=2)) < 1.0
    fails = it_mod._nystrom_factor_from_cols(-torch.eye(5, dtype=torch.float64), np.arange(5), 1e-10, 0.0, 0.0)
    assert fails == (None, None, False)


@pytest.mark.parametrize('early', [False, True])
def test_pcg_chunk_matches_jax(factor_case, monkeypatch, early):
    """One chunk from the same state: the device-side ``active`` mask counts
    exactly the steps of the JAX package's while-loop, whether the chunk runs
    its 50 steps (tol 1e-4) or converges within them (tol just above the
    lowest residual of its first 25 steps); a converged chunk stops its
    matvecs at the next host read of ``active``."""
    task, X, Jc, dperms, y, F, *_, F_j, _ = factor_case
    sig, lam = 8.0, 1e-10
    b_norm = float(np.linalg.norm(y))
    tab = it_mod.matvec_tables(X, Jc, dperms)
    b = torch.as_tensor(y)
    z = it_mod._factor_apply(F, b) / lam
    zero = torch.zeros((), dtype=torch.int64)
    state = (torch.zeros_like(b), b, z, z, b @ z, zero, torch.zeros(50, dtype=torch.float64), zero)
    Xj, Jcj = jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy())
    state_j = tuple(jnp.asarray(s.numpy()) for s in state[:5]) + (0, jnp.zeros(50), jnp.zeros((), jnp.int32))

    def jax_chunk(rtol):
        return jax_it._pcg_chunk_jit(False)(
            state_j, jnp.asarray(F_j), Xj, Jcj, Xj, Jcj, sig, lam, b_norm, rtol, n_atoms=N_ATOMS,
            desc_perms_key=_perms_key(dperms), use_E_cstr=False, chunk_iters=50, apply_mode='chunk',
            mm='native', mesh=None)

    rtol = 1e-4
    if early:
        rtol = 1.01 * float(np.asarray(jax_chunk(rtol)[6])[:25].min()) / b_norm
    x_j, _, _, _, _, it_j, hist_j, n_bad_j = jax_chunk(rtol)
    matvec, calls = it_mod._matvec_A, []
    monkeypatch.setattr(it_mod, '_matvec_A', lambda *a, **k: calls.append(1) or matvec(*a, **k))
    x, _, _, _, _, it, hist, n_bad = it_mod._pcg_chunk(state, F, tab, sig, lam, b_norm, rtol, n_atoms=N_ATOMS,
                                                       use_E_cstr=False, chunk_iters=50)
    assert int(it) == int(it_j) and int(n_bad) == int(n_bad_j)
    assert (int(it) < 25) == early
    every = it_mod.CG_ACTIVE_READ_ITERS
    assert len(calls) == (-(-int(it) // every) * every if early else 50)
    # With 4 of 60 points the preconditioned system is still ill-conditioned
    # (lam = 1e-10): rounding differences grow along the chunk, so the
    # residual histories agree to 1e-6 over the first 10 steps and to 5% over
    # the chunk, and so do the iterates.
    hist, hist_j = hist.numpy(), np.asarray(hist_j)
    np.testing.assert_allclose(hist[:10], hist_j[:10], rtol=1e-6)
    np.testing.assert_allclose(hist, hist_j, rtol=5e-2)
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x.numpy() - x_j) <= 5e-2 * np.linalg.norm(x_j)


# -- whole solves -------------------------------------------------------------


@pytest.fixture(scope='module')
def models(ds):
    """The recipe trained by the port (analytic and CG) and by the JAX
    package (CG), at the default budget and at 0.01 GB (k below M)."""
    task = _task(ds, 60, 21)
    out = {'task': task, 'analytic': GDMLTrain(device='cpu').train(dict(task), solver='analytic')}
    for mem in (None, 0.01):
        trainer = GDMLTrain(max_memory=mem, device='cpu')
        out['cg', mem] = trainer.train(dict(task), solver='cg')
        out['times', mem] = trainer.times
        out['jax', mem] = JaxTrain(max_memory=mem).train(dict(task), solver='cg')
    return out


@pytest.mark.parametrize('mem', [None, 0.01])
def test_solve_matches_jax(models, mem):
    """Same inducing set, same iteration count, coefficients and constant
    within the CG tolerance's reach (alphas 1e-3 of max |alpha|, c 1e-5
    relative), converged, and the solve's phases in ``times``."""
    m, ref = models['cg', mem], models['jax', mem]
    np.testing.assert_array_equal(m['inducing_pts_idxs'], ref['inducing_pts_idxs'])
    assert m['solver_iters'] == ref['solver_iters']
    assert (len(m['inducing_pts_idxs']) < 60 * 18) == (mem == 0.01)
    assert m['solver_resid'] <= m['solver_tol'] * m['norm_y_train']
    a_ref = np.asarray(ref['alphas_F'])
    assert np.abs(m['alphas_F'] - a_ref).max() <= 1e-3 * np.abs(a_ref).max()
    np.testing.assert_allclose(m['c'], ref['c'], rtol=1e-5)
    for key in ('solver_tol', 'norm_y_train'):
        np.testing.assert_allclose(m[key], ref[key], rtol=1e-12)
    assert m['solver_name'] == 'cg'
    times = models['times', mem]
    assert all(times[k] > 0 for k in ('leverage scores', 'factor', 'cg', 'total'))


def test_cg_matches_analytic_predictions(ds, models):
    """tests/test_iterative.py's bounds: mean force difference / mean |F| <
    5e-3, centered energies < 1e-2, held-out force MAE < 8% of the scale."""
    task = models['task']
    ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:40]
    R_test = ds['R'][ti].reshape(len(ti), -1)
    Ea, Fa = GDMLPredict(models['analytic'], device='cpu').predict(R_test)
    Ec, Fc = GDMLPredict(models['cg', None], device='cpu').predict(R_test)
    assert np.abs(Fc - Fa).mean() / np.abs(Fa).mean() < 5e-3
    assert np.abs((Ec - Ec.mean()) - (Ea - Ea.mean())).mean() < 1e-2
    f_ref = ds['F'][ti].reshape(len(ti), -1)
    assert np.abs(Fc - f_ref).mean() < 0.08 * np.abs(f_ref).mean()


def test_inducing_sets_and_leverage_scores_match_jax(ds):
    """Leverage scores of the column probe within 1e-8 of the JAX package's,
    and the same leverage-weighted sample from the same generator."""
    task = _task(ds, 40, 61)
    X, Jc, dperms, _, _ = _system(task)
    ours = it_mod.Iterative(device='cpu')._lev_scores(X, Jc, dperms, 8.0, 1e-10, 5, N_ATOMS, False, 7)
    ref = jax_it.Iterative()._lev_scores(jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy()), dperms, 8.0, 1e-10,
                                         5, N_ATOMS, False, 7)
    assert np.abs(ours - ref).max() <= 1e-8 * np.abs(ref).max()
    for seed in range(5):
        np.testing.assert_array_equal(it_mod.Iterative.inducing_pts_from_lev_scores(ours, 90, seed),
                                      jax_it.Iterative.inducing_pts_from_lev_scores(ref, 90, seed))


def test_cg_solver_randomness_is_seeded(ds):
    """Two solves with the global RNG scrambled differently give the same
    inducing set, iteration count and bits (tests/test_iterative.py:402-448);
    an explicit seed gives another set."""
    task = _task(ds, 40, 61)
    X, Jc, dperms, y, y_std = _system(task)
    outs = []
    for scramble in (123, 99999):
        np.random.seed(scramble)
        outs.append(it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=0.01).solve(
            task, X, Jc, dperms, y, y_std))
    (a1, _, it1, _, _, idx1, _), (a2, _, it2, _, _, idx2, _) = outs
    np.testing.assert_array_equal(idx1, idx2)
    assert it1 == it2 and torch.equal(a1, a2)
    out3 = it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=0.01, seed=7).solve(
        task, X, Jc, dperms, y, y_std)
    assert not np.array_equal(out3[5], idx1)


def test_cg_with_energy_constraints(ds):
    """E-constrained CG against the port's analytic model
    (tests/test_iterative.py:496-518 bounds) and against the JAX package's
    CG model: iteration counts within 5% or 2 (rounding differs from XLA's
    on this ill-conditioned system), mean force difference within 1e-4 of
    the mean |F|."""
    task = _task(ds, 40, 31, use_E_cstr=True)
    m_a = GDMLTrain(device='cpu').train(dict(task), solver='analytic')
    m_c = GDMLTrain(device='cpu').train(dict(task), solver='cg')
    m_j = JaxTrain().train(dict(task), solver='cg')
    assert 'alphas_E' in m_c and m_c['alphas_E'].shape == (40,)
    assert abs(m_c['solver_iters'] - m_j['solver_iters']) <= max(2, 0.05 * m_j['solver_iters'])
    ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:30]
    R_test = ds['R'][ti].reshape(len(ti), -1)
    Ea, Fa = GDMLPredict(m_a, device='cpu').predict(R_test)
    Ec, Fc = GDMLPredict(m_c, device='cpu').predict(R_test)
    assert np.abs(Fc - Fa).mean() / np.abs(Fa).mean() < 1e-2
    assert np.abs(Ec - Ea).mean() < 5e-2
    _, Fj = GDMLPredict(m_j, device='cpu').predict(R_test)
    assert np.abs(Fc - Fj).mean() <= 1e-4 * np.abs(Fj).mean()


@pytest.mark.parametrize('through_npz', [False, True])
def test_resume_warm_start(ds, models, tmp_path, monkeypatch, through_npz):
    """A converged model resumes and converges at once (:57-68); an
    unconverged checkpoint written with np.savez_compressed round-trips
    (:521), and the rung 'ozaki' that a checkpoint stores resumes at
    'ozaki', as the JAX package's does (iterative.py:1459-1460)."""
    model = dict(models['cg', None])
    if through_npz:
        model.update(solver_iters=7, solver_resid=123.0, solver_mv_mm='ozaki')
        np.savez_compressed(tmp_path / 'ckpt.npz', **model)
        model = dict(np.load(tmp_path / 'ckpt.npz', allow_pickle=True))
    chunk, rungs = it_mod._pcg_chunk, []
    monkeypatch.setattr(it_mod, '_pcg_chunk', lambda *a, **k: rungs.append(k['mm']) or chunk(*a, **k))
    trainer = GDMLTrain(device='cpu')
    resumed = trainer.create_task_from_model(model, ds)
    assert 'alphas0_F' in resumed
    m2 = trainer.train(resumed, solver='cg')
    assert m2['solver_iters'] - int(model['solver_iters']) <= 5
    assert m2['solver_resid'] <= m2['solver_tol'] * m2['norm_y_train']
    np.testing.assert_array_equal(m2['inducing_pts_idxs'], model['inducing_pts_idxs'])
    assert 'leverage scores' not in trainer.times  # the stored set was reused
    assert rungs and set(rungs) == {'ozaki' if through_npz else 'native'}


def test_cg_warm_start_size_mismatch_falls_back(ds, caplog):
    """Warm-start coefficients of the wrong length are ignored with a
    warning (:758), and the solve converges cold."""
    task = _task(ds, 30, 34)
    task['alphas0_F'] = np.zeros(17)
    with caplog.at_level(logging.WARNING):
        m = GDMLTrain(device='cpu').train(task, solver='cg')
    assert m['solver_resid'] <= m['solver_tol'] * m['norm_y_train']
    assert any('warm-start' in r.message.lower() for r in caplog.records)


def test_cg_e_cstr_checkpoint_and_resume(ds, monkeypatch):
    """E-constrained checkpoints split alphas_F / alphas_E and carry the
    constant (:721); the resume rebuilds x0 from both blocks."""
    monkeypatch.setattr(it_mod, 'CHECKPOINT_INTERVAL_S', 0.0)
    monkeypatch.setattr(it_mod, 'CG_CHUNK_ITERS', 5)
    trainer = GDMLTrain(max_memory=0.005, device='cpu')
    task = _task(ds, 40, 33, use_E_cstr=True)
    saved = []
    m = trainer.train(dict(task), solver='cg', save_progr_callback=saved.append)
    assert saved, 'periodic checkpoint never fired'
    ck = saved[-1]
    assert ck['alphas_F'].shape == (40 * 18,) and ck['alphas_E'].shape == (40,)
    assert ck['solver_mv_mm'] == 'native' and np.isfinite(ck['c'])
    resumed = trainer.create_task_from_model(m, ds)
    assert 'alphas0_F' in resumed and 'alphas0_E' in resumed
    m2 = trainer.train(resumed, solver='cg')
    assert m2['solver_iters'] - m['solver_iters'] <= 10
    assert m2['solver_resid'] <= m2['solver_tol'] * m2['norm_y_train']


# -- restart and stagnation policies (tests/test_iterative.py:71-400) ---------


def _stall_solve(ds, monkeypatch, max_memory, seed, warm_k=None, max_seconds=None, tol=0.0,
                 chunk=5, hist_len=4, thresh=100):
    """A solve whose effectiveness monitor reports a stall after every chunk
    (threshold forced to 100) with an unreachable tolerance, so the restart
    machinery must fire and end it."""
    monkeypatch.setattr(it_mod, 'CG_STEPS_HIST_LEN', hist_len)
    monkeypatch.setattr(it_mod, 'EFF_RESTART_THRESH', thresh)
    monkeypatch.setattr(it_mod, 'CG_CHUNK_ITERS', chunk)
    task = _task(ds, 24, seed)
    if warm_k is not None:
        rng = np.random.default_rng(0)
        task['inducing_pts_idxs'] = rng.choice(24 * 18, warm_k * 18, replace=False)
    X, Jc, dperms, y, y_std = _system(task)
    solver = it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=max_memory)
    return task, (X, Jc, dperms, y), solver.solve(task, X, Jc, dperms, y, y_std, tol=tol,
                                                   max_seconds=max_seconds)


def test_cg_restart_grows_k_and_terminates(ds, monkeypatch, caplog):
    """Below the cap, stalls grow k 1.2x per restart and the solve exits
    after MAX_NUM_RESTARTS (:118)."""
    monkeypatch.setattr(it_mod, 'MAX_NUM_RESTARTS', 3)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        _, _, out = _stall_solve(ds, monkeypatch, 0.005, 41, warm_k=4)
    alphas, _, num_iters, _, _, ind_idxs, is_conv = out
    assert not is_conv and torch.isfinite(alphas).all()
    assert num_iters <= 5 * 5
    assert any('restarting with k=' in r.message for r in caplog.records)
    k_cap = it_mod.Iterative.max_n_inducing_pts(24, N_ATOMS, 0.005 * 1024**3)
    assert 4 < len(ind_idxs) // 18 <= k_cap


def test_cg_restart_bounded_at_memory_cap(ds, monkeypatch, caplog):
    """At the cap with no wall budget the stagnation policy runs (re-seed,
    then the deep-stagnation bound), never the counted give-up (:144)."""
    monkeypatch.setattr(it_mod, 'RESEED_STAGNATION_ITERS', 0)
    monkeypatch.setattr(it_mod, 'MAX_NUM_RESTARTS', 3)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        _, _, out = _stall_solve(ds, monkeypatch, 0.02, 41)
    assert not out[6] and torch.isfinite(out[0]).all()
    assert any('memory cap' in r.message for r in caplog.records)
    assert any('deep-stagnation' in r.message for r in caplog.records)
    assert not any('stalled 3 times' in r.message for r in caplog.records)


def test_cg_budgeted_reseeds_not_counted_against_restarts(ds, monkeypatch, caplog):
    """With a wall budget, re-seeds at the cap are not counted against
    MAX_NUM_RESTARTS (:174): more re-seeds than the bound. The budget is
    ample, so the solve runs to its iteration limit (30 N M) whatever the
    machine's speed, re-seeding each time its best residual stagnates."""
    monkeypatch.setattr(it_mod, 'MAX_NUM_RESTARTS', 2)
    monkeypatch.setattr(it_mod, 'RESEED_STAGNATION_ITERS', 0)
    monkeypatch.setattr(it_mod.Iterative, 'max_n_inducing_pts', staticmethod(lambda *a, **k: 3))
    with caplog.at_level(logging.INFO, logger=LOGGER):
        _, _, out = _stall_solve(ds, monkeypatch, 0.02, 44, max_seconds=600.0)
    reseeds = [r for r in caplog.records if 'memory cap' in r.message]
    assert len(reseeds) >= 2 and out[2] == 3 * N_ATOMS * 24 * 10
    assert not any('stalled 2 times' in r.message for r in caplog.records)


def test_cg_deep_stagnation_terminates(ds, monkeypatch, caplog):
    """With the iterate corrupted after every chunk the best residual never
    improves: one re-seed, then the deep-stagnation bound ends the solve
    long before the wall budget (:237)."""
    chunk = it_mod._pcg_chunk

    def floored(*a, **k):
        x, *rest = chunk(*a, **k)
        return (x * 1.02, *rest)

    monkeypatch.setattr(it_mod, '_pcg_chunk', floored)
    monkeypatch.setattr(it_mod, 'RESEED_STAGNATION_ITERS', 0)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        _, _, out = _stall_solve(ds, monkeypatch, 0.02, 45, max_seconds=8.0)
    assert torch.isfinite(out[0]).all()
    assert any('deep-stagnation' in r.message for r in caplog.records)
    assert not any('budget' in r.message for r in caplog.records)


def test_cg_oscillation_keeps_krylov_space(ds, monkeypatch, caplog):
    """While the best residual improves, monitor stalls do not re-seed a
    budgeted solve at the cap; the budget ends it (:357)."""
    with caplog.at_level(logging.INFO, logger=LOGGER):
        _, _, out = _stall_solve(ds, monkeypatch, 0.02, 46, max_seconds=1.5)
    assert torch.isfinite(out[0]).all()
    assert not any('memory cap' in r.message for r in caplog.records)
    assert any('budget' in r.message for r in caplog.records)


@pytest.mark.parametrize('scale', [1.1, 0.5])
def test_cg_residual_replacement_recovers_from_drift(ds, monkeypatch, caplog, scale):
    """A recursive residual corrupted between chunks (up: must not stall;
    down: must not declare false convergence) is re-anchored at the truth,
    and the returned residual is the true one (:547; 5% bounds)."""
    chunk = it_mod._pcg_chunk

    def drifting(*a, **k):
        x, r, z, p, rz, it, hist, n_bad = chunk(*a, **k)
        return x, r * scale, z, p, rz, it, hist * scale, n_bad

    monkeypatch.setattr(it_mod, '_pcg_chunk', drifting)
    monkeypatch.setattr(it_mod, 'CG_CHUNK_ITERS', 10)
    task = _task(ds, 30, 51)
    X, Jc, dperms, y, y_std = _system(task)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        alphas, tol, _, resid, _, _, is_conv = it_mod.Iterative(GDMLTrain(device='cpu')).solve(
            task, X, Jc, dperms, y, y_std)
    assert is_conv
    assert any('residual replacement' in r.message for r in caplog.records)
    assert not any('stalled' in r.message for r in caplog.records)
    true_resid = _true_resid(alphas, X, Jc, dperms, task, y)
    assert true_resid <= 1.05 * tol * float(np.linalg.norm(y))
    assert abs(true_resid - resid) <= 0.05 * max(true_resid, 1e-12)


# -- solver choice, memory model, routes that are not ported ------------------


def _jax_choice(n_train, n_atoms, budget, use_E_cstr):
    from sgdml_tpu.solvers.analytic import Analytic as JaxAnalytic

    dense = JaxAnalytic.est_memory_requirement(n_train, n_atoms, use_E_cstr) < budget
    return 'analytic' if dense or JaxAnalytic.est_memory_grid(n_train, n_atoms) < budget else 'cg'


@pytest.mark.parametrize('max_memory,expect', [(None, 'analytic'), (1e-3, 'grid'), (1e-4, 'cg')])
def test_solver_none_follows_the_jax_rule(ds, max_memory, expect):
    """solver=None: dense fits -> analytic, dense route; where only the f32
    grid route fits -> analytic, grid route (item 12a), as the JAX package
    chooses; else CG. The budget is memory_budget(device) by default."""
    task = _task(ds, 24, 41)
    budget = 12 * 1024**3 if max_memory is None else max_memory * 1024**3
    dense = Analytic.est_memory_requirement(24, N_ATOMS) < budget
    assert _jax_choice(24, N_ATOMS, budget, False) == ('cg' if expect == 'cg' else 'analytic')
    assert dense == (expect == 'analytic')
    trainer = GDMLTrain(max_memory=max_memory, device='cpu')
    model = trainer.train(task)
    assert model['solver_name'] == ('cg' if expect == 'cg' else 'analytic')
    assert ('solver_iters' in model) == (expect == 'cg')
    assert ('lmax' in trainer.times) == (expect == 'grid')


def test_memory_model_matches_jax():
    for args in [(60, 6, 12 * 1024**3), (200, 9, 0.1 * 1024**3), (200, 9, 0.75 * 1024**3),
                 (1000, 21, 79e9), (3000, 60, 79e9)]:
        assert it_mod.Iterative.max_n_inducing_pts(*args) == jax_it.Iterative.max_n_inducing_pts(*args), args
    assert it_mod.Iterative.max_n_inducing_pts(200, 9, 0.1 * 1024**3) == 18
    assert it_mod.Iterative.max_n_inducing_pts(3000, 60, 79e9) == 20
    assert it_mod.Iterative.est_memory_requirement(1000, 40, 21) == \
        jax_it.Iterative.est_memory_requirement(1000, 40, 21)
    for args in [(24, 6), (1000, 21), (3000, 60)]:
        assert Analytic.est_memory_grid(*args) == \
            __import__('sgdml_tpu.solvers.analytic', fromlist=['Analytic']).Analytic.est_memory_grid(*args)


def test_routes_that_are_not_ported_raise(monkeypatch):
    """The slice stack on a mesh constructs and runs (a one-rank world: the
    column-sharded stack, with the single device's inducing points and
    iterations within 3); a mesh that is not a DeviceMesh raises; the factor
    modes and slice counts are the JAX package's: 'ozaki' takes the slice
    stack, 'auto' the f64 factor (as the JAX package off a TPU), the slice
    count from the argument, else SGDML_FACTOR_SLICES, else 'auto'."""
    monkeypatch.delenv('SGDML_FACTOR_SLICES', raising=False)
    for mode in ('auto', 'f64', 'ozaki'):
        ours, ref = it_mod.Iterative(factor_mode=mode, device='cpu'), jax_it.Iterative(factor_mode=mode)
        assert ours._use_ozaki_factor() == ref._use_ozaki_factor() == (mode == 'ozaki')
        assert ours.factor_slices == ref.factor_slices == 'auto' and ours._ns() == ref._ns() == 8
    monkeypatch.setenv('SGDML_FACTOR_SLICES', '6')
    assert it_mod.Iterative(device='cpu').factor_slices == jax_it.Iterative().factor_slices == 6
    assert it_mod.Iterative(factor_slices=8, device='cpu')._ns() == 8
    task = _task(generate_md_dataset(n_atoms=N_ATOMS, n_frames=60, seed=5), 12, 3, lam=1e-6)
    X, Jc, dperms, y, _ = _system(task)
    one = it_mod.Iterative(factor_mode='ozaki', device='cpu').solve(task, X, Jc, dperms, y, 1.0)
    with one_rank_world() as mesh:
        solver = it_mod.Iterative(mesh=mesh, factor_mode='ozaki', device='cpu')
        alphas, _, iters, _, _, idxs, conv = solver.solve(task, X, Jc, dperms, y, 1.0)
    assert conv and one[6] and abs(iters - one[2]) <= 3
    np.testing.assert_array_equal(idxs, one[5])
    assert float((alphas - one[0]).norm() / one[0].norm()) < 1e-2
    with pytest.raises(TypeError, match='DeviceMesh'):
        it_mod.Iterative(mesh=object(), factor_mode='ozaki', device='cpu')
    with pytest.raises(TypeError, match='DeviceMesh'):
        it_mod.Iterative(mesh=object(), device='cpu')
    with pytest.raises(ValueError):
        it_mod.Iterative(factor_mode='f32', device='cpu')
    with pytest.raises(ValueError, match='factor_slices'):
        it_mod.Iterative(factor_slices=2, device='cpu')
    for slices in (None, 'auto', 3, 10):
        assert it_mod.Iterative(factor_mode='f64', factor_slices=slices, device='cpu').factor_mode == 'f64'
    assert it_mod.Iterative(GDMLTrain(device='cpu')).device == torch.device('cpu')
    monkeypatch.setenv('SGDML_FACTOR_SLICES', '11')
    with pytest.raises(ValueError, match='factor_slices'):
        it_mod.Iterative(device='cpu')


# -- the int8 slice-stack route (tests/test_iterative.py:292-340, 620-713) ----


def _ozaki_budget_gb(m, k):
    """The budget in GB at which the streamed 8-slice plan affords k points
    of an M-point, 6-atom system: 72% of it less 1.5 GB holds 9 bytes per
    element of the (k 18, M 18) stack."""
    return (1.5e9 + k * 9.0 * m * 18 * 18 + 1) / 0.72 / 1024**3


@pytest.mark.parametrize('slices', [8, 'auto'])
def test_ozaki_solve_matches_jax(ds, slices):
    """factor_mode='ozaki' against the JAX package's at a budget that affords
    5 points at 8 slices and 6 at 6 ('auto' picks 6, so the stack is
    renormalized): the same inducing set, iteration counts within 2,
    coefficients within 1e-5 of max |alpha|, and the true residual converged.
    lam 1e-6: at 1e-10 both packages' counts move by tens of percent with
    the last bits of the matvec (the 6-slice rung's drift sets off residual
    replacements at other iterations)."""
    task = _task(ds, 40, 61, lam=1e-6)
    X, Jc, dperms, y, _ = _system(task)
    mem = _ozaki_budget_gb(40, 5)
    solver = it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=mem, factor_mode='ozaki', factor_slices=slices,
                              device='cpu')
    alphas, tol, iters, resid, _, idxs, conv = solver.solve(task, X, Jc, dperms, y, 1.0)
    ref = jax_it.Iterative(JaxTrain(), max_memory=mem, factor_mode='ozaki', factor_slices=slices).solve(
        task, X.numpy(), Jc.numpy(), dperms, y, 1.0)
    assert solver._ns() == (8 if slices == 8 else 6)
    np.testing.assert_array_equal(idxs, ref[5])
    assert len(idxs) // 18 == (5 if slices == 8 else 6)
    assert conv and ref[6] and abs(iters - ref[2]) <= 2
    assert np.abs(alphas.numpy() - ref[0]).max() <= 1e-5 * np.abs(ref[0]).max()
    assert _true_resid(alphas, X, Jc, dperms, task, y) <= 1.05 * tol * np.linalg.norm(y)


def test_cg_matvec_precision_ladder_escapes_floor(ds, monkeypatch, caplog):
    """tests/test_iterative.py:292-340: a matvec rung that floors the
    residual (simulated by corrupting the iterate 2% per chunk on the first
    rung only) must climb MV_MM_LADDER after a barren re-seed, and the solve
    must then truly converge."""
    chunk, rungs = it_mod._pcg_chunk, []

    def rung_limited(*a, **k):
        rungs.append(k['mm'])
        x, *rest = chunk(*a, **k)
        return (x * 1.02 if k['mm'] == 'ozaki' else x, *rest)

    monkeypatch.setattr(it_mod, '_pcg_chunk', rung_limited)
    monkeypatch.setattr(it_mod, 'CG_CHUNK_ITERS', 10)
    monkeypatch.setattr(it_mod, 'CG_STEPS_HIST_LEN', 10)
    monkeypatch.setattr(it_mod, 'RESEED_STAGNATION_ITERS', 0)
    task = _task(ds, 30, 47)
    X, Jc, dperms, y, _ = _system(task)
    solver = it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=_ozaki_budget_gb(30, 6), factor_mode='ozaki',
                              device='cpu')
    with caplog.at_level(logging.INFO, logger=LOGGER):
        alphas, tol, _, _, _, _, conv = solver.solve(task, X, Jc, dperms, y, 1.0, max_seconds=300.0)
    assert any('escalating' in r.message for r in caplog.records)
    assert rungs[0] == 'ozaki' and rungs[-1] != 'ozaki' and conv
    assert _true_resid(alphas, X, Jc, dperms, task, y) <= 1.05 * tol * np.linalg.norm(y)
