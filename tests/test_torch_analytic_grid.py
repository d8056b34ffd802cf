"""The port's f32 block-grid analytic route (solvers/analytic.py) on the CPU
against the JAX package: lmax by power iteration, the energy-constraint
border blocks, the lam' ladder through a failed factorization, whole grid
solves with and without energy constraints, the refinement CG's chunking
and failure modes, the route choice and ``GDMLTrain.train`` in the grid
region (tests/test_analytic_grid.py's inputs: N=5, M=20, sig 4, lam 1e-10).
Tolerances are stated where they are used.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import blockchol as jax_bc
from sgdml_tpu.solvers import analytic as jax_an
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import blockchol as bc
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.predict import GDMLPredict, desc_perm_table
from sgdml_tpu_torch.solvers import analytic as an
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.train import GDMLTrain

N_ATOMS, M, SIG, LAM = 5, 20, 4.0, 1e-10
LOGGER = 'sgdml_tpu_torch.solvers.analytic'
PERMS = {1: np.arange(N_ATOMS)[None], 2: np.stack([np.arange(N_ATOMS), np.r_[1, 0, 2, 3, 4]])}


def _key(dperms):
    return np.ascontiguousarray(dperms.astype(np.int64)).tobytes(), dperms.shape


def _system(n_perms=1, use_E_cstr=False, m=M, seed=3):
    """Descriptors (torch), the permutation table and normalized labels of
    the recipe's first ``m`` frames (forces, then centered energies)."""
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=m + 4, seed=seed)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:m].reshape(m, -1)), N_ATOMS)
    y = ds['F'][:m].reshape(-1)
    if use_E_cstr:
        y = np.hstack([y, -ds['E'][:m] + np.mean(ds['E'][:m])])
    return X, Jc, desc_perm_table(PERMS[n_perms]), y / np.std(y)


def _jax_v0(n):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), dtype=jnp.float64))


def _jax_lmax(X, Jc, dperms, use_E_cstr=False):
    return float(jax_an._lmax_power(jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy()), SIG, LAM, n_atoms=N_ATOMS,
                                    desc_perms_key=_key(dperms), use_E_cstr=use_E_cstr))


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_lmax_power_matches_jax(use_E_cstr):
    """With the JAX package's start vector: 1e-12 relative; with the port's
    own (a CPU generator seeded 0): power-iteration accuracy, 1%."""
    X, Jc, dperms, _ = _system(2)
    ref = _jax_lmax(X, Jc, dperms, use_E_cstr)
    tab = it_mod.matvec_tables(X, Jc, dperms)
    n = M * 3 * N_ATOMS + (M if use_E_cstr else 0)
    ours = an._lmax_power(tab, SIG, LAM, n_atoms=N_ATOMS, use_E_cstr=use_E_cstr, v0=_jax_v0(n))
    assert abs(ours - ref) <= 1e-12 * ref
    own = an._lmax_power(tab, SIG, LAM, n_atoms=N_ATOMS, use_E_cstr=use_E_cstr)
    assert abs(own - ref) <= 1e-2 * ref
    assert own == an._lmax_power(tab, SIG, LAM, n_atoms=N_ATOMS, use_E_cstr=use_E_cstr)


@pytest.mark.parametrize('n_perms', [1, 2])
def test_border_blocks_match_jax(n_perms):
    """``_assemble_fe_A`` and ``_assemble_ee_A`` at tiles that do not divide
    M: 1e-12 of max |value|."""
    X, Jc, dperms, _ = _system(n_perms)
    jX, jJc = jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy())
    fe = an._assemble_fe_A(X, Jc, SIG, dperms, N_ATOMS, tile=7).numpy()
    ee = an._assemble_ee_A(X, SIG, 3e-7, dperms, tile=6).numpy()
    fe_ref = np.asarray(jax_an._assemble_fe_A(jX, jJc, SIG, desc_perms_key=_key(dperms), n_atoms=N_ATOMS))
    ee_ref = np.asarray(jax_an._assemble_ee_A(jX, SIG, 3e-7, desc_perms_key=_key(dperms)))
    assert fe.shape == (M * 3 * N_ATOMS, M) and ee.shape == (M, M)
    assert np.abs(fe - fe_ref).max() <= 1e-12 * np.abs(fe_ref).max()
    assert np.abs(ee - ee_ref).max() <= 1e-12 * np.abs(ee_ref).max()


def _forces(alphas, X, Jc, dperms, use_E_cstr):
    """Predicted training forces ``K alphas`` through the matrix-free matvec
    at lam = 0 (the ridge term cancels in a comparison)."""
    tab = it_mod.matvec_tables(X, Jc, dperms)
    out = it_mod._matvec_A(-torch.as_tensor(alphas), tab, SIG, 0.0, n_atoms=N_ATOMS, use_E_cstr=use_E_cstr)
    return out[:M * 3 * N_ATOMS].numpy()


def _solve_both(X, Jc, dperms, y, use_E_cstr, lmax):
    task = {'sig': SIG, 'lam': LAM, 'use_E_cstr': use_E_cstr}
    ours = an.Analytic()
    alphas = ours._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=lmax)
    ref = jax_an.Analytic()
    ref_alphas = ref._solve_grid_pcg(task, X.numpy(), Jc.numpy(), dperms, y, SIG, LAM, N_ATOMS, lmax=lmax)
    return ours, alphas, ref, ref_alphas


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_grid_pcg_matches_jax(use_E_cstr):
    """The same lmax on both sides: predicted forces 1e-7 relative, alphas
    1e-3 relative (the ill-conditioned object), refinement iterations
    within 10% or 3; both against the dense f64 solve too."""
    X, Jc, dperms, y = _system(1, use_E_cstr)
    lmax = _jax_lmax(X, Jc, dperms, use_E_cstr)
    ours, alphas, ref, ref_alphas = _solve_both(X, Jc, dperms, y, use_E_cstr, lmax)
    assert alphas.dtype == torch.float64 and alphas.shape == y.shape
    assert ours.lmax == lmax and ours.lam_p_used == max(LAM, 3e-7 * lmax) and ours.rungs == [(ours.lam_p_used, 0)]
    assert abs(ours.pcg_iters - ref.pcg_iters) <= max(0.1 * ref.pcg_iters, 3), (ours.pcg_iters, ref.pcg_iters)
    dense = an.Analytic().solve({'sig': SIG, 'lam': LAM, 'use_E_cstr': use_E_cstr}, X, Jc, dperms, y).numpy()
    f = _forces(alphas, X, Jc, dperms, use_E_cstr)
    for other in (ref_alphas, dense):
        f_ref = _forces(other, X, Jc, dperms, use_E_cstr)
        assert np.linalg.norm(f - f_ref) / np.linalg.norm(f_ref) < 1e-7
        assert np.linalg.norm(alphas.numpy() - other) / np.linalg.norm(other) < 1e-3
    phases = {'lmax', 'assembly', 'factor', 'cg'} | ({'border'} if use_E_cstr else set())
    assert set(ours.timer.durations) == phases - {'lmax'}  # lmax was given
    assert ours.t_solve == ours.timer.durations['cg'] and ours.t_assemble > 0


def test_ladder_climbs_to_the_jax_rung(monkeypatch):
    """The first rung's grid made indefinite on both sides: the JAX factor
    shows it as NaNs, the port's through ``info``; both ladders take the
    second rung, the same lam' (counted by wrapping chol_grid)."""
    X, Jc, dperms, y = _system(1)
    lmax = _jax_lmax(X, Jc, dperms)
    calls = {'ours': [], 'jax': []}
    ours_chol, jax_chol, jax_add = bc.chol_grid, jax_bc.chol_grid, jax_bc.grid_diag_add
    jax_shifts = []

    def ours(G):
        if not calls['ours']:
            G[0][0].diagonal().sub_(1e3)
        L, info = ours_chol(G)
        calls['ours'].append(info)
        return L, info

    def theirs(G, *a, **k):
        if not calls['jax']:
            G = [list(row) for row in G]
            G[0][0] = G[0][0] - 1e3 * jnp.eye(G[0][0].shape[0], dtype=G[0][0].dtype)
        L = jax_chol(G, *a, **k)
        calls['jax'].append(bool(jax_bc.grid_isfinite(L)))
        return L

    def add(G, delta):
        jax_shifts.append(float(delta))
        return jax_add(G, delta)

    monkeypatch.setattr(bc, 'chol_grid', ours)
    monkeypatch.setattr(jax_bc, 'chol_grid', theirs)
    monkeypatch.setattr(jax_bc, 'grid_diag_add', add)
    solver, alphas, _, ref_alphas = _solve_both(X, Jc, dperms, y, False, lmax)
    assert calls['jax'] == [False, True]
    assert len(calls['ours']) == 2 and calls['ours'][0] > 0 and calls['ours'][1] == 0
    assert [r[0] for r in solver.rungs] == pytest.approx(jax_shifts, rel=1e-7)
    assert solver.lam_p_used == pytest.approx(3e-6 * lmax, rel=1e-12)
    f, f_ref = _forces(alphas, X, Jc, dperms, False), _forces(ref_alphas, X, Jc, dperms, False)
    assert np.linalg.norm(f - f_ref) / np.linalg.norm(f_ref) < 1e-7


def test_pcg_chunks_do_not_change_the_iterates(monkeypatch):
    """Chunks of 7 iterations (host reads between them) give the iterations
    and the coefficients of chunks of 250, bit for bit."""
    X, Jc, dperms, y = _system(1)
    lmax = _jax_lmax(X, Jc, dperms)
    task = {'sig': SIG, 'lam': LAM}
    a = an.Analytic()
    x250 = a._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=lmax)
    monkeypatch.setattr(an, 'PCG_CHUNK_ITERS', 7)
    b = an.Analytic()
    x7 = b._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=lmax)
    assert a.pcg_iters == b.pcg_iters > 7
    np.testing.assert_array_equal(x7.numpy(), x250.numpy())


@pytest.mark.parametrize('fault', ['every rung', 'first chunk', 'second chunk', 'max iterations'])
def test_grid_failure_modes(monkeypatch, caplog, fault):
    """The ladder exhausted and a CG breakdown before any finite iterate
    raise; a later breakdown returns the best finite iterate, and a stop
    above 1e-6 warns."""
    X, Jc, dperms, y = _system(1)
    task = {'sig': SIG, 'lam': LAM}
    if fault == 'every rung':
        monkeypatch.setattr(bc, 'chol_grid', lambda G: (G, 1))
        with pytest.raises(RuntimeError, match='f32 block Cholesky failed'):
            an.Analytic()._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=2.0)
        return
    chunk, calls = an._pcg_chol, []
    monkeypatch.setattr(an, 'PCG_CHUNK_ITERS', 20)

    def faulty(*a, **k):
        calls.append(1)
        state, resid = chunk(*a, **k)
        if fault == 'max iterations' or len(calls) < (1 if fault == 'first chunk' else 2):
            return state, resid
        nan = torch.full_like(state[0], float('nan'))
        return (nan, nan) + state[2:], torch.linalg.vector_norm(nan)

    monkeypatch.setattr(an, '_pcg_chol', faulty)
    if fault == 'max iterations':
        monkeypatch.setattr(an, 'PCG_MAX_ITERS', 40)
    solver = an.Analytic()
    if fault == 'first chunk':
        with pytest.raises(RuntimeError, match='before producing a finite iterate'):
            solver._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=2.0)
        return
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        alphas = solver._solve_grid_pcg(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=2.0)
    assert torch.isfinite(alphas).all() and solver.pcg_iters == 40
    assert any('relative residual' in r.message and 'target' in r.message for r in caplog.records)
    if fault == 'second chunk':
        assert any('best finite iterate' in r.message for r in caplog.records)


def test_route_choice(monkeypatch):
    """Dense where ``24 n^2`` fits (no lmax); else lmax, then the pair route
    where the JAX package takes it (lam < 1e-7 lmax and ``est_memory_pair``
    within the budget), else the grid route: each choice made on both sides
    (the JAX routes stubbed to record which one its ``solve`` calls). Past
    the dense bound ``solve`` builds the matvec tables once, for lmax and
    the route."""
    X, Jc, dperms, y = _system(1)
    builds = []
    tables = it_mod.matvec_tables
    monkeypatch.setattr(it_mod, 'matvec_tables', lambda *a: builds.append(1) or tables(*a))
    dense = an.Analytic(max_memory=1.0)
    dense.solve({'sig': SIG, 'lam': LAM}, X, Jc, dperms, y)
    assert dense.route == 'dense' and set(dense.timer.durations) == {'assembly', 'cholesky'}
    assert not hasattr(dense, 'pcg_iters')
    taken = []
    for route in ('pair', 'grid'):
        monkeypatch.setattr(jax_an.Analytic, '_solve_%s_pcg' % route,
                            lambda self, *a, _route=route, **k: taken.append(_route) or np.zeros(len(y)))
    for pair_bytes, lam, route in ((10**12, LAM, 'grid'), (0, LAM, 'pair'), (0, 1e-3, 'grid')):
        for cls in (an.Analytic, jax_an.Analytic):
            monkeypatch.setattr(cls, 'est_memory_pair', staticmethod(lambda n_train, n_atoms: pair_bytes))
        task = {'sig': SIG, 'lam': lam}
        solver = an.Analytic(max_memory=1e-4)
        builds.clear()
        solver.solve(task, X, Jc, dperms, y)
        assert len(builds) == 1, (route, len(builds))
        jax_an.Analytic(max_memory=1e-4).solve(task, X.numpy(), Jc.numpy(), dperms, y)
        assert solver.route == taken[-1] == route, (pair_bytes, lam, solver.route, taken)
        assert solver.pcg_iters > 0 and solver.lmax > 0 and 'lmax' in solver.timer.durations
        assert ('repack' in solver.timer.durations) == (route == 'pair')


def test_memory_estimates_match_jax():
    for args in [(20, 5), (1000, 21), (1000, 9), (3000, 60), (1001, 21)]:
        assert an.Analytic.est_memory_grid(*args) == jax_an.Analytic.est_memory_grid(*args)
        assert an.Analytic.est_memory_pair(*args) == jax_an.Analytic.est_memory_pair(*args)
    # Aspirin M=1000: 63,000 unknowns, the dense route 95.3 GB, the grid 11.9 GB.
    assert an.Analytic.est_memory_requirement(1000, 21) == 24 * 63_000**2 + 8 * 63_000
    assert an.Analytic.est_memory_grid(1000, 21) == 3 * 63_000**2


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_train_in_the_grid_region_matches_jax(use_E_cstr):
    """``solver=None`` where the dense system does not fit and the grid does
    (1e-3 GB): both packages train by the grid route into the same model:
    the split, ``solver_name``, alphas 1e-3, the integration constant 1e-6
    and held-out forces 1e-6 relative."""
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=60, seed=3)
    trainer = GDMLTrain(max_memory=1e-3, device='cpu')
    task = trainer.create_task(ds, 24, ds, 8, sig=SIG, use_sym=False, use_E_cstr=use_E_cstr,
                               rng=np.random.RandomState(5))
    n = 24 * 3 * N_ATOMS + (24 if use_E_cstr else 0)
    assert an.Analytic.est_memory_requirement(24, N_ATOMS, use_E_cstr) > 1e-3 * 1024**3
    assert an.Analytic.est_memory_grid(24, N_ATOMS) < 1e-3 * 1024**3 < an.Analytic.est_memory_pair(24, N_ATOMS)
    assert 1e-3 * 1024**3 < an.Analytic.est_memory_inplace(24, N_ATOMS, use_E_cstr)  # not the in-place route
    model = trainer.train(task)
    ref = JaxTrain(max_memory=1e-3).train(task)
    assert model['solver_name'] == ref['solver_name'] == 'analytic' and 'solver_iters' not in model
    assert {'lmax', 'assembly', 'factor', 'cg'} <= set(trainer.times)
    assert ('border' in trainer.times) == use_E_cstr and ('alphas_E' in model) == use_E_cstr
    np.testing.assert_array_equal(model['idxs_train'], ref['idxs_train'])
    alphas = np.concatenate([model['alphas_F'].ravel(), np.ravel(model.get('alphas_E', []))])
    alphas_ref = np.concatenate([np.asarray(ref['alphas_F']).ravel(), np.ravel(ref.get('alphas_E', []))])
    assert alphas.size == n
    assert np.linalg.norm(alphas - alphas_ref) / np.linalg.norm(alphas_ref) < 1e-3
    assert abs(model['c'] - ref['c']) <= 1e-6 * abs(ref['c'])
    R = ds['R'][np.setdiff1d(np.arange(60), task['idxs_train'])[:20]]
    _, F = GDMLPredict(model, device='cpu').predict(R)
    _, F_ref = GDMLPredict({k: np.asarray(v) if hasattr(v, 'shape') else v for k, v in ref.items()},
                           device='cpu').predict(R)
    assert np.linalg.norm(F - F_ref) / np.linalg.norm(F_ref) < 1e-6
