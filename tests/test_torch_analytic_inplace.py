"""The port's in-place f64 analytic route (solvers/analytic.py
``Analytic._solve_inplace`` over ``ops/linalg.cholesky_``) on the CPU against
the JAX package: the route rule over budgets that bracket the dense
route's ``24 n^2``, the in-place estimate and the grid's ``3 n^2``; the
solve against the JAX dense solve of the same system, with and without
energy constraints; ``GDMLTrain.train`` in the in-place window against the
JAX dense model; a failed in-place factor; the factor's storage; and the
estimate's formula.

The JAX package has no single-device in-place route: it sends every system
past ``24 n^2`` to the pair or grid route, and solves densely below it. At
this size (N=5, M=24, sig 4, 360 unknowns) one block and one tile would
cover the whole system, so the factor would copy it twice and the in-place
estimate would exceed ``24 n^2``: the module runs with blocks of 64
(``INPLACE_BLOCK``) and a 64 kB tile budget (``kernel.TILE_BUDGET_BYTES``,
2 x 3 points), so that the window between the two bounds exists, as it does
at full size. Tolerances are stated where they are used.
"""

import logging

import numpy as np
import pytest
import torch

from sgdml_tpu.solvers import analytic as jax_an
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.ops import linalg
from sgdml_tpu_torch.parallel import spmd
from sgdml_tpu_torch.predict import GDMLPredict, desc_perm_table
from sgdml_tpu_torch.solvers import analytic as an
from sgdml_tpu_torch.train import GDMLTrain

N_ATOMS, M, SIG, LAM = 5, 24, 4.0, 1e-10
BLOCK, TILE_BUDGET = 64, 1 << 16
FULL_BLOCK = an.INPLACE_BLOCK  # before the fixture below patches it
LOGGER = 'sgdml_tpu_torch.solvers.analytic'
GB = 1024**3


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setattr(an, 'INPLACE_BLOCK', BLOCK)
    monkeypatch.setattr(kernel_ops, 'TILE_BUDGET_BYTES', TILE_BUDGET)


def _system(use_E_cstr=False):
    """Descriptors (torch), the permutation table, normalized labels and
    the task of the recipe's first M frames (forces, then centered
    energies)."""
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=M + 4, seed=3)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:M].reshape(M, -1)), N_ATOMS)
    y = ds['F'][:M].reshape(-1)
    if use_E_cstr:
        y = np.hstack([y, -ds['E'][:M] + np.mean(ds['E'][:M])])
    return X, Jc, desc_perm_table(np.arange(N_ATOMS)[None]), y / np.std(y)


def _budgets(use_E_cstr=False):
    """Budgets in GB for each step of the rule: the dense route's ``24 n^2``,
    the in-place estimate's and the grid's ``3 n^2`` each bracketed."""
    dense = an.Analytic.est_memory_requirement(M, N_ATOMS, use_E_cstr)
    inplace = an.Analytic.est_memory_inplace(M, N_ATOMS, use_E_cstr)
    grid = an.Analytic.est_memory_grid(M, N_ATOMS)
    assert grid < inplace < dense, (grid, inplace, dense)
    return {'dense': 1.01 * dense / GB, 'inplace': (inplace + dense) / 2 / GB, 'refined': (grid + inplace) / 2 / GB}


@pytest.mark.parametrize('budget,pair_bytes,lam,route,jax_route', [
    ('dense', 0, LAM, 'dense', None),
    ('inplace', 0, LAM, 'inplace', 'pair'),
    ('inplace', 10**12, LAM, 'inplace', 'grid'),
    ('refined', 10**12, LAM, 'grid', 'grid'),
    ('refined', 0, LAM, 'pair', 'pair'),
    ('refined', 0, 1e-3, 'grid', 'grid'),
])
def test_route_choice(monkeypatch, budget, pair_bytes, lam, route, jax_route):
    """Dense where ``24 n^2`` fits, as the JAX package; in-place where only
    the in-place estimate fits, where the JAX package takes its pair-or-grid
    rule; below that the JAX package's rule, the same choice on both sides:
    the pair route where lam < 1e-7 lmax and ``est_memory_pair`` fits, else
    the grid. The JAX routes are stubbed to record which one its ``solve``
    calls (None: its dense route)."""
    X, Jc, dperms, y = _system()
    gb = _budgets()[budget]
    for cls in (an.Analytic, jax_an.Analytic):
        monkeypatch.setattr(cls, 'est_memory_pair', staticmethod(lambda n_train, n_atoms: pair_bytes))
    taken = []
    for name in ('pair', 'grid'):
        monkeypatch.setattr(jax_an.Analytic, '_solve_%s_pcg' % name,
                            lambda self, *a, _route=name, **k: taken.append(_route) or np.zeros(len(y)))
    task = {'sig': SIG, 'lam': lam}
    solver = an.Analytic(max_memory=gb)
    alphas = solver.solve(task, X, Jc, dperms, y)
    jax_an.Analytic(max_memory=gb).solve(task, X.numpy(), Jc.numpy(), dperms, y)
    assert solver.route == route and torch.isfinite(alphas).all()
    assert taken == ([] if jax_route is None else [jax_route]), taken
    phases = set(solver.timer.durations)
    if route == 'dense':
        assert phases == {'assembly', 'cholesky'}
    elif route == 'inplace':
        assert phases == {'assembly', 'factor', 'solve'} and not hasattr(solver, 'lmax')
    else:
        assert 'lmax' in phases and solver.pcg_iters > 0 and ('repack' in phases) == (route == 'pair')


def _fit(alphas, X, Jc, dperms, lam, y, use_E_cstr):
    """``|(-K + lam I) x - y| / |y|`` for ``x = -alphas``, K assembled by the
    port at the default tile budget."""
    K = kernel_ops.assemble_kernel(X, Jc, dperms, SIG, N_ATOMS, use_E_cstr=use_E_cstr).numpy()
    x = -np.asarray(alphas)
    return np.linalg.norm(-K @ x + lam * x - y) / np.linalg.norm(y)


@pytest.mark.parametrize('lam,coef_tol', [(LAM, 1e-6), (1e-3, 1e-10)])
@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_inplace_matches_the_jax_dense_solve(use_E_cstr, lam, coef_tol):
    """The in-place route against the JAX dense solve (a budget where it
    fits) of the same system: the fit within 1e-9 relative (the mesh
    factor's bound); the coefficients within 1e-6 relative at lam 1e-10
    (condition number ~3e10 without energy constraints, ~2e11 with: 7e-7
    read) and within 1e-10 at lam 1e-3 (~3e3: 1.4e-13 read)."""
    X, Jc, dperms, y = _system(use_E_cstr)
    task = {'sig': SIG, 'lam': lam, 'use_E_cstr': use_E_cstr}
    solver = an.Analytic(max_memory=_budgets(use_E_cstr)['inplace'])
    alphas = solver.solve(task, X, Jc, dperms, y)
    ref = np.asarray(jax_an.Analytic(max_memory=64).solve(task, X.numpy(), Jc.numpy(), dperms, y))
    assert solver.route == 'inplace' and alphas.dtype == torch.float64 and alphas.shape == y.shape
    assert solver.t_assemble > 0 and solver.t_solve > 0
    assert _fit(alphas.numpy(), X, Jc, dperms, lam, y, use_E_cstr) < 1e-9
    assert _fit(ref, X, Jc, dperms, lam, y, use_E_cstr) < 1e-9
    assert np.linalg.norm(alphas.numpy() - ref) / np.linalg.norm(ref) < coef_tol


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_train_in_the_inplace_window_matches_jax(use_E_cstr):
    """``solver=None`` where only the in-place estimate fits: the port
    trains by the in-place route, the JAX package (at a budget where its
    dense route fits) densely, into the same model: the split, the
    integration constant 1e-6 and held-out forces 1e-6 relative."""
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=60, seed=3)
    trainer = GDMLTrain(max_memory=_budgets(use_E_cstr)['inplace'], device='cpu')
    task = trainer.create_task(ds, M, ds, 8, sig=SIG, use_sym=False, use_E_cstr=use_E_cstr,
                               rng=np.random.RandomState(5))
    model = trainer.train(task)
    ref = JaxTrain(max_memory=64).train(task)
    assert model['solver_name'] == ref['solver_name'] == 'analytic'
    assert {'assembly', 'factor', 'solve'} <= set(trainer.times) and not {'cholesky', 'lmax'} & set(trainer.times)
    assert ('alphas_E' in model) == use_E_cstr
    np.testing.assert_array_equal(model['idxs_train'], ref['idxs_train'])
    assert abs(model['c'] - ref['c']) <= 1e-6 * abs(ref['c'])
    R = ds['R'][np.setdiff1d(np.arange(60), task['idxs_train'])[:20]]
    _, F = GDMLPredict(model, device='cpu').predict(R)
    _, F_ref = GDMLPredict({k: np.asarray(v) if hasattr(v, 'shape') else v for k, v in ref.items()},
                           device='cpu').predict(R)
    assert np.linalg.norm(F - F_ref) / np.linalg.norm(F_ref) < 1e-6


@pytest.mark.parametrize('fault,route', [('indefinite', 'grid'), ('indefinite', 'pair'), ('out of memory', None)])
def test_failed_factor(monkeypatch, caplog, fault, route):
    """The in-place factor made to fail: where a diagonal block is not
    positive definite the solve warns and takes the JAX package's
    pair-or-grid rule (the JAX route stubbed to record its choice at the
    same budget), with the result of that route called directly; any other
    error (an out-of-memory error) is not caught."""
    X, Jc, dperms, y = _system()
    pair_bytes = 0 if route == 'pair' else 10**12
    for cls in (an.Analytic, jax_an.Analytic):
        monkeypatch.setattr(cls, 'est_memory_pair', staticmethod(lambda n_train, n_atoms: pair_bytes))
    seen = []

    def failing(A, nb):
        seen.append(A)
        if fault == 'indefinite':
            raise linalg.NotPositiveDefiniteError('blocked Cholesky: the matrix is not positive definite')
        raise torch.OutOfMemoryError('out of memory')

    monkeypatch.setattr(an.linalg, 'cholesky_', failing)
    task = {'sig': SIG, 'lam': LAM}
    gb = _budgets()['inplace']
    solver = an.Analytic(max_memory=gb)
    if route is None:
        with pytest.raises(torch.OutOfMemoryError):
            solver.solve(task, X, Jc, dperms, y)
        return
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        alphas = solver.solve(task, X, Jc, dperms, y)
    assert len(seen) == 1 and solver.route == route
    assert any('In-place f64 Cholesky failed' in r.message and 'falling back' in r.message for r in caplog.records)
    taken = []
    for name in ('pair', 'grid'):
        monkeypatch.setattr(jax_an.Analytic, '_solve_%s_pcg' % name,
                            lambda self, *a, _route=name, **k: taken.append(_route) or np.zeros(len(y)))
    jax_an.Analytic(max_memory=gb).solve(task, X.numpy(), Jc.numpy(), dperms, y)
    assert taken == [route]
    direct = an.Analytic()
    want = getattr(direct, '_solve_%s_pcg' % route)(task, X, Jc, dperms, y, SIG, LAM, N_ATOMS, lmax=solver.lmax)
    assert solver.pcg_iters == direct.pcg_iters
    np.testing.assert_array_equal(alphas.numpy(), want.numpy())


def test_factor_runs_on_the_assembled_storage(monkeypatch):
    """The factor and both substitutions run on the assembled ``K``'s own
    storage, in blocks of ``INPLACE_BLOCK``: no copy of it is made."""
    X, Jc, dperms, y = _system()
    ptrs = {'K': [], 'factor': [], 'solve': []}
    assemble, factor, tri = an.assemble_kernel, linalg.cholesky_, linalg.blocked_tri_solve

    def assembled(*a, **k):
        K = assemble(*a, **k)
        ptrs['K'].append(K.data_ptr())
        return K

    def factored(A, nb):
        ptrs['factor'].append((A.data_ptr(), nb, A.shape))
        return factor(A, nb)

    def solved(L, b, nb, **k):
        ptrs['solve'].append((L.data_ptr(), nb))
        return tri(L, b, nb, **k)

    monkeypatch.setattr(an, 'assemble_kernel', assembled)
    monkeypatch.setattr(an.linalg, 'cholesky_', factored)
    monkeypatch.setattr(an.linalg, 'blocked_tri_solve', solved)
    solver = an.Analytic(max_memory=_budgets()['inplace'])
    solver.solve({'sig': SIG, 'lam': LAM}, X, Jc, dperms, y)
    n = M * 3 * N_ATOMS
    assert solver.route == 'inplace' and len(ptrs['K']) == 1
    assert ptrs['factor'] == [(ptrs['K'][0], BLOCK, (n, n))]
    assert ptrs['solve'] == [(ptrs['K'][0], BLOCK)] * 2


def test_cholesky_in_place_matches_torch():
    """``linalg.cholesky_`` writes the lower factor into its input (within
    1e-12 of ``torch.linalg.cholesky``, zeros above the diagonal) at a side
    that no block divides, and raises ``NotPositiveDefiniteError``, a
    ``RuntimeError``, at an indefinite block; the mesh's block is
    ``INPLACE_BLOCK``'s default."""
    rng = np.random.default_rng(0)
    B = rng.normal(size=(150, 150))
    A = torch.as_tensor(B @ B.T / 150 + 1e-3 * np.eye(150))
    want = torch.linalg.cholesky(A)
    work = A.clone()
    L = linalg.cholesky_(work, 32)
    assert L.data_ptr() == work.data_ptr() and torch.equal(L, torch.tril(L))
    assert float((L - want).abs().max()) <= 1e-12 * float(want.abs().max())
    bad = A.clone()
    bad[100, 100] = -1.0
    with pytest.raises(linalg.NotPositiveDefiniteError, match='leading minor of order 101'):
        linalg.cholesky_(bad, 32)
    assert issubclass(linalg.NotPositiveDefiniteError, RuntimeError)
    assert FULL_BLOCK == spmd.NB == 1024


@pytest.mark.parametrize('n_train,n_atoms,use_E_cstr,n_perms', [
    (24, 5, False, 1), (45, 5, True, 2), (1000, 21, False, 1), (1400, 21, False, 1), (8, 5, False, 1),
])
def test_est_memory_inplace_follows_its_formula(monkeypatch, n_train, n_atoms, use_E_cstr, n_perms):
    """``8 n^2`` plus four vectors plus the larger of the assembly's working
    set (one tile's per-pair bound at the default tile sizes, the inputs and
    their permuted copies, the energy tiles' expanded Jacobians) and the
    factor's (the ``(n - nb, nb)`` panel and three ``nb^2``), at the module's
    small blocks and at the full-size ones; a system inside one block (the
    factor copies it twice) never fits where the dense route does not."""
    for block, tile_budget in ((BLOCK, TILE_BUDGET), (1024, 1 << 30)):
        monkeypatch.setattr(an, 'INPLACE_BLOCK', block)
        monkeypatch.setattr(kernel_ops, 'TILE_BUDGET_BYTES', tile_budget)
        dim_i, dim_d = 3 * n_atoms, n_atoms * (n_atoms - 1) // 2
        n = n_train * dim_i + (n_train if use_E_cstr else 0)
        nb = min(block, n)
        per_pair = (45 * n_atoms**2 + 8 * dim_d) * 8
        pairs = max(1, tile_budget // per_pair)
        ti = min(n_train, max(1, int(np.sqrt(pairs))))
        tj = min(n_train, max(1, pairs // max(1, int(np.sqrt(pairs)))))
        assembly = ti * tj * per_pair + (n_perms + 1) * n_train * dim_d * 32
        if use_E_cstr:
            assembly += (ti + tj) * n_perms * dim_d * dim_i * 8
        want = 8 * n * n + 32 * n + max(assembly, 8 * ((n - nb) * nb + 3 * nb * nb))
        est = an.Analytic.est_memory_inplace(n_train, n_atoms, use_E_cstr, n_perms)
        assert est == want
        if n <= nb:
            assert est > an.Analytic.est_memory_requirement(n_train, n_atoms, use_E_cstr)
    if (n_train, n_atoms) == (1000, 21):  # aspirin: the strip and about 1.1 GB, a third of 24 n^2
        assert 8 * 63_000**2 < est < 8 * 63_000**2 + 1.2e9
    if (n_train, n_atoms) == (1400, 21):  # the window's top on an 80 GB card
        assert est < 64e9 < an.Analytic.est_memory_requirement(n_train, n_atoms)
