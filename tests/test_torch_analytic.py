"""The port's dense analytic solve (solvers/analytic.py) on the CPU against
the JAX package: the Cholesky rung, the LU rung on a system that is not
positive definite, the whole solve, the grid route past the dense bound
(tests/test_torch_analytic_grid.py holds it to the JAX package) and the
mesh's pair route on a one-rank world (``tests/test_torch_meshchol.py``
holds it to the JAX package on four ranks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.solvers import analytic as jax_analytic
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.predict import desc_perm_table
from sgdml_tpu_torch.solvers import analytic
from sgdml_tpu_torch.train import GDMLTrain

from torch_mesh_worker import one_rank_world


def _system(n=40, seed=0, psd=True):
    """K whose -K + lam I is positive definite (or indefinite), and y."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    K = -(A @ A.T) / n if psd else (A + A.T) / 2
    return K, rng.normal(size=n)


def test_cho_solve_neg_matches_jax():
    K, y = _system()
    A = analytic._neg_shift_(torch.as_tensor(K.copy()), 1e-3)
    np.testing.assert_array_equal(A.numpy(), -K + 1e-3 * np.eye(len(K)))
    alphas, ok = analytic._cho_solve_neg(A, torch.as_tensor(y))
    ref, ok_j = jax_analytic._cho_solve_neg(jnp.asarray(K), jnp.asarray(y), 1e-3)
    assert ok and bool(ok_j)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_lu_rung_on_a_system_that_is_not_positive_definite(monkeypatch):
    K, y = _system(psd=False)
    A = analytic._neg_shift_(torch.as_tensor(K.copy()), 1e-3)
    assert analytic._cho_solve_neg(A, torch.as_tensor(y)) == (None, False)
    ref = np.asarray(jax_analytic._lu_solve_neg(jnp.asarray(K), jnp.asarray(y), 1e-3))
    np.testing.assert_allclose(analytic._lu_solve_neg(A, torch.as_tensor(y)).numpy(), ref, rtol=1e-9)

    # The solve takes the LU rung when the factor fails.
    monkeypatch.setattr(analytic, 'assemble_kernel', lambda *a, **k: torch.as_tensor(K.copy()))
    task = {'sig': 1.0, 'lam': 1e-3}
    X, Jc = torch.zeros(2, 10, dtype=torch.float64), torch.zeros(2, 10, 3, dtype=torch.float64)
    out = analytic.Analytic().solve(task, X, Jc, desc_perm_table(np.arange(5)[None]), y)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_solve_matches_jax(use_E_cstr):
    ds = generate_md_dataset(n_atoms=5, n_frames=12, seed=4)
    R = ds['R'][:10].reshape(10, -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R), 5)
    dperms = desc_perm_table(np.array([[0, 1, 2, 3, 4], [1, 0, 2, 3, 4]]))
    n = 10 * 15 + (10 if use_E_cstr else 0)
    y = np.random.default_rng(1).normal(size=n)
    task = {'sig': 3.0, 'lam': 1e-6, 'use_E_cstr': use_E_cstr}
    solver = analytic.Analytic()
    ours = solver.solve(task, X, Jc, dperms, y)
    ref = jax_analytic.Analytic().solve(task, X.numpy(), Jc.numpy(), dperms, y)
    assert ours.shape == (n,) and ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-7, atol=1e-9 * np.abs(ref).max())
    assert solver.t_assemble > 0 and solver.t_solve > 0


def test_memory_budget_and_estimate():
    for args in [(200, 9, False), (1000, 9, False), (30, 5, True)]:
        assert analytic.Analytic.est_memory_requirement(*args) == \
            jax_analytic.Analytic.est_memory_requirement(*args)
    assert analytic.Analytic.est_memory_requirement(1000, 9) == 24 * 27_000**2 + 8 * 27_000
    assert analytic.memory_budget('cpu') == 12 * 1024**3


def test_routes_that_are_not_ported_raise():
    ds = generate_md_dataset(n_atoms=4, n_frames=30, seed=0)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:5]), 4)
    dperms = desc_perm_table(np.arange(4)[None])
    # Past the dense and the in-place bounds the solve takes the f32 grid route.
    y = np.random.default_rng(2).normal(size=60)
    grid = analytic.Analytic(max_memory=1e-6)
    alphas = grid.solve({'sig': 2.0, 'lam': 1e-8}, X, Jc, dperms, y)
    assert grid.pcg_iters > 0 and torch.isfinite(alphas).all() and alphas.shape == (60,)
    # The mesh's pair precision constructs and runs on a one-rank world (the
    # dense solve's coefficients to 1e-6 at this lam); a mesh must be a
    # DeviceMesh.
    dense = analytic.Analytic().solve({'sig': 2.0, 'lam': 1e-8}, X, Jc, dperms, y)
    with one_rank_world() as mesh:
        pair = analytic.Analytic(mesh=mesh, mesh_precision='pair')
        alphas = pair.solve({'sig': 2.0, 'lam': 1e-8}, X, Jc, dperms, y)
    assert pair.route == 'mesh' and pair.lam_p_used is not None and pair.pcg_iters > 0
    assert float((alphas - dense).abs().max() / dense.abs().max()) < 1e-6
    for precision in ('f64', 'pair'):
        with pytest.raises(TypeError, match='DeviceMesh'):
            analytic.Analytic(mesh=object(), mesh_precision=precision)

    trainer = GDMLTrain(device='cpu')
    np.random.seed(0)
    task = trainer.create_task(ds, 5, ds, 5, sig=2.0, use_sym=False)
    # The f32 grid route fits 5e-5 GB here, the dense and the in-place f64
    # routes do not: solver=None takes the analytic solver's grid route, as
    # the JAX package does; solver='analytic' takes it even below its bound,
    # and solver='cg' is CG.
    assert analytic.Analytic.est_memory_inplace(5, 4) > 5e-5 * 1024**3 > analytic.Analytic.est_memory_grid(5, 4)
    for max_memory, solver in ((5e-5, None), (1e-6, 'analytic')):
        trainer = GDMLTrain(max_memory=max_memory, device='cpu')
        model = trainer.train(task, solver=solver)
        assert model['solver_name'] == 'analytic' and 'solver_iters' not in model and 'lmax' in trainer.times
    assert GDMLTrain(max_memory=1e-6, device='cpu').train(task, solver='cg')['solver_name'] == 'cg'
    with pytest.raises(ValueError):
        trainer.train(task, solver='lu')
    with pytest.raises(TypeError, match='DeviceMesh'):
        GDMLTrain(mesh=object(), device='cpu')
