"""The port's pair-precision analytic route (solvers/analytic.py
``Analytic._solve_pair_pcg`` over ops/pairchol.py) on the CPU against the
JAX package, on tests/test_analytic_pair.py's inputs: N=5, sig 4, lam
1e-10 and ``target_block=512`` (a k >= 2 pair grid), at M=48, and at M=45
with energy constraints (a point count that is not a multiple of 8, so the
grid's padded points run). Both packages get the same lmax; the JAX results
are computed once a module.

The JAX package's power-of-two scales are ``jnp.exp2`` of f32 exponents,
which XLA:CPU computes exactly only for exponents in about [-12, 12]; the
port's are the exponents' bits (tests/test_torch_ozaki.py). Its solve here
runs with its scales made exact (``_row_scale`` and ``split_global_int8``
patched), at shapes that no other test traces (its jitted steps keep the
functions they were traced with). As shipped, its inexact scales cost it
iterations: 100 against the port's 84 at M=40 and 270 against 252 at M=37
with energy constraints.

Then the route's two fallbacks to the grid route, and ``GDMLTrain.train``
in the pair region. Tolerances are stated where they are used.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import ozaki as jax_ozaki
from sgdml_tpu.ops import pairchol as jax_pc
from sgdml_tpu.ops.descriptor import descriptor_batch as jax_descriptor_batch
from sgdml_tpu.solvers import analytic as jax_an
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import pairchol as pc
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.solvers import analytic as an
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.train import GDMLTrain

N_ATOMS, SIG, LAM, BLOCK = 5, 4.0, 1e-10, 512
LOGGER = 'sgdml_tpu_torch.solvers.analytic'
DPERMS = np.arange((N_ATOMS * (N_ATOMS - 1)) // 2)[None, :]


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Two torch threads while this module runs (the count restored after):
    the suite's workers share the machine's cores, and its CG tests keep
    wall budgets."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system(m, use_E_cstr):
    """The JAX test's descriptors (as numpy), normalized labels and task."""
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=m + 4, seed=3)
    X, Jc = jax_descriptor_batch(jnp.asarray(ds['R'][:m].reshape(m, -1)), N_ATOMS)
    F = ds['F'][:m]
    y = F.reshape(-1)
    if use_E_cstr:
        y = np.concatenate([y, -(ds['E'][:m] - ds['E'][:m].mean())])
    task = {'sig': SIG, 'lam': LAM, 'use_E_cstr': use_E_cstr}
    return np.asarray(X), np.asarray(Jc), y / np.std(F), task


def _predictions(alphas, X, Jc, use_E_cstr):
    """``K alphas`` (forces, then energies) through the matrix-free matvec at
    lam = 0 (the ridge term cancels in a comparison)."""
    tab = it_mod.matvec_tables(torch.as_tensor(X), torch.as_tensor(Jc), DPERMS)
    return it_mod._matvec_A(-torch.as_tensor(np.asarray(alphas)), tab, SIG, 0.0, n_atoms=N_ATOMS,
                            use_E_cstr=use_E_cstr).numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pow2(e):
    return jax.lax.bitcast_convert_type((e.astype(jnp.int32) + 127) << 23, jnp.float32)


def _exact_row_scale(hi):
    _, e = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(hi), axis=1, keepdims=True), jnp.finfo(jnp.float32).tiny))
    return _pow2(e)


def _exact_split_global_int8(x64, n_slices=8, q=jax_ozaki.Q_BITS):
    """The JAX package's split_global_int8 with its scale as exponent bits."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    _, e = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(hi)), jnp.finfo(jnp.float32).tiny))
    sigma = _pow2(e)
    slices, t = jax_ozaki._extract_slices(hi / sigma, 4, q)
    if n_slices > 4:
        more, _ = jax_ozaki._extract_slices(t + (lo / sigma) * jnp.float32(2.0 ** (q * 4)), n_slices - 4, q)
        slices += more
    return jnp.stack(slices), sigma


@pytest.fixture(scope='module', params=[(48, False), (45, True)], ids=['M48', 'M45-E_cstr'])
def solved(request):
    """Both packages' pair solves at the same lmax (the JAX rungs read from
    its diagonal shifts; its scales exact), and the port's dense f64
    solve."""
    m, use_E_cstr = request.param
    X, Jc, y, task = _system(m, use_E_cstr)
    key = (np.ascontiguousarray(DPERMS.astype(np.int64)).tobytes(), DPERMS.shape)
    lmax = float(jax_an._lmax_power(jnp.asarray(X), jnp.asarray(Jc), SIG, LAM, n_atoms=N_ATOMS,
                                    desc_perms_key=key, use_E_cstr=use_E_cstr))
    shifts = []
    saved = jax_pc.grid_pair_diag_add, jax_ozaki._row_scale, jax_ozaki.split_global_int8

    def recorded(Ghi, Glo, delta):
        shifts.append(float(delta))
        return saved[0](Ghi, Glo, delta)

    jax_pc.grid_pair_diag_add, jax_ozaki._row_scale, jax_ozaki.split_global_int8 = (
        recorded, _exact_row_scale, _exact_split_global_int8)
    try:
        ref = jax_an.Analytic(max_memory=64)
        ref_alphas = ref._solve_pair_pcg(task, X, Jc, DPERMS, y, SIG, LAM, N_ATOMS, target_block=BLOCK, lmax=lmax)
    finally:
        jax_pc.grid_pair_diag_add, jax_ozaki._row_scale, jax_ozaki.split_global_int8 = saved
    tX, tJc = torch.as_tensor(X.copy()), torch.as_tensor(Jc.copy())
    ours = an.Analytic()
    alphas = ours._solve_pair_pcg(task, tX, tJc, DPERMS, y, SIG, LAM, N_ATOMS, target_block=BLOCK, lmax=lmax)
    dense = an.Analytic().solve(task, tX, tJc, DPERMS, y)
    return dict(m=m, use_E_cstr=use_E_cstr, X=X, Jc=Jc, y=y, task=task, lmax=lmax, ref=ref,
                ref_alphas=np.asarray(ref_alphas), jax_shifts=shifts, ours=ours, alphas=alphas, dense=dense)


def test_pair_pcg_matches_jax(solved):
    """The same rungs (lam' bit for bit at the same lmax), refinement
    iterations within 10 (the JAX package reads its residual every 10
    iterations), predictions within 1e-6 relative of the JAX result and of
    the dense f64 solve, the route's phases and its grid."""
    s, ours = solved, solved['ours']
    assert ours.route == 'pair' and ours.lmax == s['lmax']
    assert [r[0] for r in ours.rungs] == s['jax_shifts'] and ours.rungs[-1][1] == 0
    assert ours.lam_p_used == s['jax_shifts'][-1] == max(LAM, 3e-9 * s['lmax'])
    assert abs(ours.pcg_iters - s['ref'].pcg_iters) <= 10, (ours.pcg_iters, s['ref'].pcg_iters)
    assert s['alphas'].dtype == torch.float64 and s['alphas'].shape == s['y'].shape
    p = _predictions(s['alphas'], s['X'], s['Jc'], s['use_E_cstr'])
    for other in (s['ref_alphas'], s['dense']):
        assert _rel(p, _predictions(other, s['X'], s['Jc'], s['use_E_cstr'])) < 1e-6
    phases = {'assembly', 'factor', 'repack', 'cg'} | ({'border'} if s['use_E_cstr'] else set())
    assert set(ours.timer.durations) == phases  # lmax was given
    assert ours.t_solve == ours.timer.durations['cg'] and ours.t_assemble > 0
    # Both sizes give 2 blocks of 360 rows; M=45 pads the grid to 48 points.
    dim_i = 3 * N_ATOMS
    spec = an.blockchol.grid_spec(-(-s['m'] // 8) * 8 * dim_i, target_block=BLOCK, align=dim_i)
    assert (spec.n, spec.k, spec.b) == (48 * dim_i, 2, 360)


@pytest.mark.parametrize('fault', ['every rung', 'cg breakdown'])
def test_pair_fallbacks_to_the_grid_route(monkeypatch, caplog, fault):
    """Every rung indefinite, or a CG breakdown before any finite iterate:
    a warning, then the grid route with the same lmax, whose result is the
    grid route's own bit for bit."""
    X, Jc, y, task = _system(40, False)
    tX, tJc = torch.as_tensor(X.copy()), torch.as_tensor(Jc.copy())
    lmax = 2.0
    grid = an.Analytic()
    want = grid._solve_grid_pcg(task, tX, tJc, DPERMS, y, SIG, LAM, N_ATOMS, lmax=lmax)
    if fault == 'every rung':
        monkeypatch.setattr(pc, 'chol_grid_pair', lambda Ghi, Glo: (Ghi, Glo, 1))
        message = "failed at every lam' rung"
    else:
        def poisoned(*args):
            return lambda v: torch.full_like(v, float('nan'))

        monkeypatch.setattr(an, '_pair_M_apply', poisoned)
        message = 'broke down before producing a finite iterate'
    solver = an.Analytic()
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        alphas = solver._solve_pair_pcg(task, tX, tJc, DPERMS, y, SIG, LAM, N_ATOMS, target_block=BLOCK, lmax=lmax)
    assert any(message in r.message and 'falling back to the f32 grid solver' in r.message for r in caplog.records)
    assert solver.route == 'grid' and solver.lmax == lmax and solver.pcg_iters == grid.pcg_iters
    np.testing.assert_array_equal(alphas.numpy(), want.numpy())


def test_train_in_the_pair_region_matches_jax(monkeypatch):
    """``solver=None`` where the dense system does not fit, with
    ``est_memory_pair`` patched to 0 on both classes so that the pair region
    exists at this size: both packages train by the pair route into the same
    model (the grid test's tolerances): ``solver_name``, alphas 1e-3, the
    integration constant 1e-6 and held-out forces 1e-6 relative."""
    for cls in (an.Analytic, jax_an.Analytic):
        monkeypatch.setattr(cls, 'est_memory_pair', staticmethod(lambda n_train, n_atoms: 0))
    routes = []
    pair = an.Analytic._solve_pair_pcg

    def watched(self, *args, **kw):
        routes.append('pair')
        return pair(self, *args, **kw)

    monkeypatch.setattr(an.Analytic, '_solve_pair_pcg', watched)
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=60, seed=3)
    trainer = GDMLTrain(max_memory=1e-3, device='cpu')
    task = trainer.create_task(ds, 24, ds, 8, sig=SIG, use_sym=False, rng=np.random.RandomState(5))
    assert an.Analytic.est_memory_requirement(24, N_ATOMS) > 1e-3 * 1024**3
    assert an.Analytic.est_memory_inplace(24, N_ATOMS) > 1e-3 * 1024**3  # not the in-place route
    model = trainer.train(task)
    ref = JaxTrain(max_memory=1e-3).train(task)
    assert routes == ['pair'] and 'repack' in trainer.times
    assert model['solver_name'] == ref['solver_name'] == 'analytic' and 'solver_iters' not in model
    np.testing.assert_array_equal(model['idxs_train'], ref['idxs_train'])
    alphas, alphas_ref = model['alphas_F'].ravel(), np.asarray(ref['alphas_F']).ravel()
    assert np.linalg.norm(alphas - alphas_ref) / np.linalg.norm(alphas_ref) < 1e-3
    assert abs(model['c'] - ref['c']) <= 1e-6 * abs(ref['c'])
    R = ds['R'][np.setdiff1d(np.arange(60), task['idxs_train'])[:20]]
    _, F = GDMLPredict(model, device='cpu').predict(R)
    _, F_ref = GDMLPredict({k: np.asarray(v) if hasattr(v, 'shape') else v for k, v in ref.items()},
                           device='cpu').predict(R)
    assert np.linalg.norm(F - F_ref) / np.linalg.norm(F_ref) < 1e-6
