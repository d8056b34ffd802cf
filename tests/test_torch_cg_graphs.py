"""The CG chunks as replayed blocks (``utils/graphs.Loop``) on the CPU, where
each block runs its body eagerly over the same static buffers, at the same
block offsets and with the same copies in and out that a card's CUDA graphs
replay: the Nystrom CG chunk (``solvers/iterative._ChunkBlocks``) and the
refinement chunk of the grid and pair routes (``solvers/analytic.
_CholBlocks``), each against the eager loop bit for bit and against the JAX
package; whole solves through a growth restart, residual replacements, a
re-seed and a rung climb; the factor a solve reads after its graphs are
dropped; no aliasing of a chunk's results; and which solves take the blocks.
Tolerances are stated where they are used.
"""

import inspect
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import ozaki as jax_ozaki
from sgdml_tpu.ops.descriptor import descriptor_batch as jax_descriptor_batch
from sgdml_tpu.solvers import analytic as jax_an
from sgdml_tpu.solvers import iterative as jax_it
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.solvers import analytic as an
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import graphs

from torch_mesh_worker import one_rank_world

N_ATOMS = 6
SIG, LAM = 8.0, 1e-10
LOGGER = 'sgdml_tpu_torch.solvers.iterative'


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """Two torch threads while this module runs (the count restored after):
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ds():
    return generate_md_dataset(n_atoms=N_ATOMS, n_frames=300, seed=4)


def _task(ds, n_train, seed, **kw):
    kw = dict(dict(sig=SIG, lam=LAM, use_sym=False, use_E=True), **kw)
    return GDMLTrain(device='cpu').create_task(ds, n_train, ds, 8, rng=np.random.RandomState(seed), **kw)


def _system(task, use_E_cstr=False):
    """Descriptors, the identity permutation table and the normalized labels
    (forces, then centered energies with ``use_E_cstr``)."""
    m = task['R_train'].shape[0]
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(task['R_train'].reshape(m, -1)), N_ATOMS)
    dperms = np.arange(desc_ops.descriptor_dim(N_ATOMS))[None, :]
    y = task['F_train'].ravel()
    if use_E_cstr:
        E = np.asarray(task['E_train']).ravel()
        y = np.concatenate([y, -(E - E.mean())])
    y_std = float(np.std(task['F_train']))
    return X, Jc, dperms, y / y_std, y_std


def _same(a, b):
    """Bit for bit, tensor by tensor."""
    return all(torch.equal(u, v) for u, v in zip(a, b))


# -- the Loop ------------------------------------------------------------------


def test_loop_blocks_reads_and_copies():
    """25 iterations in blocks of 10, 10 and 5 (one program each length),
    ``going`` read before each block and ending the loop when False, the
    state copied in and out (the result is not the static state, and a
    later call leaves it as it was)."""
    reads = []

    def step(state):
        x, n = state
        n += 1
        return x * 2.0, n

    loop = graphs.Loop(step, (torch.zeros(3), torch.zeros((), dtype=torch.int64)), 10, False)
    start = (torch.ones(3), torch.zeros((), dtype=torch.int64))
    out = loop(start, 25, lambda s: reads.append(int(s[1])) or True)
    assert reads == [0, 10, 20] and int(out[1]) == 25 and torch.equal(out[0], torch.full((3,), 2.0**25))
    assert sorted(loop._programs) == [5, 10] and loop.capture_s == 0.0
    assert all(o.data_ptr() != s.data_ptr() for o, s in zip(out, loop.state))
    kept = tuple(t.clone() for t in out)
    again = loop(out, 25, lambda s: int(s[1]) < 40)
    assert _same(out, kept) and int(again[1]) == 45  # blocks at 25, 35; stopped at 45 >= 40
    assert torch.equal(start[0], torch.ones(3))


# -- the Nystrom CG chunk ------------------------------------------------------


# The chunk cases' lam: at 1e-10 the residual of a 4-point factor barely
# falls in 50 steps, so no threshold would stop a chunk where a test wants it.
CHUNK_LAM = 1e-6


@pytest.fixture(scope='module', params=[False, True], ids=['forces', 'E_cstr'])
def chunk_case(request, ds):
    """A 40-point system at lam 1e-6, its matvec tables, and the f64 factor
    and the 8-slice stack of the same 4 inducing points."""
    use_E_cstr = request.param
    task = _task(ds, 40, 21, use_E_cstr=use_E_cstr, lam=CHUNK_LAM)
    X, Jc, dperms, y, _ = _system(task, use_E_cstr)
    cols = np.sort(np.random.default_rng(3).choice(40 * 18, 4 * 18, replace=False))
    solver = it_mod.Iterative(max_memory=1.0, device='cpu')
    F64, _ = solver._build_factor(X, Jc, dperms, SIG, CHUNK_LAM, cols, N_ATOMS, use_E_cstr)
    solver = it_mod.Iterative(max_memory=1.0, factor_mode='ozaki', factor_slices=8, device='cpu')
    stack, _ = solver._build_factor(X, Jc, dperms, SIG, CHUNK_LAM, cols, N_ATOMS, use_E_cstr)
    assert isinstance(stack, it_mod.SliceFactor)
    return dict(use_E_cstr=use_E_cstr, tab=it_mod.matvec_tables(X, Jc, dperms), y=torch.as_tensor(y),
                factors={'f64': F64, 'stack': stack})


def _start(F, y, lam=CHUNK_LAM):
    z = it_mod._precond(F, y, lam)
    zero = torch.zeros((), dtype=torch.int64)
    return (torch.zeros_like(y), y, z, z, y @ z, zero, torch.zeros(it_mod.CG_CHUNK_ITERS, dtype=torch.float64), zero)


def _eager(c, F, state, rtol, iters, mm):
    return it_mod._pcg_chunk(state, F, c['tab'], SIG, CHUNK_LAM, float(torch.linalg.vector_norm(c['y'])), rtol,
                             n_atoms=N_ATOMS, use_E_cstr=c['use_E_cstr'], chunk_iters=iters, mm=mm)


def _stopping_at(c, F, mm, stop):
    """A mid-solve state (after ``warm`` eager steps from x = 0, the first
    ``warm`` from 20 on that works) and a rtol at which a chunk from it
    converges at exactly step ``stop``: its residual there below the
    start's and every earlier step's, the threshold halfway down to it."""
    b_norm = float(torch.linalg.vector_norm(c['y']))
    for warm in range(20, 30):
        state = _eager(c, F, _start(F, c['y']), 0.0, warm, mm)
        hist = _eager(c, F, state, 0.0, it_mod.CG_CHUNK_ITERS, mm)[6].numpy()
        lowest = min(float(torch.linalg.vector_norm(state[1])), hist[:stop - 1].min(initial=np.inf))
        if hist[stop - 1] < lowest:
            return state, 0.5 * (hist[stop - 1] + lowest) / b_norm
    raise AssertionError('no start state converges at step %d' % stop)


@pytest.mark.parametrize('stop', [3, 10, 17, None])
@pytest.mark.parametrize('mm', ['native', 'ozaki'])
@pytest.mark.parametrize('factor', ['f64', 'stack'])
def test_chunk_blocks_equal_eager_loop(chunk_case, factor, mm, stop, monkeypatch):
    """From the same state, x, r, z, p, rz, it, hist and n_bad of the blocks
    equal the eager loop's bit for bit, whether the chunk converges at step
    3, at the first block boundary (10), inside the second block after it
    (17) or never (all 50); both make the same matvecs (to the next multiple
    of 10)."""
    c = chunk_case
    F = c['factors'][factor]
    if stop is None:
        state, rtol = _eager(c, F, _start(F, c['y']), 0.0, 20, mm), 0.0
    else:
        state, rtol = _stopping_at(c, F, mm, stop)
    matvec, calls = it_mod._matvec_A, []
    monkeypatch.setattr(it_mod, '_matvec_A', lambda *a, **k: calls.append(1) or matvec(*a, **k))
    eager = _eager(c, F, state, rtol, it_mod.CG_CHUNK_ITERS, mm)
    n_eager = len(calls)
    blocks = it_mod._ChunkBlocks(F, c['tab'], SIG, CHUNK_LAM, float(torch.linalg.vector_norm(c['y'])), rtol,
                                 n=c['y'].shape[0], n_atoms=N_ATOMS, use_E_cstr=c['use_E_cstr'], mm=mm, graph=False)
    out = blocks(state, it_mod.CG_CHUNK_ITERS)
    assert _same(eager, out)
    assert int(out[5]) == (stop or it_mod.CG_CHUNK_ITERS)
    assert n_eager == len(calls) - n_eager == (-(-int(out[5]) // 10) * 10)
    assert torch.isfinite(out[0]).all() and float(out[6][int(out[5]) - 1]) > 0


def test_chunk_results_are_copies(chunk_case):
    """A chunk's returned tensors are not the static state: a later chunk
    from them leaves them as they were."""
    c = chunk_case
    F, y = c['factors']['f64'], c['y']
    blocks = it_mod._ChunkBlocks(F, c['tab'], SIG, CHUNK_LAM, 1.0, 0.0, n=y.shape[0], n_atoms=N_ATOMS,
                                 use_E_cstr=c['use_E_cstr'], mm='native', graph=False)
    first = blocks(_start(F, y), 20)
    kept = tuple(t.clone() for t in first)
    second = blocks(first, 20)
    assert _same(first, kept) and not torch.equal(first[0], second[0])
    ptrs = {t.data_ptr() for t in blocks.loop.state}
    assert not ptrs & {t.data_ptr() for t in first + second}


@pytest.mark.parametrize('early', [False, True])
def test_chunk_blocks_match_jax(ds, early):
    """The blocks against the JAX package's compiled chunk from the same
    state, as tests/test_torch_iterative.py's test_pcg_chunk_matches_jax
    holds the eager loop: the same step count and PSD-guard trips, the
    residual histories within 1e-6 over the first 10 steps and 5% over the
    chunk, x within 5% (4 of 60 points at lam 1e-10: rounding differences
    grow along the chunk)."""
    task = _task(ds, 60, 21)
    X, Jc, dperms, y, _ = _system(task)
    cols = np.sort(np.random.default_rng(3).choice(60 * 18, 4 * 18, replace=False))
    C = kernel_ops.assemble_kernel_columns(X, Jc, dperms, SIG, N_ATOMS, cols).neg_()
    F_j, _, ok_j = jax_it._nystrom_factor_from_cols(jnp.asarray(C.numpy().copy()), cols, LAM, 0.0, 0.0)
    F, _, ok = it_mod._nystrom_factor_from_cols(C, cols, LAM, 0.0, 0.0)
    assert ok and bool(ok_j)
    b = torch.as_tensor(y)
    b_norm = float(np.linalg.norm(y))
    state = _start(F, b, LAM)
    key = (np.ascontiguousarray(dperms.astype(np.int64)).tobytes(), dperms.shape)
    Xj, Jcj = jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy())
    state_j = tuple(jnp.asarray(s.numpy()) for s in state[:5]) + (0, jnp.zeros(50), jnp.zeros((), jnp.int32))

    def jax_chunk(rtol):
        return jax_it._pcg_chunk_jit(False)(
            state_j, F_j, Xj, Jcj, Xj, Jcj, SIG, LAM, b_norm, rtol, n_atoms=N_ATOMS, desc_perms_key=key,
            use_E_cstr=False, chunk_iters=50, apply_mode='chunk', mm='native', mesh=None)

    rtol = 1e-4
    if early:
        rtol = 1.01 * float(np.asarray(jax_chunk(rtol)[6])[:25].min()) / b_norm
    x_j, _, _, _, _, it_j, hist_j, n_bad_j = jax_chunk(rtol)
    blocks = it_mod._ChunkBlocks(F, it_mod.matvec_tables(X, Jc, dperms), SIG, LAM, b_norm, rtol, n=len(y),
                                 n_atoms=N_ATOMS, use_E_cstr=False, mm='native', graph=False)
    x, _, _, _, _, it, hist, n_bad = blocks(state, 50)
    assert int(it) == int(it_j) and int(n_bad) == int(n_bad_j) and (int(it) < 25) == early
    np.testing.assert_allclose(hist.numpy()[:10], np.asarray(hist_j)[:10], rtol=1e-6)
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=5e-2)
    assert np.linalg.norm(x.numpy() - np.asarray(x_j)) <= 5e-2 * np.linalg.norm(np.asarray(x_j))


# -- whole Nystrom solves ------------------------------------------------------


def _ozaki_budget_gb(m, k):
    """The budget at which the streamed 8-slice plan affords k points of an
    M-point, 6-atom system (tests/test_torch_iterative.py's)."""
    return (1.5e9 + k * 9.0 * m * 18 * 18 + 1) / 0.72 / 1024**3


# The solver's log lines that record a decision of the CG driver.
EVENTS = ('restarting with k=', 'residual replacement', 'memory cap', 'escalating', 'PSD guard', 'deep-stagnation',
          'stalled')


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _eventful_solve(ds, graphs_on):
    """A slice-stack solve from a warm start below the cap whose monitor
    reports a stall after every chunk of 5 iterations and whose recursion is
    re-anchored at every chunk (replacement drift bound 0): growth restarts
    up to the cap, then re-seeds and a climb of the matvec rung (from the
    last Ozaki rung to 'native'), to the deep-stagnation bound. Returns the solve's results, its decisions (the
    log lines of EVENTS) and, in order, each factor built and the factor
    each preconditioner apply read."""
    events = []
    build, precond = it_mod.Iterative._build_factor, it_mod._precond

    def built(self, *a, **k):
        F, lev = build(self, *a, **k)
        events.append(('build', F))
        return F, lev

    logger, handler = logging.getLogger(LOGGER), _Messages()
    level = logger.level
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (('CG_STEPS_HIST_LEN', 4), ('EFF_RESTART_THRESH', 100), ('CG_CHUNK_ITERS', 5),
                            ('RESEED_STAGNATION_ITERS', 0), ('RESID_REPLACE_DRIFT', 0.0), ('MAX_NUM_RESTARTS', 10)):
            mp.setattr(it_mod, name, value)
        mp.setattr(it_mod.Iterative, '_build_factor', built)
        mp.setattr(it_mod, '_precond', lambda F, v, lam: events.append(('precond', F)) or precond(F, v, lam))
        task = _task(ds, 24, 41)
        task['inducing_pts_idxs'] = np.random.default_rng(0).choice(24 * 18, 3 * 18, replace=False)
        task['solver_mv_mm'] = 'ozaki10'  # one climb, to 'native'
        X, Jc, dperms, y, y_std = _system(task)
        solver = it_mod.Iterative(GDMLTrain(device='cpu'), max_memory=_ozaki_budget_gb(24, 5),
                                  factor_mode='ozaki', device='cpu')
        solver._graphs = graphs_on
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            out = solver.solve(task, X, Jc, dperms, y, y_std, tol=0.0)
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
    return out, [m for m in handler.messages if any(e in m for e in EVENTS)], events


@pytest.fixture(scope='module')
def eventful(ds):
    """The eventful solve by the blocks and by the eager loop."""
    return {graphs_on: _eventful_solve(ds, graphs_on) for graphs_on in (True, False)}


def test_solve_blocks_equal_eager_through_restarts_and_climbs(eventful):
    """The same eventful solve by the blocks and by the eager loop: a growth
    restart, residual replacements, a re-seed and a rung climb each happen,
    and the two take the same iterations, inducing points and decisions
    (their log lines, word for word), and return the same coefficients bit
    for bit."""
    (ours, log_b, _), (ref, log_e, _) = eventful[True], eventful[False]
    for what in EVENTS[:4]:
        assert any(what in m for m in log_b), what
    assert log_b == log_e
    assert ours[2] == ref[2] and np.array_equal(ours[5], ref[5]) and torch.equal(ours[0], ref[0])
    assert torch.isfinite(ours[0]).all()


def test_swapped_factor_is_read_after_the_graphs_drop(eventful):
    """Through the growth restarts of the eventful solve by the blocks every
    preconditioner apply reads the factor built last: the blocks made for
    an earlier factor, which read it by address, were dropped with it."""
    events = eventful[True][2]
    assert len([F for kind, F in events if kind == 'build']) >= 3
    current = None
    for kind, F in events:
        if kind == 'build':
            current = F
        else:
            assert F is current


def test_graphs_only_on_one_card(monkeypatch):
    """The blocks are chosen exactly on a CUDA device without a mesh (with no
    argument of their own): ``_graphs`` on the solvers, and the refinement's
    ``graph`` (None: the eager loop)."""
    assert it_mod.Iterative(device='cpu')._graphs is False
    with one_rank_world() as mesh:
        assert it_mod.Iterative(mesh=mesh, device='cpu')._graphs is False
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert it_mod.Iterative(device='cuda')._graphs is True
    solver = an.Analytic()
    assert solver._refine_graph(torch.device('cuda')) is True
    assert solver._refine_graph(torch.device('cpu')) is None
    solver._graphs = False
    assert solver._refine_graph(torch.device('cuda')) is None
    solver._graphs = True
    assert solver._refine_graph(torch.device('cpu')) is False
    params = {
        it_mod.Iterative.__init__: ['self', 'gdml_train', 'callback', 'max_memory', 'mesh', 'factor_mode',
                                    'factor_slices', 'seed', 'device'],
        it_mod.Iterative.solve: ['self', 'task', 'R_desc', 'R_d_desc', 'desc_perms', 'y', 'y_std', 'tol',
                                 'save_progr_callback', 'max_seconds'],
        an.Analytic.__init__: ['self', 'gdml_train', 'callback', 'mesh', 'max_memory', 'mesh_precision'],
        an.Analytic.solve: ['self', 'task', 'R_desc', 'R_d_desc', 'desc_perms', 'y'],
    }
    for fn, names in params.items():
        assert list(inspect.signature(fn).parameters) == names, fn


# -- the refinement chunk (grid and pair routes) -------------------------------

R_ATOMS, R_SIG = 5, 4.0
R_PERMS = np.arange((R_ATOMS * (R_ATOMS - 1)) // 2)[None, :]


def _refine_system(m, use_E_cstr):
    """tests/test_torch_analytic_pair.py's inputs: N=5, seed 3, the first m
    frames, the JAX package's descriptors; with energy constraints the
    centered energies after the forces."""
    ds = generate_md_dataset(n_atoms=R_ATOMS, n_frames=m + 4, seed=3)
    X, Jc = (torch.as_tensor(np.asarray(t)) for t in jax_descriptor_batch(jnp.asarray(ds['R'][:m].reshape(m, -1)),
                                                                          R_ATOMS))
    F = ds['F'][:m]
    y = F.reshape(-1)
    if use_E_cstr:
        y = np.concatenate([y, -(ds['E'][:m] - ds['E'][:m].mean())])
    return X, Jc, y / np.std(F), {'sig': R_SIG, 'lam': LAM, 'use_E_cstr': use_E_cstr}


def _pow2(e):
    return jax.lax.bitcast_convert_type((e.astype(jnp.int32) + 127) << 23, jnp.float32)


def _exact_row_scale(hi):
    """The JAX package's ``_row_scale`` with its scale as exponent bits
    (tests/test_torch_analytic_pair.py: ``jnp.exp2`` is inexact on XLA:CPU
    outside exponents of about [-12, 12])."""
    _, e = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(hi), axis=1, keepdims=True), jnp.finfo(jnp.float32).tiny))
    return _pow2(e)


def _exact_split_global_int8(x64, n_slices=8, q=jax_ozaki.Q_BITS):
    """The JAX package's ``split_global_int8`` with its scale as exponent
    bits."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    _, e = jnp.frexp(jnp.maximum(jnp.max(jnp.abs(hi)), jnp.finfo(jnp.float32).tiny))
    sigma = _pow2(e)
    slices, t = jax_ozaki._extract_slices(hi / sigma, 4, q)
    if n_slices > 4:
        more, _ = jax_ozaki._extract_slices(t + (lo / sigma) * jnp.float32(2.0 ** (q * 4)), n_slices - 4, q)
        slices += more
    return jnp.stack(slices), sigma


def _jax_lmax(X, Jc, use_E_cstr):
    key = (np.ascontiguousarray(R_PERMS.astype(np.int64)).tobytes(), R_PERMS.shape)
    return float(jax_an._lmax_power(jnp.asarray(X.numpy()), jnp.asarray(Jc.numpy()), R_SIG, LAM, n_atoms=R_ATOMS,
                                    desc_perms_key=key, use_E_cstr=use_E_cstr))


def _route(solver, route, X, Jc, y, task, lmax):
    if route == 'grid':
        return solver._solve_grid_pcg(task, X, Jc, R_PERMS, y, R_SIG, LAM, R_ATOMS, lmax=lmax)
    return solver._solve_pair_pcg(task, X, Jc, R_PERMS, y, R_SIG, LAM, R_ATOMS, target_block=512, lmax=lmax)


@pytest.mark.parametrize('use_E_cstr', [False, True], ids=['forces', 'E_cstr'])
@pytest.mark.parametrize('route', ['grid', 'pair'])
def test_refinement_blocks_equal_eager_and_match_jax(route, use_E_cstr, monkeypatch):
    """The grid and pair routes' solves with the refinement in blocks and by
    the eager loop: the same iterations and coefficients bit for bit (chunks
    of 20 iterations, so that each solve runs several chunks); the counts
    against the JAX package's at the same lmax as its parity tests hold the
    eager loop: the grid within 10% or 3, the pair within 10 (JAX reads its
    residual every 10 iterations; its scales made exact)."""
    m = 20 if route == 'grid' else 45
    X, Jc, y, task = _refine_system(m, use_E_cstr)
    lmax = _jax_lmax(X, Jc, use_E_cstr)
    monkeypatch.setattr(an, 'PCG_CHUNK_ITERS', 20)
    solvers = {}
    for graphs_on in (True, False):
        solver = solvers[graphs_on] = an.Analytic()
        solver._graphs = graphs_on
        solver.alphas = _route(solver, route, X, Jc, y, task, lmax)
        assert solver.route == route
    ours, ref = solvers[True], solvers[False]
    assert ours.pcg_iters == ref.pcg_iters > 20 and torch.equal(ours.alphas, ref.alphas)
    monkeypatch.undo()
    jax_solver = jax_an.Analytic(max_memory=64)
    if route == 'grid':
        jax_solver._solve_grid_pcg(task, X.numpy(), Jc.numpy(), R_PERMS, y, R_SIG, LAM, R_ATOMS, lmax=lmax)
        bound = max(0.1 * jax_solver.pcg_iters, 3)
    else:
        monkeypatch.setattr(jax_ozaki, '_row_scale', _exact_row_scale)
        monkeypatch.setattr(jax_ozaki, 'split_global_int8', _exact_split_global_int8)
        jax_solver._solve_pair_pcg(task, X.numpy(), Jc.numpy(), R_PERMS, y, R_SIG, LAM, R_ATOMS, target_block=512,
                                   lmax=lmax)
        bound = 10
    assert abs(ours.pcg_iters - jax_solver.pcg_iters) <= bound, (ours.pcg_iters, jax_solver.pcg_iters)


def test_refinement_best_iterate_is_a_copy(monkeypatch):
    """A chunk's results from the blocks (the refinement keeps its best
    iterate from them) are unchanged by the next chunk."""
    X, Jc, y, task = _refine_system(20, False)
    captured = {}

    def keep(A_apply, M_apply, y, graph=None, timer=None):
        captured.update(A=A_apply, M=M_apply, y=y)
        return refine(A_apply, M_apply, y, graph, timer)

    refine = an._refinement_cg
    monkeypatch.setattr(an, '_refinement_cg', keep)
    solver = an.Analytic()
    solver._graphs = True
    _route(solver, 'grid', X, Jc, y, task, 2.0)
    yv = captured['y']
    blocks = an._CholBlocks(captured['A'], captured['M'], float(torch.linalg.vector_norm(yv)), 0.0, yv, False)
    z0 = captured['M'](yv)
    first, _ = blocks((torch.zeros_like(yv), yv, z0, z0, yv @ z0, None), 20)
    kept = tuple(t.clone() for t in first)
    second, _ = blocks(first, 20)
    assert _same(first, kept) and int(first[5]) == int(second[5]) == 20 and not torch.equal(first[0], second[0])
