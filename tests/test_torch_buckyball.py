"""The benchmark's MD22 buckyball-catcher configuration (``buckyball_catcher``,
N = 148) and its cell ``buckyball.md_nve`` at small sizes on the CPU: NVE
past the split-T width takes the unfused substep (K1 by the wide route) and follows the plain
reference (``benchmark/reference/md.py``) and the JAX package's MDEngine;
``md.unfused_steps`` counts its steps, k a program call, under a profiler
session only; the reader of ``unfused_step_share.md``; the new files load
through the harness by name; the train kind hands its ``train_args`` to
``GDMLTrain.train``; and an explicit ``factor_slices`` builds the f64 factor,
not the slice stack. On a card (marked ``card``; skipped without one): 1,000
unfused steps at the buckyball width from the graphs against the same steps
run eagerly. This file imports JAX only inside the test that compares with
the JAX package, which it skips where JAX is missing: its card test runs on
a machine without it (``python3 -m pytest --noconftest
tests/test_torch_buckyball.py -m card``)."""

import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from benchmark import generator, harness, synthetic  # noqa: E402
from benchmark.reference import md as ref_md  # noqa: E402
from benchmark.reference import predict as ref_predict  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from sgdml_tpu_torch import md  # noqa: E402
from sgdml_tpu_torch.md import MDEngine  # noqa: E402
from sgdml_tpu_torch.ops import descriptor as desc_ops  # noqa: E402
from sgdml_tpu_torch.ops import fused_predict  # noqa: E402
from sgdml_tpu_torch.solvers.analytic import Analytic  # noqa: E402
from sgdml_tpu_torch.solvers.iterative import Iterative  # noqa: E402
from sgdml_tpu_torch.train import GDMLTrain  # noqa: E402
from sgdml_tpu_torch.utils import io, profiling  # noqa: E402

BENCH = CHECKOUT / 'benchmark'
GOLDEN = pathlib.Path(__file__).parent / 'golden'
SPEC = json.loads((CHECKOUT / 'BENCHMARK.json').read_text())
MD_CELL = 'buckyball.md_nve'
DT = 0.01
# N = 130: D = 8,385 inverse distances, 67,080 bytes of f64 descriptor, the
# narrowest molecule past split T's 64 KiB at one geometry (N <= 128 fits).
WIDE = 130
# Positions, velocities (each over its largest entry) and the energy (over
# its own size) after 100 steps, as the MD step's parity tests hold f64
# (tests/test_torch_md_step.py, TOL): the port's contraction goes through
# the Gram identity on centred tables, the reference through direct
# descriptor differences, so each step differs in the last bits and the
# trajectory carries that on.
TOL_R, TOL_V, TOL_E = 1e-11, 1e-10, 1e-10


def _random_model(n_atoms, n_train, seed=0):
    """A model dict at width ``n_atoms`` without training: the descriptors of
    ``n_train`` synthetic frames (``benchmark/synthetic.py``), seeded
    coefficients scaled so that the contracted Jacobians are ~1e-2, sig at
    the typical descriptor distance, std and c away from 1 and 0; the raw
    inputs of the plain reference's model; and a frame outside the table."""
    ds = synthetic.generate_md_dataset(n_atoms, n_train + 1, 3, seed, burn_in=20)
    R = torch.as_tensor(ds['R'][:n_train].reshape(n_train, -1))
    X, Jc = desc_ops.descriptor_batch(R, n_atoms)
    rng = np.random.default_rng(seed)
    alphas = torch.as_tensor(rng.normal(size=(n_train, 3 * n_atoms)))
    alphas *= 1e-2 / float(desc_ops.jac_dot_vec(Jc, alphas, n_atoms).std())
    JA = desc_ops.jac_dot_vec(Jc, alphas, n_atoms)
    d = X[:, None] - X[None]
    sig = float(np.sqrt(5.0) * torch.linalg.vector_norm(d, dim=-1).max())
    std, c = 1.3, -2.0
    model = {'type': 'm', 'z': ds['z'], 'perms': np.arange(n_atoms)[None], 'R_desc': X.T.numpy(),
             'R_d_desc_alpha': JA.numpy(), 'alphas_F': alphas.reshape(-1).numpy(), 'sig': sig, 'std': std, 'c': c,
             'lam': 1e-10}
    raw = (ds['R'][:n_train], alphas.reshape(-1).numpy(), sig, std, c)
    return model, raw, ds['R'][n_train]


def _masses(model):
    return np.array([generator.MASSES[int(z)] for z in model['z']])


def _velocities(masses, kT=0.06, seed=0):
    return np.random.default_rng(seed).normal(size=(len(masses), 3)) * np.sqrt(kT / masses)[:, None]


@pytest.fixture(scope='module')
def wide():
    """``(model, raw, r0, v0, masses)`` at N = 130 on a table of 6 rows."""
    model, raw, r0 = _random_model(WIDE, 6)
    masses = _masses(model)
    return model, raw, r0, _velocities(masses), masses


def _no_fused_step(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError('md_step called past the split-T width')

    monkeypatch.setattr(fused_predict, 'md_step', refused)


# -- the unfused substep against the plain reference -----------------------------


@pytest.mark.parametrize('max_steps', [100, 30])
def test_wide_nve_takes_the_unfused_substep_and_follows_the_reference(wide, monkeypatch, max_steps):
    """100 steps, a snapshot every 50, in programs of ``max_steps`` steps
    at most (50, or 30 and 20): the engine leaves the fused step at this
    width and ends where the reference's velocity Verlet ends."""
    model, raw, r0, v0, masses = wide
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', max_steps)
    _no_fused_step(monkeypatch)
    eng = MDEngine(model, masses=masses, device='cpu')
    D = eng.tables.Xt.shape[1]
    assert D == 8385 and fused_predict.route(D, 1) == 'wide' and not eng._fused_nve()
    R, V, E, ke = eng.run_nve(r0, v0, DT, 100, snapshot_every=50)
    ref = ref_predict.Model(*raw, 'cpu', torch.float64)
    r, v, E_r, ke_r = ref_md.integrate(ref, r0[None], v0[None], masses, DT, 100)
    assert R.shape == (2, WIDE, 3)
    assert np.abs(R[-1] - r[0]).max() <= TOL_R * np.abs(r[0]).max()
    assert np.abs(V[-1] - v[0]).max() <= TOL_V * np.abs(v[0]).max()
    assert abs(E[-1] - E_r[0]) <= TOL_E * abs(E_r[0]) and abs(ke[-1] - ke_r[0]) <= TOL_E * ke_r[0]
    assert np.abs(R[-1] - r0).max() > 1e-2  # the atoms moved


@pytest.mark.parametrize('max_steps', [100, 30])
def test_wide_nve_follows_the_jax_md_engine(wide, monkeypatch, max_steps):
    """The same 100 steps, a snapshot every 50, in programs of 50 or of 30
    and 20, against the JAX package's ``MDEngine.run_nve`` on the same
    model, start and masses: every snapshot's R, V, E_pot and E_kin at the
    f64 tolerances of the MD parity tests against JAX
    (tests/test_torch_md.py: rtol 1e-8, atol 1e-12)."""
    jax_md = pytest.importorskip('sgdml_tpu.md')
    model, _, r0, v0, masses = wide
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', max_steps)
    _no_fused_step(monkeypatch)
    out = MDEngine(model, masses=masses, device='cpu').run_nve(r0, v0, DT, 100, snapshot_every=50)
    ref = jax_md.MDEngine(model, masses=masses).run_nve(r0, v0, DT, 100, snapshot_every=50)
    assert out[0].shape == (2, WIDE, 3)
    for ours, theirs, name in zip(out, ref, ('R', 'V', 'E_pot', 'E_kin')):
        assert ours.shape == np.asarray(theirs).shape, name
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=name)


@pytest.mark.parametrize('n_atoms', [129, 148])
def test_nve_stays_unfused_where_k1_takes_the_wide_route(n_atoms):
    """At 129 atoms (D = 8,256, the narrowest past split T's 64 KiB) and at
    the buckyball catcher's 148, K1 at one geometry takes the wide route
    and the NVE step stays the unfused substep: the fused step kernel holds
    its query in a block's shared memory, which the wide route does not."""
    model, _, _ = _random_model(n_atoms, 3)
    eng = MDEngine(model, masses=_masses(model), device='cpu')
    D = eng.tables.Xt.shape[1]
    assert D == n_atoms * (n_atoms - 1) // 2 and D * 8 > fused_predict.SPLIT_T_XQ_BYTES
    assert fused_predict.route(D, 1) == 'wide' and not eng._fused_nve()


# -- md.unfused_steps -------------------------------------------------------------


def _counts(monkeypatch):
    """The (name, n) of every ``profiling.count`` of an MD step counter."""
    seen = []
    count = profiling.count

    def spy(name, n=1):
        if name.startswith('md.'):
            seen.append((name, n))
        count(name, n)

    monkeypatch.setattr(profiling, 'count', spy)
    return seen


@pytest.mark.parametrize('case', ['unfused', 'unfused_no_session', 'fused', 'langevin'])
def test_md_steps_are_counted_by_route_under_a_profiler_session(wide, monkeypatch, case):
    """150 steps, a snapshot every 50, programs of at most 20 steps (20, 20
    and 10 a block): the unfused substep adds each program's k steps to
    ``md.unfused_steps``, and only while a profiler session records; the
    fused step (the golden N = 5 model) counts none of them, nor does
    Langevin."""
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', 20)
    seen = _counts(monkeypatch)
    if case == 'fused':
        model = io.load_dict(str(GOLDEN / 'model_ref.npz'))
        r0 = np.load(GOLDEN / 'train_predict_ref.npz')['R_test'][0].reshape(-1, 3)
        masses = _masses(model)
        v0 = _velocities(masses)
    else:
        model, _, r0, v0, masses = wide
    eng = MDEngine(model, masses=masses, device='cpu')
    profiling.clear()

    def run():
        if case == 'langevin':
            return eng.run_langevin(r0, v0, DT, 150, friction=0.1, kT=0.06, seed=1, snapshot_every=50)
        return eng.run_nve(r0, v0, DT, 150, snapshot_every=50)

    if case == 'unfused_no_session':
        run()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run()
    counted = profiling.counter('md.unfused_steps'), profiling.counter('md.fused_steps')
    if case == 'unfused':
        assert seen == [('md.unfused_steps', k) for k in (20, 20, 10) * 3] and counted == (150, 0)
    elif case == 'fused':
        assert counted == (0, 150) and {name for name, _ in seen} == {'md.fused_steps'}
    else:
        assert counted == (0, 0)


# -- unfused_step_share.md -------------------------------------------------------------

MS = 1_000_000  # ns


@pytest.mark.parametrize('counters, share', [
    ({'md.unfused_steps': 10_000, 'graph.captures': 2}, 100.0),
    ({'md.unfused_steps': 2_500, 'md.fused_steps': 7_500}, 25.0),
    ({'md.fused_steps': 10_000}, 0.0),
    ({'graph.captures': 2}, None),  # a program that counts no step by route
    (None, None),  # no md.trajectory span in the window
])
def test_unfused_step_share_reads_the_counter_over_the_window_steps(monkeypatch, counters, share):
    spans = [] if counters is None else [
        ('md.trajectory', 1000.0 * i * MS, 1000.0 * (i + 1) * MS, i + 1, None, i + 1, {'steps': 5_000})
        for i in range(2)]
    monkeypatch.setattr(profiling._RECORDER, 'spans', spans)
    monkeypatch.setattr(profiling._RECORDER, 'counters', dict(counters or {}))
    run = types.SimpleNamespace(window_s=2.0, units=2, work=10_000, records={'steps': 10_000})
    got = harness._reader(BENCH, 'unfused_step_share.md')(run)
    assert got == (None if share is None else pytest.approx(share))


# -- the new files, by name -----------------------------------------------------------


def test_the_new_cell_loads_by_name_with_its_metrics():
    cell = harness.load_cell(MD_CELL)
    entry = next(w for w in SPEC['workloads'] if w['name'] == MD_CELL)
    assert cell.chips == 1 and entry['chips'] == 1 and len(entry['why']) <= 200
    assert generator.load(cell.traffic['kind']) is not None
    assert set(cell.workload) == {'trace_seconds', 'limits'} and cell.workload['limits']['resid'] == 1e-4
    assert cell.traffic['kind'] == 'md' and cell.traffic['chunk_steps'] == 5000
    assert {m['name'] for m in cell.end_to_end} == {'setup_s', 'md_steps_per_s'}
    assert {m['name'] for m in cell.per_layer} == {'k1_roofline.md', 'idle_share.md', 'mfu.md', 'unfused_step_share.md',
                                                  'k1_wide_share.md'}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness._reader(BENCH, m['name']))


def test_the_buckyball_configuration_is_md22_s_width_and_goes_to_cg():
    """148 atoms, 10,878 inverse distances, 600 points with energies and
    nothing cut; its own source; 266,400 unknowns past the analytic
    solver's dense, in-place and grid windows on an 80 GB card, and K1 at
    one geometry past split T."""
    conf = next(c for c in SPEC['configs'] if c['name'] == 'buckyball_catcher')
    config = harness.load_cell(MD_CELL).config
    assert conf['reduced'] == config['reduced'] == [] and conf['source'] == config['source']
    assert [c['source'] for c in SPEC['configs']].count(conf['source']) == 1
    assert (config['n_atoms'], config['n_train'], config['use_E'], config['dtype']) == (148, 600, True, 'float64')
    n_atoms, m = config['n_atoms'], config['n_train']
    D = n_atoms * (n_atoms - 1) // 2
    assert D == 10878 and 3 * n_atoms * m == 266_400
    budget = 80e9
    assert Analytic.est_memory_requirement(m, n_atoms, False) > budget
    assert Analytic.est_memory_grid(m, n_atoms) > budget
    assert fused_predict.route(D, 1) == 'wide' and fused_predict.route(D, m) == 'two_pass'
    assert config['cg_tol'] == harness.load_cell(MD_CELL).workload['limits']['resid']


# -- the train kind and factor_slices ---------------------------------------------


TINY = dict(name='tiny', n_atoms=6, n_train=30, n_valid=10, n_frames=80, sig=5, lam=1e-10, use_E=True,
            use_E_cstr=False, use_sym=False, dtype='float64', molecule_seed=3,
            trajectory={'dt': 0.05, 'friction': 0.05, 'temperature': 0.06, 'burn_in': 50})


def test_the_train_kind_hands_train_args_to_train(monkeypatch):
    """The mix's ``train_args`` (``atat.train_cg600``'s) reach
    ``GDMLTrain.train`` as they stand, in the warm-up and in a unit; the
    model solves its system."""
    seen = []
    train = GDMLTrain.train

    def spy(self, task, **kw):
        seen.append(kw)
        return train(self, task, **kw)

    monkeypatch.setattr(GDMLTrain, 'train', spy)
    traffic = dict(harness.load_cell('atat.train_cg600').traffic, check_models=1)
    assert traffic['train_args'] == {'solver': 'cg'}
    gen = generator.make(TINY, traffic, 2**31 + 5, 'cpu')
    gen.setup()
    gen.unit()
    assert seen == [{'solver': 'cg'}] * 2
    model = gen.models[-1]
    assert model['solver_name'] == 'cg'
    got = ref_train.judge(model, gen.task['R_train'], gen.task['F_train'], gen.task['E_train'], TINY['sig'],
                          TINY['lam'], 'cpu')
    assert got['resid'] <= 1e-4 and got['model'] <= 1e-6


@pytest.mark.parametrize('factor_slices', [None, 8])
def test_an_explicit_factor_slices_builds_the_f64_factor(monkeypatch, factor_slices):
    """``GDMLTrain.train(factor_slices=...)`` (and ``sgdml train
    --factor_slices``) reaches ``Iterative``, whose ``factor_mode`` stays
    ``'auto'``, the f64 factor: the slice count is not used, and no
    training through ``train()`` builds the slice stack. A change that
    routes the slices to the stack changes this test."""
    built = []
    use_stack = Iterative._use_ozaki_factor

    def spy(self):
        built.append((self.factor_mode, self.factor_slices, use_stack(self)))
        return built[-1][2]

    monkeypatch.setattr(Iterative, '_use_ozaki_factor', spy)
    seeds = generator.Seeds(2**31 + 9)
    trainer = GDMLTrain(device='cpu')
    task = generator.task(trainer, TINY, generator.dataset(TINY, seeds, TINY['n_frames']), seeds, TINY['n_valid'])
    model = trainer.train(task, solver='cg', factor_slices=factor_slices)
    assert model['solver_name'] == 'cg' and built
    assert set(built) == {('auto', 'auto' if factor_slices is None else factor_slices, False)}


# -- On the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


@pytest.mark.card
def test_wide_nve_graphs_repeat_the_eager_steps_on_the_card(card):
    """At the buckyball width (N = 148, T = 600, D = 10,878): 1,000 steps,
    a snapshot every 100, replayed from the 100-step graphs, give the bits
    of the same steps enqueued one by one; K1 runs by the wide route, once
    a step, once for each snapshot's energy and once for the first forces,
    and ``md.unfused_steps`` counts every step, ``k1.wide_launches`` every
    K1 launch."""
    model, _, r0 = _random_model(148, 600)
    masses = _masses(model)
    v0 = _velocities(masses)
    eng = MDEngine(model, masses=masses, device=card)
    assert not eng._fused_nve()
    fused_predict.reset_launches()
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = eng.run_nve(r0, v0, DT, 1000, snapshot_every=100)
        steps = profiling.counter('md.unfused_steps')
        k1 = profiling.counter('k1.launches'), profiling.counter('k1.wide_launches')
    assert steps == 1000 and fused_predict.LAUNCHES == 1011 and k1 == (1011, 1011)
    assert fused_predict.PATH_LAUNCHES['wide'] == 1011
    assert fused_predict.PATH_LAUNCHES['pass_a'] == fused_predict.PATH_LAUNCHES['md_step'] == 0
    eager = MDEngine(model, masses=masses, device=card)
    eager._graphs = False
    ref = eager.run_nve(r0, v0, DT, 1000, snapshot_every=100)
    assert all(np.isfinite(x).all() for x in out)
    for ours, theirs in zip(out, ref):
        np.testing.assert_array_equal(ours, theirs)
