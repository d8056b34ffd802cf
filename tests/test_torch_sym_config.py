"""The benchmark's symmetric configuration (``aspirin_sym``) and the sigma
sweep at a small size on the CPU: the C3v molecule of
``benchmark/synthetic_sym.py``, the port's permutation-summed assembly,
training and prediction against the plain reference of
``benchmark/reference/sym.py``, the ``assembly.perm_blocks`` counter, the
two new metric readers and the drivers of the two cells."""

from __future__ import annotations

import ast
import copy
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from benchmark import counts, counts_sym, generator, harness, synthetic_sym  # noqa: E402
from benchmark.reference import gdml as ref_gdml  # noqa: E402
from benchmark.reference import sym as ref_sym  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.synthetic import MorseField  # noqa: E402
from sgdml_tpu_torch.ops import descriptor as desc_ops  # noqa: E402
from sgdml_tpu_torch.ops.kernel import assemble_kernel  # noqa: E402
from sgdml_tpu_torch.perm import find_perms  # noqa: E402
from sgdml_tpu_torch.predict import GDMLPredict, desc_perm_table  # noqa: E402
from sgdml_tpu_torch.train import GDMLTrain  # noqa: E402
from sgdml_tpu_torch.utils import profiling  # noqa: E402

BENCH = CHECKOUT / 'benchmark'
SIZES = [6, 9, 21]
CELL = 'aspirin_sym.train_inplace'
SWEEP = 'aspirin.train_sigma_sweep'
LIMITS = json.loads((BENCH / 'workloads' / (CELL + '.json')).read_text())['limits']
SIG = 10.0
LAM = 1e-10


def _as_set(perms):
    return {tuple(int(i) for i in p) for p in perms}


def _geometries(n_atoms, m, seed, scale=0.1):
    """m seeded random displacements of the molecule's reference geometry."""
    pos = synthetic_sym.make_molecule(n_atoms, seed=3)[0]
    return pos[None] + scale * np.random.default_rng(seed).normal(size=(m, n_atoms, 3))


def _session():
    profiling.clear()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope='module')
def sym_task():
    """A symmetric task of the N = 9 molecule (12 points), its perms from
    the dataset, and a model of it trained on the CPU."""
    ds = synthetic_sym.generate_md_dataset(9, 60, 3, 11)
    trainer = GDMLTrain(device='cpu')
    task = trainer.create_task(ds, 12, ds, 5, sig=SIG, lam=LAM, use_sym=True, rng=np.random.RandomState(2))
    return ds, task, trainer.train(task)


# -- the molecule ---------------------------------------------------------------


@pytest.mark.parametrize('n_atoms', SIZES)
def test_the_symmetry_search_finds_exactly_the_molecule_s_six_permutations(n_atoms):
    ds = synthetic_sym.generate_md_dataset(n_atoms, 40, 3, 5)
    found = find_perms(ds['R'], ds['z'], max_processes=2)
    assert len(found) == synthetic_sym.GROUP_ORDER
    assert _as_set(found) == _as_set(ds['perms'])


@pytest.mark.parametrize('n_atoms', SIZES)
def test_the_morse_field_is_invariant_under_each_permutation(n_atoms):
    pos, _ = synthetic_sym.make_molecule(n_atoms, seed=3)
    perms = synthetic_sym.group_perms(pos)
    field = MorseField(pos)
    R = _geometries(n_atoms, 5, 1)
    E, F = field.energy_forces(R)
    for perm in perms:
        E_p, F_p = field.energy_forces(R[:, perm])
        # The same pair terms summed in another order: float64 rounding.
        np.testing.assert_allclose(E_p, E, rtol=1e-13, atol=0)
        np.testing.assert_allclose(F_p, F[:, perm], rtol=0, atol=1e-13 * np.abs(F).max())


def test_the_dataset_s_frames_are_relabelled_and_its_labels_follow():
    ds = synthetic_sym.generate_md_dataset(9, 30, 3, 5)
    field = MorseField(synthetic_sym.make_molecule(9, seed=3)[0])
    E, F = field.energy_forces(ds['R'])
    np.testing.assert_allclose(E, ds['E'], rtol=1e-12)
    np.testing.assert_allclose(F, ds['F'], rtol=0, atol=1e-12 * np.abs(F).max())
    assert ds['perms'].shape == (6, 9) and (ds['perms'][0] == np.arange(9)).all()
    a = synthetic_sym.generate_md_dataset(9, 30, 3, 5)
    np.testing.assert_array_equal(a['R'], ds['R'])
    assert not np.array_equal(synthetic_sym.generate_md_dataset(9, 30, 3, 6)['R'], ds['R'])


def test_a_size_without_an_orbit_is_refused():
    with pytest.raises(ValueError):
        synthetic_sym.make_molecule(5)


# -- the reference against the port -----------------------------------------------


@pytest.mark.parametrize('n_atoms', SIZES)
def test_the_reference_s_descriptor_permutations_are_the_port_s(n_atoms):
    perms = synthetic_sym.group_perms(synthetic_sym.make_molecule(n_atoms, seed=3)[0])
    np.testing.assert_array_equal(ref_sym.desc_perms(perms), desc_perm_table(perms))


def test_a_permuted_descriptor_is_the_descriptor_of_the_relabelled_geometry():
    perms = synthetic_sym.group_perms(synthetic_sym.make_molecule(9, seed=3)[0])
    R = torch.as_tensor(_geometries(9, 4, 2))
    x = ref_gdml.descriptors(R)[0]
    for perm, dp in zip(perms, ref_sym.desc_perms(perms)):
        torch.testing.assert_close(x[:, dp], ref_gdml.descriptors(R[:, perm])[0], rtol=0, atol=0)


@pytest.mark.parametrize('tiles', [(12, 12), (5, 7)])
def test_the_port_s_assembly_is_the_reference_s_permutation_summed_rows(tiles):
    n_atoms, m = 9, 12
    perms = synthetic_sym.group_perms(synthetic_sym.make_molecule(n_atoms, seed=3)[0])
    R = torch.as_tensor(_geometries(n_atoms, m, 4))
    X, Jc = desc_ops.descriptor_batch(R.reshape(m, -1), n_atoms)
    K = assemble_kernel(X, Jc, desc_perm_table(perms), SIG, n_atoms, tile_i=tiles[0], tile_j=tiles[1])
    x, jc = ref_gdml.descriptors(R)
    J = ref_gdml.full_jacobian(jc, n_atoms)
    ref = ref_sym.kernel_rows(x, J, x, J, ref_sym.desc_perms(perms), SIG)
    # The same sums in another order (the closed-form Gram against dense
    # products): float64 rounding, far below any entry that matters.
    torch.testing.assert_close(K, ref, rtol=0, atol=1e-12 * float(ref.abs().max()))
    # Summed over a group, K is symmetric.
    torch.testing.assert_close(K, K.T, rtol=0, atol=1e-12 * float(ref.abs().max()))


def test_a_symmetric_training_meets_the_cell_s_limits(sym_task):
    ds, task, model = sym_task
    assert _as_set(task['perms']) == _as_set(ds['perms']) and len(model['perms']) == 6
    got = ref_sym.judge(model, task['R_train'], task['F_train'], task['E_train'], ds['perms'], SIG, LAM, 'cpu')
    assert got['resid'] <= LIMITS['resid'] and got['model'] <= LIMITS['model'], got


def test_a_training_that_ignores_the_group_fails_the_resid_limit(sym_task):
    """The control's ``perms_ignored``: the same task trained without the
    group, judged for it."""
    ds, task, _ = sym_task
    plain = dict(task, use_sym=False, perms=np.arange(9)[None, :])
    model = GDMLTrain(device='cpu').train(plain)
    got = ref_sym.judge(model, task['R_train'], task['F_train'], task['E_train'], ds['perms'], SIG, LAM, 'cpu')
    assert got['resid'] > LIMITS['resid'], got
    # Judged as what it is, the same model is sound: the fault is the group.
    plain_got = ref_train.judge(model, task['R_train'], task['F_train'], task['E_train'], SIG, LAM, 'cpu')
    assert plain_got['resid'] <= LIMITS['resid']


@pytest.mark.parametrize('fault', ['state_unchanged', 'answer_altered', 'table_altered'])
def test_a_broken_symmetric_model_fails_a_limit(sym_task, fault):
    ds, task, model = sym_task
    if fault == 'state_unchanged':
        model = dict(model, alphas_F=np.zeros_like(model['alphas_F']))
    elif fault == 'answer_altered':
        model = dict(model, alphas_F=generator.altered(model['alphas_F'], 7))
    else:
        model = dict(model, R_d_desc_alpha=generator.altered(model['R_d_desc_alpha'], 7))
    got = ref_sym.judge(model, task['R_train'], task['F_train'], task['E_train'], ds['perms'], SIG, LAM, 'cpu')
    assert got['resid'] > LIMITS['resid'] or got['model'] > LIMITS['model'], got


@pytest.mark.parametrize('n_atoms', [9, 21])
def test_prediction_is_the_reference_s_symmetric_contraction(n_atoms):
    """Seeded random coefficients, the model built by the port."""
    m = 8
    ds = synthetic_sym.generate_md_dataset(n_atoms, 40, 3, 7)
    trainer = GDMLTrain(device='cpu')
    task = trainer.create_task(ds, m, ds, 5, sig=SIG, lam=LAM, use_sym=True, rng=np.random.RandomState(1))
    R = torch.as_tensor(task['R_train'].reshape(m, -1))
    X, Jc = desc_ops.descriptor_batch(R, n_atoms)
    alphas = np.random.default_rng(3).normal(size=m * 3 * n_atoms)
    model = trainer.create_model(task, 'analytic', X, Jc, 0.7, alphas)
    model['c'] = -1.25
    query = ds['R'][-6:]
    E, F = GDMLPredict(model, device='cpu').predict(query.reshape(6, -1))
    E_ref, F_ref = ref_sym.predict(query, task['R_train'], alphas, ds['perms'], SIG, 0.7, -1.25, 'cpu')
    # The port centres its tables and uses the Gram identity: float64
    # rounding of sums over 48 table rows.
    np.testing.assert_allclose(E, E_ref.numpy(), rtol=0, atol=1e-11 * float(E_ref.abs().max()))
    np.testing.assert_allclose(F, F_ref.numpy(), rtol=0, atol=1e-11 * float(F_ref.abs().max()))


# -- the counter --------------------------------------------------------


def _assemble(m=12, n_atoms=9, tiles=(5, 7)):
    perms = synthetic_sym.group_perms(synthetic_sym.make_molecule(n_atoms, seed=3)[0])
    R = torch.as_tensor(_geometries(n_atoms, m, 4).reshape(m, -1))
    X, Jc = desc_ops.descriptor_batch(R, n_atoms)
    return assemble_kernel(X, Jc, desc_perm_table(perms), SIG, n_atoms, tile_i=tiles[0], tile_j=tiles[1])


@pytest.mark.parametrize('tiles', [(12, 12), (5, 7), (1, 12)])
def test_the_counter_counts_m_squared_p_blocks_under_a_profiler_session(tiles):
    with _session():
        _assemble(tiles=tiles)
        assert profiling.counter('assembly.perm_blocks') == 12 * 12 * 6


def test_the_counter_and_the_span_record_nothing_with_the_profiler_off():
    profiling.clear()
    _assemble()
    assert profiling.counter('assembly.perm_blocks') == 0 and profiling.calls('perm.tables') == 0


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


@pytest.mark.card
def test_the_assembly_s_peak_stays_within_the_in_place_estimate(card):
    """On the card (``python3 -m pytest --noconftest tests/test_torch_sym_config.py
    -m card``): at the aspirin width's tiles and P = 6, the bytes the
    assembly holds beside K stay within ``est_memory_inplace``'s assembly
    term, as the route's choice assumes."""
    from sgdml_tpu_torch.ops.kernel import tile_peak_bytes

    m, n_atoms = 200, 21
    ds = synthetic_sym.generate_md_dataset(n_atoms, m, 10, 5)
    R = torch.as_tensor(ds['R'].reshape(m, -1), device=card)
    X, Jc = desc_ops.descriptor_batch(R, n_atoms)
    dp = desc_perm_table(ds['perms'])
    torch.cuda.synchronize(card)
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    K = assemble_kernel(X, Jc, dp, 20.0, n_atoms)
    torch.cuda.synchronize(card)
    beside = torch.cuda.max_memory_allocated(card) - base - K.numel() * K.element_size()
    dim_d = X.shape[1]
    assert beside <= tile_peak_bytes(m, n_atoms, 6) + 7 * m * dim_d * 4 * 8, beside


def test_a_symmetric_training_counts_m_squared_p_blocks(sym_task):
    _, task, _ = sym_task
    with _session():
        GDMLTrain(device='cpu').train(task)
        assert profiling.counter('assembly.perm_blocks') == 12 * 12 * 6 and profiling.calls('train') == 1


# -- the metric readers --------------------------------------------------------------


def _run(name, records):
    cell = harness.load_cell(name)
    return harness.Run(cell, 10.0, 50.0, len(records.get('trainings', ())), 1.0, records)


def _reader(name):
    return harness._reader(BENCH, name)


def test_the_assembly_roofline_is_the_count_s_bound_over_the_mean_assembly():
    """Of the set-up's untraced trainings, the first (the first use of
    every kernel) left out; the traced window's trainings not read."""
    warmups = [{'times': {'assembly': 7.0, 'factor': 2.0}, 'n_perms': 6},
               {'times': {'assembly': 1.8, 'factor': 2.0}, 'n_perms': 6},
               {'times': {'assembly': 2.2, 'factor': 2.0}, 'n_perms': 6},
               {'times': {'assembly': 9.0, 'cg': 3.0}, 'n_perms': 6}]  # a CG route: not a dense assembly
    window = [{'times': {'assembly': 3.5, 'factor': 2.0}, 'n_perms': 6}]
    got = _reader('assembly_roofline.train')(_run(CELL, {'warmups': warmups, 'trainings': window}))
    n = 3 * 21 * 1000
    bound = max(1000 * 1001 / 2 * 6 * (81 * 210 + 27 * 21**2) / 67e12, 8.0 * n * (n + 1) / 2 / 3.35e12)
    assert got == pytest.approx(100.0 * bound / 2.0, rel=1e-12)
    assert bound == pytest.approx(counts_sym.assembly_bound_s(1000, 21, 6), rel=1e-12)


def test_the_assembly_roofline_takes_one_permutation_where_the_record_has_none():
    warmups = [{'times': {'assembly': 0.5}}, {'times': {'assembly': 0.3}}]
    got = _reader('assembly_roofline.train')(_run(SWEEP, {'warmups': warmups}))
    assert got == pytest.approx(100.0 * counts_sym.assembly_bound_s(1000, 21, 1) / 0.3, rel=1e-12)
    assert _reader('assembly_roofline.train')(_run(SWEEP, {'warmups': warmups[:1]})) is None
    # A run whose driver keeps no set-up trainings: silent.
    assert _reader('assembly_roofline.train')(_run(SWEEP, {'trainings': warmups})) is None


def test_the_assembly_s_bound_at_aspirin_is_the_bytes_of_k_s_lower_triangle():
    flops = counts_sym.assembly_flops(1000, 21, 6)
    assert flops / counts.H100_FLOPS < counts_sym.assembly_bytes(1000, 21) / counts.H100_BYTES_PER_S
    assert counts_sym.block_flops(21) == 81 * 210 + 27 * 441


def test_perm_blocks_per_training_reads_the_counter_over_the_trainings():
    read = _reader('perm_blocks_per_training.train')
    with _session():
        for _ in range(3):
            with profiling.span('train'):
                profiling.count('assembly.perm_blocks', 6_000_000)
        assert read(_run(CELL, {'trainings': [{}] * 3})) == 6_000_000


def test_perm_blocks_per_training_is_silent_where_the_program_counts_none():
    """As on a program without the counter: trainings, no blocks counted."""
    read = _reader('perm_blocks_per_training.train')
    with _session():
        with profiling.span('train'):
            pass
        assert read(_run(CELL, {'trainings': [{}]})) is None
    profiling.clear()
    assert read(_run(CELL, {'trainings': [{}]})) is None


# -- the cells and the sweep's driver ------------------------------------------------


@pytest.mark.parametrize('name', [CELL, SWEEP])
def test_the_new_cells_load_with_limits_and_report_train_s(name):
    cell = harness.load_cell(name)
    assert set(cell.workload['limits']) == {'resid', 'model'}
    assert {m['name'] for m in cell.end_to_end} == {'setup_s', 'train_s'}
    assert {'assembly_roofline.train', 'assembly_s.train'} <= {m['name'] for m in cell.per_layer}


def test_the_symmetric_configuration_states_its_group():
    config = harness.load_cell(CELL).config
    assert config['use_sym'] and config['n_perms'] == synthetic_sym.GROUP_ORDER and config['reduced'] == []
    assert synthetic_sym.layout(config['n_atoms']) == (3, 3)
    anchor = harness.load_cell('aspirin.train_inplace').config
    for key in ('n_atoms', 'n_train', 'sig', 'lam', 'use_E', 'use_E_cstr', 'dtype'):
        assert config[key] == anchor[key], key


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    for path in (BENCH / 'reference' / 'sym.py', BENCH / 'synthetic_sym.py', BENCH / 'counts_sym.py'):
        tree = ast.parse(path.read_text())
        names = {a.name.split('.')[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split('.')[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not names & {'sgdml_tpu', 'sgdml_tpu_torch', 'jax', 'jaxlib'}, path


def _sweep(monkeypatch, sigs=(4.0, 8.0)):
    config = dict(harness.load_cell(SWEEP).config, n_atoms=9, n_train=10, n_valid=5, n_frames=40,
                  trajectory={'dt': 0.05, 'friction': 0.05, 'temperature': 0.06, 'burn_in': 50})
    traffic = dict(harness.load_cell(SWEEP).traffic, sigs=list(sigs), check_models=3)
    driver = generator.make(config, traffic, 2**31 + 3, 'cpu')
    judged = []
    judge = ref_train.judge

    def spy(model, R, F, E, sig, lam, device, block=16):
        judged.append((float(np.squeeze(model['sig'])), sig))
        return judge(model, R, F, E, sig, lam, device, block)

    monkeypatch.setattr(ref_train, 'judge', spy)
    driver.setup()
    return driver, judged


def test_the_sweep_trains_each_sigma_in_turn_and_judges_each_model_at_its_own(monkeypatch):
    driver, judged = _sweep(monkeypatch)
    assert driver.records['trainings'] == [] and driver.models == []
    for _ in range(5):
        driver.unit()
    assert [float(m['sig']) for m in driver.models] == [4.0, 8.0, 4.0, 8.0, 4.0]
    assert [t['sig'] for t in driver.records['trainings']] == [4.0, 8.0, 4.0, 8.0, 4.0]
    got = driver.judge()
    assert len(judged) == 3 and all(own == used for own, used in judged)
    assert got['resid'] <= LIMITS['resid'] and got['model'] <= LIMITS['model'], got


def test_a_sweep_model_judged_at_another_sigma_fails(monkeypatch):
    driver, _ = _sweep(monkeypatch)
    driver.unit()
    model = driver.models[-1]
    t = driver.task
    got = ref_train.judge(model, t['R_train'], t['F_train'], t['E_train'], 8.0, LAM, 'cpu')
    assert float(model['sig']) == 4.0 and got['resid'] > LIMITS['resid']


def test_the_sweep_fixes_its_data_and_the_seed_orders_the_points(monkeypatch):
    a, _ = _sweep(monkeypatch)
    config, traffic = a.config, a.traffic
    b = generator.make(config, traffic, 2**31 + 4, 'cpu')
    b.setup()
    assert config['data_seed'] == traffic['data_seed'] == 10
    assert sorted(a.task['idxs_train']) == sorted(b.task['idxs_train'])
    assert list(a.task['idxs_train']) != list(b.task['idxs_train'])


@pytest.mark.parametrize('relabelled', [False, True])
def test_a_sweep_that_hands_back_the_model_of_the_previous_sigma_fails(monkeypatch, relabelled):
    """A program that skips re-assembly at the new sigma: the previous
    sigma's model in place of the current one, with its own ``sig`` or
    with the new sigma written into it."""
    driver, _ = _sweep(monkeypatch)
    driver.unit()
    driver.unit()
    sound = driver.judge()
    assert sound['resid'] <= LIMITS['resid'] and sound['model'] <= LIMITS['model'], sound
    stale = driver.models[-2]
    asked = driver.records['trainings'][-1]['sig']
    driver.models[-1] = dict(stale, sig=np.array(asked)) if relabelled else stale
    got = driver.judge()
    assert got['resid'] > LIMITS['resid'] or got['model'] > LIMITS['model'], got


@pytest.fixture(scope='module')
def sym_driver():
    """The symmetric cell's driver at N = 9, M = 12 on the CPU, after its
    set-up and one unit."""
    config = dict(harness.load_cell(CELL).config, n_atoms=9, n_train=12, n_valid=5, n_frames=40, sig=SIG)
    traffic = dict(harness.load_cell(CELL).traffic, check_models=2)
    driver = generator.make(config, traffic, 2**31 + 5, 'cpu')
    driver.setup()
    driver.unit()
    return driver


def test_the_symmetric_driver_judges_for_the_dataset_s_group_and_records_its_order(sym_driver):
    got = sym_driver.judge()
    assert got['resid'] <= LIMITS['resid'] and got['model'] <= LIMITS['model'], got
    assert len(sym_driver.perms) == 6 and _as_set(sym_driver.task['perms']) == _as_set(sym_driver.perms)
    assert [t['n_perms'] for t in sym_driver.records['trainings']] == [6]
    # The set-up's two untraced trainings stay apart for assembly_roofline.train.
    assert [t['n_perms'] for t in sym_driver.records['warmups']] == [6, 6]
    assert all('assembly' in t['times'] for t in sym_driver.records['warmups'])


@pytest.mark.parametrize('where', ['task', 'model', 'order'])
def test_a_group_that_is_not_the_dataset_s_is_not_correct(sym_driver, where):
    """A task or model that kept only the three rotations, or a
    configuration whose order is not the dataset group's."""
    driver = copy.copy(sym_driver)
    rotations = [p for p in driver.perms if (p[p[p]] == np.arange(9)).all()]  # p^3 = 1: C3
    assert len(rotations) == 3
    if where == 'task':
        driver.task = dict(driver.task, perms=np.array(rotations))
    elif where == 'model':
        driver.models = [dict(driver.models[-1], perms=np.array(rotations))]
    else:
        driver.config = dict(driver.config, n_perms=3)
    assert driver.judge()['model'] == math.inf


def test_the_symmetric_control_reads_perms_ignored_above_the_resid_limit(sym_driver):
    driver = copy.copy(sym_driver)
    driver.models = list(sym_driver.models)
    out = driver.control()
    assert out['sound']['resid'] <= LIMITS['resid'] and out['sound']['model'] <= LIMITS['model']
    assert out['perms_ignored']['resid'] > LIMITS['resid'], out['perms_ignored']
    for fault in ('answer_altered', 'state_unchanged', 'half_left_out', 'table_altered'):
        assert out[fault]['resid'] > LIMITS['resid'] or out[fault]['model'] > LIMITS['model'], fault
