"""The port's command line against the JAX package's, on the CPU.

The same dataset files and the same numpy seed go through ``sgdml_tpu.cli``
and ``sgdml_tpu_torch.cli --device cpu``; each test compares what the two
leave on disk: file names and directory layout, splits, permutations, the
selected sigma, coefficients and the errors recorded into the model files.

Tolerances: coefficients within 1e-6 of max |alpha| for force-only dense
solves and 1e-5 with energy constraints, and forces of symmetrized models
within 1e-6, the bounds tests/test_torch_train.py holds the same solves to;
recorded errors within 1e-6 relative (they derive
from those coefficients); errors of one model predicted by both packages
within 1e-10 relative; CG iteration counts within 5% or 2, the bound of
tests/test_torch_iterative.py.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from sgdml_tpu import cli as jax_cli
from sgdml_tpu_torch import cli
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset, generate_symmetric_md_dataset
from sgdml_tpu_torch.ops import _build
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import io

ALPHA_TOL = {False: 1e-6, True: 1e-5}  # by use_E_cstr
ERR_TOL = 1e-6


def _slice_dataset(ds, sl, name):
    """Same molecule, disjoint trajectory windows -> distinct datasets."""
    out = {k: v for k, v in ds.items() if k not in ('R', 'E', 'F', 'md5', 'name')}
    out.update(R=ds['R'][sl], E=ds['E'][sl], F=ds['F'][sl], name=name)
    out['md5'] = io.dataset_md5(out)
    return out


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Absolute paths of the test datasets: synth5 (N=5, 300 frames, the
    dataset of tests/test_cli.py), a symmetric molecule, and three disjoint
    windows of one trajectory (train, valid, test)."""
    tmp = tmp_path_factory.mktemp('data')
    paths = {}

    def save(name, ds):
        paths[name] = str(tmp / (name + '.npz'))
        io.save_dict(paths[name], ds)

    save('synth5', generate_md_dataset(n_atoms=5, n_frames=300, seed=6))
    save('sym', generate_symmetric_md_dataset(n_frames=60, seed=0))
    full = generate_md_dataset(n_atoms=5, n_frames=460, seed=11)
    for name, sl in (('a', slice(0, 200)), ('b', slice(200, 320)), ('c', slice(320, 460))):
        save(name, _slice_dataset(full, sl, 'synth5-' + name))
    return paths


def _run(tmp_path, monkeypatch, tag, argvs, seed, port):
    """Run ``argvs`` through one package's ``main`` in ``tmp_path/tag`` after
    ``np.random.seed(seed)``; the port's on the CPU."""
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    monkeypatch.chdir(d)
    np.random.seed(seed)
    for argv in argvs:
        (cli.main(['--device', 'cpu'] + argv) if port else jax_cli.main(argv))
    return d


def _run_both(tmp_path, monkeypatch, argvs, seed=1):
    return (_run(tmp_path, monkeypatch, 'port', argvs, seed, True),
            _run(tmp_path, monkeypatch, 'jax', argvs, seed, False))


def _tree(d):
    """{relative path: artifact dict} of every npz under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            if f.endswith('.npz'):
                out[os.path.relpath(os.path.join(root, f), d)] = io.load_dict(os.path.join(root, f))
    return out


def _err(v):
    return v.item() if isinstance(v, np.ndarray) else v


def _assert_models_match(m, ref, R=None):
    for key in ('idxs_train', 'idxs_valid', 'perms', 'md5_train', 'md5_valid', 'sig', 'lam', 'n_test',
                'md5_test', 'use_E', 'solver_name'):
        np.testing.assert_array_equal(m[key], ref[key], err_msg=key)
    use_E_cstr = 'alphas_E' in ref
    assert ('alphas_E' in m) == use_E_cstr
    if R is not None:
        # Symmetrized models: forces on geometries R, as
        # tests/test_torch_train.py holds symmetrized training.
        _, F = GDMLPredict(m, device='cpu').predict(R)
        _, F_ref = GDMLPredict(ref, device='cpu').predict(R)
        np.testing.assert_allclose(F, F_ref, rtol=1e-6, atol=1e-6 * np.abs(F_ref).max())
    else:
        for key in ('alphas_F', 'alphas_E') if use_E_cstr else ('alphas_F',):
            scale = np.abs(ref[key]).max()
            assert np.abs(m[key] - ref[key]).max() <= ALPHA_TOL[use_E_cstr] * scale, key
    for key in ('f_err', 'e_err'):
        if key in ref:
            ours, theirs = _err(m[key]), _err(ref[key])
            assert sorted(ours) == sorted(theirs)
            for k, v in theirs.items():
                if np.isnan(v):
                    assert np.isnan(ours[k]), (key, k)
                else:
                    np.testing.assert_allclose(ours[k], v, rtol=ERR_TOL, err_msg='%s %s' % (key, k))


def _assert_trees_match(d, d_ref, R=None):
    tree, ref = _tree(d), _tree(d_ref)
    assert sorted(tree) == sorted(ref)  # the same names in the same layout
    for path, art in ref.items():
        assert io.artifact_type(tree[path]) == io.artifact_type(art), path
        if io.is_model(art):
            _assert_models_match(tree[path], art, R)
        elif io.is_task(art):
            assert sorted(tree[path]) == sorted(art), path
            for key in ('idxs_train', 'idxs_valid', 'perms', 'R_train', 'F_train', 'sig', 'md5_train'):
                np.testing.assert_array_equal(tree[path][key], art[key], err_msg=key)
    return tree


ALL_CASES = {
    # symmetry discovery on, the default solver, two sigmas
    'discovery': (['all', '{synth5}', '40', '20', '100', '-s', '5,10'], None),
    # the sigma search stops after the validation error rises at 100
    'early_stop': (['all', '{synth5}', '30', '10', '50', '-s', '5,10,50,100,150,200', '--gdml'], 4),
    # energy constraints: the M, validation count and sigma of the recipe that
    # tests/test_torch_train.py holds to 1e-5
    'E_cstr': (['all', '{synth5}', '25', '10', '60', '-s', '4', '--E_cstr', '--solver', 'analytic'], None),
    # a molecule with symmetries: P > 1 in the task, the solve and the tables
    'symmetric': (['all', '{sym}', '30', '10', '20', '-s', '6'], None),
    'separate_datasets': (['all', '{a}', '60', '15', '40', '-s', '5,10,20', '--gdml', '--valid_dataset', '{b}',
                           '--test_dataset', '{c}'], None),
    'no_E_model_file': (['all', '{synth5}', '30', '10', '0', '-s', '10', '--gdml', '--no_E', '--model_file',
                         'best.npz'], None),
}


@pytest.mark.parametrize('case', sorted(ALL_CASES))
def test_all_matches_jax(data, tmp_path, monkeypatch, capsys, case):
    """``all``: the same files in the same layout, splits, permutations,
    selected sigma, coefficients and recorded test errors."""
    argv, n_trained = ALL_CASES[case]
    argv = [a.format(**data) for a in argv]
    d, d_ref = _run_both(tmp_path, monkeypatch, [argv])
    out = capsys.readouterr().out
    selected = [line.split(' (')[0] for line in out.splitlines() if line.startswith('Selected sig=')]
    assert len(selected) == 2 and selected[0] == selected[1], selected
    R = None
    if case == 'symmetric':
        R = io.load_dict(data['sym'])['R'][:40].reshape(40, -1)
    tree = _assert_trees_match(d, d_ref, R)
    finals = [p for p in tree if os.sep not in p]
    assert len(finals) == 1 and io.is_model(tree[finals[0]])
    final = tree[finals[0]]
    if n_trained is not None:
        assert sum(p.split(os.sep)[-1].startswith('model-') for p in tree) == n_trained
    if case == 'symmetric':
        assert final['perms'].shape[0] > 1
    if case == 'separate_datasets':
        md5 = {k: io.dataset_md5(io.load_dict(data[k])) for k in 'abc'}
        assert (final['md5_train'], final['md5_valid'], final['md5_test']) == (md5['a'], md5['b'], md5['c'])
    if case == 'no_E_model_file':
        assert finals == ['best.npz'] and not final['use_E'] and final['n_test'] == 0
        return
    test_ds = io.load_dict(data[{'separate_datasets': 'c', 'symmetric': 'sym'}.get(case, 'synth5')])
    # tests/test_cli.py's accuracy bound on the separate test dataset
    assert final['n_test'] > 0 and _err(final['f_err'])['mae'] < 0.35 * np.abs(test_ds['F']).mean()


@pytest.mark.parametrize('case', ['perms_file', 'md5_argument', 'overwrite'])
def test_create_matches_jax(data, tmp_path, monkeypatch, case):
    """``create`` with an external permutation table, with the dataset named
    by its MD5 fingerprint, and over an existing directory: the same task
    files."""
    ds = io.load_dict(data['sym'])
    z = np.asarray(ds['z'])
    perm = np.arange(len(z))
    twins = np.flatnonzero(z == z[np.argmax(np.bincount(z)[z])])
    perm[twins[0]], perm[twins[1]] = twins[1], twins[0]
    perms = np.vstack([np.arange(len(z)), perm])
    argvs = [['create', data['sym'], '20', '10', '-s', '5,7', '--task_dir', 'tp']]
    if case == 'perms_file':
        argvs[0] += ['--perms', str(tmp_path / 'perms.npz')]
        np.savez(str(tmp_path / 'perms.npz'), perms=perms)
    elif case == 'md5_argument':
        argvs[0][1] = os.path.join(os.path.dirname(data['sym']), io.dataset_md5(ds).decode())
    else:
        argvs += [argvs[0] + ['-o']]
    d, d_ref = _run_both(tmp_path, monkeypatch, argvs, seed=8)
    tree = _assert_trees_match(d, d_ref)
    assert len(tree) == 2
    if case == 'perms_file':
        for task in tree.values():
            np.testing.assert_array_equal(task['perms'], perms)


def test_cg_warm_start_grid_matches_jax(data, tmp_path, monkeypatch):
    """``train --solver cg`` over a sigma grid: each sigma after the first
    warm-starts from the previous one's coefficients, and the per-sigma
    iteration counts are the JAX package's."""
    starts = []
    orig = cli.GDMLTrain.train

    def spy(self, task, **kw):
        starts.append(task.get('alphas0_F') is not None)
        return orig(self, task, **kw)

    monkeypatch.setattr(cli.GDMLTrain, 'train', spy)
    argvs = [['create', data['synth5'], '30', '15', '-s', '6,8,10', '--gdml', '--task_dir', 't'],
             ['train', 't', '--solver', 'cg', '--max_memory', '0.002']]
    d, d_ref = _run_both(tmp_path, monkeypatch, argvs)
    assert starts == [False, True, True]
    tree, ref = _tree(d), _tree(d_ref)
    assert sorted(tree) == sorted(ref)
    models = [p for p in ref if io.is_model(ref[p])]
    assert len(models) == 3
    for p in models:
        ours, theirs = int(tree[p]['solver_iters']), int(ref[p]['solver_iters'])
        assert abs(ours - theirs) <= max(2, 0.05 * theirs), (p, ours, theirs)
        assert len(tree[p]['inducing_pts_idxs']) < 30 * 15  # k < M: a real preconditioned solve
        np.testing.assert_array_equal(tree[p]['inducing_pts_idxs'], ref[p]['inducing_pts_idxs'])


def test_resume_matches_jax(data, tmp_path, monkeypatch):
    """A CG solve cut by ``--max_seconds 0`` leaves an unconverged model;
    ``resume`` continues it to convergence, in as many iterations as the JAX
    package takes."""
    model = os.path.join('t', 'model-train40-sym1-sig0004.npz')
    argvs = [['create', data['synth5'], '40', '15', '-s', '4', '--gdml', '--task_dir', 't'],
             ['train', 't', '--solver', 'cg', '--max_seconds', '0', '--max_memory', '0.002']]
    cut = {}
    for port in (True, False):
        d = _run(tmp_path, monkeypatch, 'port' if port else 'jax', argvs, 1, port)
        m = io.load_dict(str(d / model))
        assert m['solver_resid'] > m['solver_tol'] * m['norm_y_train']  # unconverged
        cut[port] = int(m['solver_iters'])
        resume = ['resume', model, data['synth5'], '--max_memory', '0.002']
        (cli.main(resume + ['--device', 'cpu']) if port else jax_cli.main(resume))
    assert cut[True] == cut[False]
    tree, ref = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    m, m_ref = tree[model], ref[model]
    assert m['solver_resid'] <= m['solver_tol'] * m['norm_y_train']
    assert int(m['solver_iters']) > cut[True]
    assert abs(int(m['solver_iters']) - int(m_ref['solver_iters'])) <= max(2, 0.05 * int(m_ref['solver_iters']))


def test_resume_refuses_analytic_and_other_datasets(data, tmp_path, monkeypatch):
    d = _run(tmp_path, monkeypatch, 'port', [['create', data['synth5'], '20', '10', '-s', '5', '--gdml',
                                               '--task_dir', 't'], ['train', 't']], 1, True)
    model = str(d / 't' / 'model-train20-sym1-sig0005.npz')
    with pytest.raises(SystemExit):
        cli.main(['--device', 'cpu', 'resume', model, data['synth5']])
    with pytest.raises(ValueError, match='fingerprint'):
        cli.main(['--device', 'cpu', 'resume', model, data['a']])


def test_lazy_matches_jax(data, tmp_path, monkeypatch):
    """``--lazy`` skips a task whose training was attempted before without a
    model; without it the task trains."""
    results = {}
    for port in (True, False):
        d = _run(tmp_path, monkeypatch, 'port' if port else 'jax',
                 [['create', data['synth5'], '20', '10', '-s', '5', '--gdml', '--task_dir', 't']], 9, port)
        task_path = os.path.join('t', 'task-train20-sym1-sig0005.npz')
        task = io.load_dict(task_path)
        task['tried_training'] = True
        io.save_dict(task_path, task)
        mod = cli if port else jax_cli
        ns = dict(task='t', valid_dataset=None, overwrite=False, max_memory=None, solver='analytic', devices=None,
                  device='cpu')
        lazy = mod.train(argparse.Namespace(lazy=True, **ns))
        assert not [f for f in os.listdir('t') if f.startswith('model-')]
        results[port] = (lazy, mod.train(argparse.Namespace(lazy=False, **ns)))
        assert os.path.exists(d / results[port][1][0])
    assert results[True] == results[False] == ([], [os.path.join('t', 'model-train20-sym1-sig0005.npz')])
    _assert_trees_match(tmp_path / 'port', tmp_path / 'jax')


def test_validate_then_select_without_dataset_matches_jax(data, tmp_path, monkeypatch, capsys):
    """``validate`` records the validation errors into the model files, so
    that ``select`` without a dataset picks the same sigma as the JAX
    package's."""
    argvs = [['create', data['synth5'], '25', '10', '-s', '5,10,20', '--gdml', '--task_dir', 't'],
             ['train', 't', '--solver', 'analytic'],
             ['validate', 't', data['synth5']],
             ['select', 't', '--out', 'best.npz']]
    d, d_ref = _run_both(tmp_path, monkeypatch, argvs, seed=4)
    tree = _assert_trees_match(d, d_ref)
    for path, art in tree.items():
        if path.startswith('t' + os.sep + 'model-'):
            assert np.isfinite(_err(art['f_err'])['rmse'])
    assert tree['best.npz']['n_test'] == 0
    out = capsys.readouterr().out
    assert len({line for line in out.splitlines() if line.startswith('Selected sig=')}) == 1


@pytest.fixture(scope='module')
def jax_model(data):
    """A model trained by the JAX package (25 train / 10 valid points)."""
    from sgdml_tpu.train import GDMLTrain as JaxTrain

    ds = io.load_dict(data['synth5'])
    np.random.seed(5)
    task = JaxTrain().create_task(ds, 25, ds, 10, sig=10, use_sym=False)
    return JaxTrain().train(task, solver='analytic')


@pytest.mark.parametrize('n_test', [None, 0, 20])
@pytest.mark.parametrize('which', ['same', 'other'])
def test_validation_core_and_md5_exclusion_match_jax(data, jax_model, which, n_test):
    """``_validate_model``: validation on the split's dataset; testing
    excludes the train and valid indices only when the fingerprint shows
    they belong to the dataset; a random test subset is the JAX package's."""
    ds = io.load_dict(data['synth5'])
    if which == 'other':
        if n_test is None:
            with pytest.raises(ValueError, match='fingerprint'):
                cli._validate_model(jax_model, io.load_dict(data['a']), device='cpu')
            return
        ds = io.load_dict(data['a'])
    res = cli._validate_model(jax_model, ds, n_test=n_test, device='cpu')
    ref = jax_cli._validate_model(jax_model, ds, n_test=n_test)
    assert res['n'] == ref['n']
    expect = {None: 10, 0: 300 - 35, 20: 20} if which == 'same' else {0: 200, 20: 20}
    assert res['n'] == expect[n_test]
    for key in ('f_err', 'e_err'):
        for k, v in ref[key].items():
            np.testing.assert_allclose(res[key][k], v, rtol=1e-10, err_msg='%s %s' % (key, k))


@pytest.mark.parametrize('shape', [(7, 5), (40, 9)])
def test_error_metrics_match_jax(shape):
    n, n_atoms = shape
    rng = np.random.default_rng(n)
    F_ref = rng.normal(size=(n, 3 * n_atoms))
    F_pred = F_ref + 0.1 * rng.normal(size=F_ref.shape)
    F_pred[0, :3] = 0.0  # a zero force: the angular term's guard
    ours, ref = cli.force_error_metrics(F_pred, F_ref, n_atoms), jax_cli.force_error_metrics(F_pred, F_ref, n_atoms)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-12, err_msg=k)
    E_ref, E_pred = rng.normal(size=n), rng.normal(size=n)
    assert cli.energy_error_metrics(E_pred, E_ref) == pytest.approx(jax_cli.energy_error_metrics(E_pred, E_ref),
                                                                    rel=1e-12)


def test_artifacts_cross_between_packages(data, tmp_path, monkeypatch, capsys):
    """A task made by the JAX package trains in the port, and the JAX
    package tests the port's model (errors recorded as the port records
    them)."""
    monkeypatch.chdir(tmp_path)
    np.random.seed(3)
    jax_cli.main(['create', data['synth5'], '30', '10', '-s', '10', '--gdml', '--task_dir', 't'])
    paths = cli.main(['--device', 'cpu', 'train', 't'])
    assert paths == [os.path.join('t', 'model-train30-sym1-sig0010.npz')]
    io.save_dict('copy.npz', io.load_dict(paths[0]))
    jax_cli.main(['test', paths[0], data['synth5'], '50'])
    cli.main(['test', 'copy.npz', data['synth5'], '50', '--device', 'cpu'])
    ref, ours = io.load_dict(paths[0]), io.load_dict('copy.npz')
    assert ref['n_test'] == ours['n_test'] == 50 and ref['md5_test'] == ours['md5_test']
    for key in ('f_err', 'e_err'):
        for k, v in _err(ref[key]).items():
            np.testing.assert_allclose(_err(ours[key])[k], v, rtol=1e-10, err_msg='%s %s' % (key, k))


@pytest.mark.parametrize('artifact', ['dataset', 'lattice_dataset', 'task', 'model'])
def test_show_matches_jax(data, tmp_path, jax_model, capsys, artifact):
    ds = io.load_dict(data['synth5'])
    if artifact == 'dataset':
        path = data['synth5']
    else:
        path = str(tmp_path / 'art.npz')
        art = {'lattice_dataset': dict(ds, lattice=np.diag([9.0, 10.0, 11.0])),
               'task': {'type': 't', 'sig': 10, 'perms': np.arange(5)[None], 'idxs_train': np.arange(30)},
               'model': jax_model}[artifact]
        io.save_dict(path, art)
    cli.main(['show', path])
    ours = capsys.readouterr().out
    jax_cli.main(['show', path])
    assert ours == capsys.readouterr().out
    assert ours.startswith('type: %s' % ('dataset' if 'dataset' in artifact else artifact))


def test_reset_removes_cache_and_built_kernels(tmp_path, monkeypatch, capsys):
    build = tmp_path / 'build' / 'kernels'
    build.mkdir(parents=True)
    (build / 'libsgdml_kernels_0123.so').write_bytes(b'\0')
    cache = tmp_path / 'cache.json'
    cache.write_text('{}')
    monkeypatch.setattr(_build, 'BUILD_DIR', build)
    monkeypatch.setenv('SGDML_TPU_TORCH_BMARK_CACHE', str(cache))
    cli.main(['reset'])
    out = capsys.readouterr().out
    assert 'Removed benchmark cache.' in out and 'Removed built kernels %s.' % build in out
    assert not build.exists() and not cache.exists()
    cli.main(['reset'])
    assert capsys.readouterr().out == 'No caches to remove.\n'


@pytest.mark.parametrize('argv', [
    ['all', '{synth5}', '20', '10', '--devices', '8'],
    ['create', '{synth5}', '20', '10', '--task_dir', 't', '--devices', '3'],
    ['train', 't', '--devices', '8'],
    ['test', 'm.npz', '{synth5}', '--devices', '2'],
    ['resume', 'm.npz', '{synth5}', '--devices', '4'],
])
def test_devices_raises_before_work(data, tmp_path, monkeypatch, argv):
    """``--devices N`` in a world of another size (here no launcher: a world
    of this process alone) raises before any file is read or written, and
    before any process group is made."""
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match='launched world has 1 process'):
        cli.main(['--device', 'cpu'] + [a.format(**data) for a in argv])
    assert os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match='torchrun --nproc-per-node 8'):
        cli._make_mesh(8, 'cpu')
    assert cli._make_mesh(0) is None and cli._make_mesh(None) is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize('argv', [
    ['all', '{synth5}', '20', '10', '-s', '5'],
    ['create', '{synth5}', '20', '10', '--task_dir', 't'],
    ['create', '{synth5}', '20', '10', '--task_dir', 't', '--device', 'cuda'],
    ['--device', 'cuda', 'all', '{synth5}', '20', '10', '--gdml'],
])
def test_cuda_without_a_card_raises_before_any_file(data, tmp_path, monkeypatch, argv):
    """``--device`` is ``cuda`` unless given; without a card the CLI raises
    before the task directory exists, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main([a.format(**data) for a in argv])
    assert os.listdir(tmp_path) == []


def test_device_option_before_or_after_the_subcommand(data, tmp_path, monkeypatch):
    argv = ['create', data['synth5'], '20', '10', '-s', '5', '--gdml', '--task_dir', 't']
    for tag, full in (('before', ['--device', 'cpu'] + argv), ('after', argv + ['--device', 'cpu'])):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        np.random.seed(2)
        assert cli.main(full) == 't'
    _assert_trees_match(tmp_path / 'before', tmp_path / 'after')


def test_train_flags_reach_the_trainer(data, tmp_path, monkeypatch, capsys):
    """``--max_seconds``, ``--factor_slices`` and ``--max_memory`` reach
    ``GDMLTrain`` as in the JAX package; the trainer runs on ``--device``."""
    seen = {}
    orig = cli.GDMLTrain.train

    def spy(self, task, **kw):
        seen.update(kw, device=self.device.type, max_memory=self._max_memory)
        return orig(self, task, **kw)

    monkeypatch.setattr(cli.GDMLTrain, 'train', spy)
    _run(tmp_path, monkeypatch, 'port', [
        ['create', data['synth5'], '20', '10', '-s', '6', '--gdml', '--task_dir', 'tdir'],
        ['train', 'tdir', '--solver', 'cg', '--max_seconds', '600', '--factor_slices', '5', '--max_memory', '0.5']],
        5, True)
    assert seen['solver'] == 'cg' and seen['solver_max_seconds'] == 600.0 and seen['factor_slices'] == 5
    assert seen['device'] == 'cpu' and seen['max_memory'] == 0.5
    assert 'Trained' in capsys.readouterr().out
