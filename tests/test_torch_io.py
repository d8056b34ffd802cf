"""The port's utils/io.py and utils/ui.py against the JAX package's: artifact
names and xyz strings byte for byte, range parsing, the argparse types with
their MD5 resolution and messages, task-directory resumption, and the
terminal helpers' output."""

import argparse
import logging

import numpy as np
import pytest

from sgdml_tpu.utils import io as jax_io
from sgdml_tpu.utils import ui as jax_ui
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.utils import io, ui


@pytest.mark.parametrize('arg', ['5', '1,2,3', '7,', '10:10:40', '5:3:6', '0:1:0', 'abc', '1:2', '-3', '2.5'])
def test_parse_list_or_range_matches_jax(arg):
    try:
        ref = jax_io.parse_list_or_range(arg)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            io.parse_list_or_range(arg)
        assert str(ours.value) == str(e)
        return
    assert io.parse_list_or_range(arg) == ref


@pytest.mark.parametrize('use_sym,use_E,use_E_cstr', [(True, True, False), (False, True, True), (True, False, False)])
@pytest.mark.parametrize('theory', ['DFT/PBE+MBD', np.array('CCSD(T)..cc-pVDZ'), np.array(['morse'])])
def test_artifact_names_are_byte_equal(theory, use_sym, use_E, use_E_cstr):
    dataset = {'name': np.array('aspirin'), 'theory': theory}
    name = io.train_dir_name(dataset, 200, use_sym, use_E, use_E_cstr)
    assert name == jax_io.train_dir_name(dataset, 200, use_sym, use_E, use_E_cstr)
    task = {'idxs_train': np.arange(200), 'perms': np.zeros((6, 21)), 'sig': np.array([42]),
            'dataset_name': np.array('aspirin'), 'dataset_theory': theory}
    assert io.task_file_name(task) == jax_io.task_file_name(task) == 'task-train200-sym6-sig0042.npz'
    for ext in (False, True):
        assert io.model_file_name(task, is_extended=ext) == jax_io.model_file_name(task, is_extended=ext)


@pytest.mark.parametrize('with_e,with_f,with_lattice', [(True, True, True), (False, True, False), (False, False, False)])
def test_xyz_strings_and_files_match_jax(tmp_path, with_e, with_f, with_lattice):
    rng = np.random.default_rng(3)
    r, f = rng.normal(size=(4, 3)), rng.normal(size=12)
    z = np.array([6, 1, 8, 1])
    kw = dict(e=-97.123456789012345 if with_e else None, f=f if with_f else None,
              lattice=np.diag([10.0, 11.5, 12.25]) + 0.1 if with_lattice else None)
    assert io.generate_xyz_str(r, z, **kw) == jax_io.generate_xyz_str(r, z, **kw)

    ours, ref = str(tmp_path / 'ours.xyz'), str(tmp_path / 'ref.xyz')
    io.write_xyz(ours, r, z, comment='frame 0')
    jax_io.write_xyz(ref, r, z, comment='frame 0')
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    R, z2 = io.read_xyz(ref)
    R_j, z2_j = jax_io.read_xyz(ref)
    np.testing.assert_array_equal(R, R_j)
    np.testing.assert_array_equal(z2, z2_j)
    np.testing.assert_allclose(R.reshape(4, 3), r, rtol=1e-12)


@pytest.mark.parametrize('lat', [np.diag([2.0, 3.0, 4.0]), np.array([[5.0, 2.5, 0.0], [0.0, 4.3, 0.0], [0.0, 0.0, 7.0]]),
                                 np.zeros((3, 3))])
def test_lattice_vec_to_par_matches_jax(lat):
    assert io.lattice_vec_to_par(lat) == jax_io.lattice_vec_to_par(lat)


def _artifacts(tmp_path):
    ds = generate_md_dataset(n_atoms=5, n_frames=20, seed=1)
    ds_path = str(tmp_path / 'ds.npz')
    io.save_dict(ds_path, ds)
    io.save_dict(str(tmp_path / 'task.npz'), {'type': 't', 'sig': 10})
    with open(tmp_path / 'notes.txt', 'w') as fh:
        fh.write('not an artifact')
    return ds, ds_path


def _outcome(fn, *args, **kw):
    """A call's result, or its ArgumentTypeError's message."""
    try:
        out = fn(*args, **kw)
    except argparse.ArgumentTypeError as e:
        return 'error: %s' % e
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
        return out[0], io.artifact_type(out[1])
    return out


def test_argument_types_match_jax(tmp_path, monkeypatch):
    """The argparse types give the JAX package's results and messages:
    paths, MD5 fingerprints (bare, in a directory, unknown, ambiguous), wrong
    kinds, unreadable files, directories and integers."""
    ds, ds_path = _artifacts(tmp_path)
    md5 = io.dataset_md5(ds).decode()
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path)
    calls = [
        ('is_file_type', (ds_path, 'dataset')), ('is_file_type', (md5, 'dataset')),
        ('is_file_type', ('%s/%s' % (d, md5), 'dataset')), ('is_file_type', ('%s/%s' % (d, '0' * 32), 'dataset')),
        ('is_file_type', ('nodir/%s' % md5, 'dataset')), ('is_file_type', ('plainword', 'dataset')),
        ('is_file_type', (ds_path, 'model')), ('is_file_type', (d + '/missing.npz', 'dataset')),
        ('is_file_type', (d + '/notes.txt', 'task')),
        ('is_valid_file_type', (ds_path,)), ('is_valid_file_type', (d + '/task.npz',)), ('is_valid_file_type', (d,)),
        ('filter_file_type', (d, 'dataset')), ('filter_file_type', (d, 'task')), ('filter_file_type', (d, 'model')),
        ('filter_file_type', (d, 'dataset'), {'md5_match': md5}),
        ('is_dir_with_file_type', (d, 'dataset')), ('is_dir_with_file_type', (ds_path, 'dataset'), {'or_file': True}),
        ('is_dir_with_file_type', (d + '/nope', 'dataset')),
        ('is_strict_pos_int', ('7',)), ('is_strict_pos_int', ('0',)), ('is_strict_pos_int', ('-3',)),
        ('is_strict_pos_int', ('x',)),
    ]
    for name, args, *kw in calls:
        kw = kw[0] if kw else {}
        ours, ref = _outcome(getattr(io, name), *args, **kw), _outcome(getattr(jax_io, name), *args, **kw)
        assert ours == ref, (name, args, ours, ref)
    assert _outcome(io.is_file_type, md5, 'dataset') == ('./ds.npz', 'd')
    # Ambiguous fingerprint (two copies): the same error, listing both.
    io.save_dict(str(tmp_path / 'ds_copy.npz'), io.load_dict(ds_path))
    ours = _outcome(io.is_file_type, md5, 'dataset')
    assert ours.startswith('error: Multiple dataset files') and ours == _outcome(jax_io.is_file_type, md5, 'dataset')


def test_task_dir_resumable_matches_jax(tmp_path):
    from sgdml_tpu_torch.train import GDMLTrain

    ds = generate_md_dataset(n_atoms=4, n_frames=60, seed=2)
    task = GDMLTrain(device='cpu').create_task(ds, 10, ds, 5, sig=5, use_sym=False, rng=np.random.RandomState(0))
    d = tmp_path / 'tasks'
    d.mkdir()
    for sig in (5, 10):
        io.save_dict(str(d / io.task_file_name(dict(task, sig=sig))), dict(task, sig=sig))
    other = generate_md_dataset(n_atoms=4, n_frames=60, seed=3)
    for args in ((ds, ds, 10, 5, [5, 10], False), (ds, ds, 10, 5, [5], False), (ds, ds, 11, 5, [5, 10], False),
                 (ds, other, 10, 5, [5, 10], False), (ds, ds, 10, 5, [5, 10], True)):
        assert io.is_task_dir_resumable(str(d), *args) == jax_io.is_task_dir_resumable(str(d), *args)
    assert io.is_task_dir_resumable(str(d), ds, ds, 10, 5, [10, 5], False)


# ---------------------------------------------------------------------------
# utils/ui.py
# ---------------------------------------------------------------------------


def _printed(capsys, fn, *args, **kw):
    out = fn(*args, **kw)
    return out, capsys.readouterr().out


@pytest.mark.parametrize('call', [
    ('callback', (ui.DONE,), {'disp_str': 'step done'}),
    ('callback', (ui.NOT_DONE,), {'disp_str': 'step', 'sec_disp_str': 'sub'}),
    ('callback', (ui.DONE,), {'disp_str': 'warned', 'done_with_warning': True}),
    ('callback', (5, 10), {'disp_str': 'halfway'}),
    ('callback', (10, 10), {'disp_str': 'all', 'sec_disp_str': '3.2 s'}),
    ('sec_callback', (3, 7), {'sec_disp_str': 'chunk'}),
    ('gen_memory_str', (2048,), {}),
    ('gen_memory_str', (3 * 1024**5,), {}),
    ('gen_mat_str', (np.arange(6.0).reshape(2, 3) / 7,), {'n_decimals': 4}),
    ('merge_col_str', ('a\nbbb\ncc', 'x\ny'), {}),
    ('print_step_title', ('Training',), {'sec_title': 'sig 10'}),
    ('print_two_column_str', ('left', 'right'), {}),
    ('print_lattice', (np.array([[5.0, 2.5, 0.0], [0.0, 4.3, 0.0], [0.0, 0.0, 7.0]]),), {}),
    ('print_lattice', (None,), {}),
    ('strip_ansi', ('\x1b[31;1mabc\x1b[0m',), {}),
    ('wrap_indent_str', ('[WARN] ', 'word ' * 40), {}),
    ('color_str', ('abc',), {'fore': 'red', 'bold': True}),
    ('white_bold_str', ('abc',), {}),
])
def test_ui_helpers_match_jax(capsys, call):
    name, args, kw = call
    assert _printed(capsys, getattr(ui, name), *args, **kw) == _printed(capsys, getattr(jax_ui, name), *args, **kw)
    assert (ui.DONE, ui.NOT_DONE) == (jax_ui.DONE, jax_ui.NOT_DONE)


def test_logging_formatter_and_done_level(capsys):
    """init_logging formats the port's loggers as the JAX package formats its
    own, the DONE level included."""
    root = ui.init_logging()
    assert root.name == 'sgdml_tpu_torch' and root.level == logging.INFO
    assert logging.getLevelName(25) == 'DONE'
    record = logging.LogRecord('sgdml_tpu_torch.cli', 25, __file__, 1, 'trained %d', (3,), None)
    fmt, jax_fmt = ui.ColoredFormatter('%(message)s'), jax_ui.ColoredFormatter('%(message)s')
    assert fmt.format(record) == jax_fmt.format(record) == '[DONE] trained 3'
    logging.getLogger('sgdml_tpu_torch.cli').done('all %s', 'good')
    assert '[DONE] all good' in capsys.readouterr().err
