"""The port's converters, downloader catalog and ASE calculator against the
JAX package's: the same datasets from the same files, the same catalog and
name resolution, and the same energies and forces through a stand-in for
ASE (which is not installed here)."""

import importlib
import sys

import numpy as np
import pytest

import ase_standin
from sgdml_tpu import download as jax_download
from sgdml_tpu.intf import ase_calc as jax_ase_calc
from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu.scripts import dataset_from_aims as jax_from_aims
from sgdml_tpu.scripts import dataset_from_extxyz as jax_from_extxyz
from sgdml_tpu.scripts import dataset_from_ipi as jax_from_ipi
from sgdml_tpu.scripts import dataset_to_extxyz as jax_to_extxyz
from sgdml_tpu.scripts import dataset_via_ase as jax_via_ase
from sgdml_tpu.scripts import datasets_from_model as jax_from_model
from sgdml_tpu_torch import download
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.intf import ase_calc
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.scripts import (
    dataset_from_aims,
    dataset_from_extxyz,
    dataset_from_ipi,
    dataset_to_extxyz,
    dataset_via_ase,
    datasets_from_model,
)
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io


@pytest.fixture(scope='module')
def ds():
    return generate_md_dataset(n_atoms=4, n_frames=25, seed=8)


@pytest.fixture(scope='module')
def model(ds):
    task = GDMLTrain(device='cpu').create_task(ds, 10, ds, 5, sig=5.0, use_sym=False, rng=np.random.RandomState(2))
    return GDMLTrain(device='cpu').train(task, solver='analytic')


def _assert_same_dataset(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _run_both(tmp_path, ours, ref, argv):
    """Run a converter of each package with ``argv`` (``{out}`` replaced by
    each one's output path) and return both outputs' paths."""
    outs = []
    for main, tag in ((ours.main, 'ours'), (ref.main, 'ref')):
        out = str(tmp_path / tag)
        main([a.replace('{out}', out) for a in argv])
        outs.append(out)
    return outs


def test_extxyz_export_and_import_match_jax(ds, tmp_path):
    npz_in = str(tmp_path / 'in.npz')
    ds_lat = dict(ds, lattice=np.diag([9.0, 9.5, 10.0]))
    io.save_dict(npz_in, ds_lat)
    xyz, xyz_j = _run_both(tmp_path, dataset_to_extxyz, jax_to_extxyz, [npz_in, '-o', '{out}.xyz'])
    with open(xyz + '.xyz', 'rb') as a, open(xyz_j + '.xyz', 'rb') as b:
        assert a.read() == b.read()

    npz, npz_j = _run_both(tmp_path, dataset_from_extxyz, jax_from_extxyz,
                           [xyz + '.xyz', '-o', '{out}.npz', '--name', 'rt', '--theory', 'DFT'])
    ours, ref = io.load_dict(npz + '.npz'), io.load_dict(npz_j + '.npz')
    _assert_same_dataset(ours, ref)
    np.testing.assert_allclose(ours['R'], ds['R'], rtol=1e-9)
    np.testing.assert_allclose(ours['E'], ds['E'], rtol=1e-9)
    np.testing.assert_allclose(ours['lattice'], ds_lat['lattice'])


@pytest.mark.parametrize('atomic_units', [False, True])
def test_ipi_conversion_matches_jax(ds, tmp_path, atomic_units):
    n_atoms = ds['R'].shape[1]
    pos, frc, props = (str(tmp_path / n) for n in ('pos.xyz', 'frc.xyz', 'props.out'))
    with open(pos, 'w') as fp, open(frc, 'w') as ff:
        for i in range(len(ds['R'])):
            for fh, arr in ((fp, ds['R'][i]), (ff, ds['F'][i])):
                fh.write('%d\nframe\n' % n_atoms)
                for zi, row in zip(ds['z'], arr):
                    fh.write('%s %.10f %.10f %.10f\n' % (io.Z_TO_SYMBOL[int(zi)], *row))
    with open(props, 'w') as fh:
        fh.write('# step time potential\n')
        for i, e in enumerate(ds['E']):
            fh.write('%d 0.0 %.10f\n' % (i, e))
    argv = [pos, frc, props, '-o', '{out}.npz'] + (['--atomic_units'] if atomic_units else [])
    out, out_j = _run_both(tmp_path, dataset_from_ipi, jax_from_ipi, argv)
    ours = io.load_dict(out + '.npz')
    _assert_same_dataset(ours, io.load_dict(out_j + '.npz'))
    scale = 0.52917721067 if atomic_units else 1.0
    np.testing.assert_allclose(ours['R'], ds['R'] * scale, rtol=1e-9)


_AIMS_FRAME = """  Atomic structure:
    | Atom   x [A]   y [A]   z [A]
  atom {r0} O
  atom {r1} H
  | Total energy corrected        :         {e} eV
  Total atomic forces (unitary forces cleaned) [eV/Ang]:
  |    1   {f0}
  |    2   {f1}
"""


def test_aims_conversion_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    frames = []
    for _ in range(3):
        r, f = rng.normal(size=(2, 3)), rng.normal(size=(2, 3))
        frames.append(_AIMS_FRAME.format(
            r0=' '.join('%.8f' % x for x in r[0]), r1=' '.join('%.8f' % x for x in r[1]),
            f0=' '.join('%.8e' % x for x in f[0]), f1=' '.join('%.8e' % x for x in f[1]),
            e='%.10f' % rng.normal()))
    path = str(tmp_path / 'aims.out')
    with open(path, 'w') as fh:
        fh.write('\n'.join(frames))
    out, out_j = _run_both(tmp_path, dataset_from_aims, jax_from_aims, [path, '-o', '{out}.npz'])
    ours = io.load_dict(out + '.npz')
    _assert_same_dataset(ours, io.load_dict(out_j + '.npz'))
    assert ours['R'].shape == (3, 2, 3) and list(ours['z']) == [8, 1]


def test_datasets_from_model_match_jax(ds, model, tmp_path, monkeypatch):
    mpath, dpath = str(tmp_path / 'model.npz'), str(tmp_path / 'data.npz')
    io.save_dict(mpath, model)
    io.save_dict(dpath, ds)
    monkeypatch.chdir(tmp_path)
    datasets_from_model.main([mpath, dpath, '-o', 'ours'])
    jax_from_model.main([mpath, dpath, '-o', 'ref'])
    for kind, n in (('train', 10), ('valid', 5)):
        ours = io.load_dict(str(tmp_path / ('ours_%s.npz' % kind)))
        _assert_same_dataset(ours, io.load_dict(str(tmp_path / ('ref_%s.npz' % kind))))
        assert ours['R'].shape[0] == n
        np.testing.assert_array_equal(ours['R'], ds['R'][np.asarray(model['idxs_%s' % kind])])
    with pytest.raises(SystemExit, match='fingerprint'):
        datasets_from_model.main([mpath, str(tmp_path / 'ours_train.npz')])


def test_via_ase_without_ase_exits_as_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'ase', None)  # an import of ase fails
    for main in (dataset_via_ase.main, jax_via_ase.main):
        with pytest.raises(SystemExit, match='Optional ASE dependency not found'):
            main([str(tmp_path / 'traj.xyz')])


@pytest.mark.parametrize('name', ['ethanol', 'Ethanol', 'AT-AT', 'at_at', 'ac-ala3-nhme', 'ethanl', 'at_at_cg', 'zzzzzz'])
def test_downloader_resolves_as_jax(name, capsys):
    def outcome(resolve):
        try:
            return resolve(name), capsys.readouterr().out
        except SystemExit as e:
            return 'exit: %s' % e, capsys.readouterr().out

    assert outcome(download.resolve) == outcome(jax_download.resolve)


def test_downloader_catalog_and_list_match_jax(capsys):
    assert download.DATASETS == jax_download.DATASETS
    assert (download.BASE_URL, download.MODELS_URL) == (jax_download.BASE_URL, jax_download.MODELS_URL)
    download.main(['list'])
    ours = capsys.readouterr().out
    jax_download.main(['list'])
    assert ours == capsys.readouterr().out and 'md22_AT-AT.npz' in ours


# ---------------------------------------------------------------------------
# intf/ase_calc.py
# ---------------------------------------------------------------------------


@pytest.fixture
def calculators():
    """Both calculator modules reloaded under the ASE stand-in; reloaded
    again, without it, afterwards."""
    with ase_standin.installed():
        yield importlib.reload(ase_calc), importlib.reload(jax_ase_calc)
    importlib.reload(ase_calc)
    importlib.reload(jax_ase_calc)


def test_ase_calculator_matches_jax(ds, model, calculators):
    ours_mod, jax_mod = calculators
    assert ours_mod._HAS_ASE and jax_mod._HAS_ASE
    with ase_standin.installed():
        ours = ours_mod.SGDMLCalculator(model, device='cpu')
        ref = jax_mod.SGDMLCalculator(model)
    e_to_ev = ase_standin.KCAL / ase_standin.MOL
    assert ours.E_to_eV == ref.E_to_eV == e_to_ev and ours.Ang_to_R == 1.0
    assert ours.gdml_predict.device.type == 'cpu' and ours.gdml_predict.batch_size == 1
    pred = GDMLPredict(model, device='cpu')
    for i in range(3):
        atoms = ase_standin.Atoms(ds['R'][i])
        ours.calculate(atoms)
        ref.calculate(atoms)
        assert ours.atoms is atoms
        E, F = pred.predict(ds['R'][i].ravel())
        np.testing.assert_allclose(ours.results['energy'], E[0] * e_to_ev, rtol=1e-12)
        np.testing.assert_allclose(ours.results['forces'], F.reshape(-1, 3) * e_to_ev, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ours.results['energy'], ref.results['energy'], rtol=1e-10)
        np.testing.assert_allclose(ours.results['forces'], ref.results['forces'], rtol=1e-10,
                                   atol=1e-10 * np.abs(ref.results['forces']).max())


def test_ase_calculator_unit_factors(ds, model, calculators):
    """Explicit factors: energies by E_to_eV, forces by F_to_eV_Ang and
    positions by their ratio, as the JAX package converts them."""
    ours_mod, jax_mod = calculators
    with ase_standin.installed():
        ours = ours_mod.SGDMLCalculator(model, E_to_eV=2.0, F_to_eV_Ang=0.5, device='cpu')
        ref = jax_mod.SGDMLCalculator(model, E_to_eV=2.0, F_to_eV_Ang=0.5)
    assert ours.Ang_to_R == ref.Ang_to_R == 0.25
    atoms = ase_standin.Atoms(ds['R'][3] / 0.25)
    ours.calculate(atoms)
    ref.calculate(atoms)
    E, F = JaxPredict(model).predict(ds['R'][3].ravel())
    np.testing.assert_allclose(ours.results['energy'], 2.0 * E[0], rtol=1e-10)
    np.testing.assert_allclose(ours.results['forces'], 0.5 * F.reshape(-1, 3), rtol=1e-9, atol=1e-10 * np.abs(F).max())


def test_ase_calculator_gate_without_ase(model, monkeypatch):
    """Without ASE both modules import, and making a calculator raises
    ImportError."""
    monkeypatch.setitem(sys.modules, 'ase', None)
    for mod in (ase_calc, jax_ase_calc):
        mod = importlib.reload(mod)
        assert not mod._HAS_ASE
        with pytest.raises(ImportError, match='Optional ASE dependency not found'):
            mod.SGDMLCalculator(model)
