"""The port's symmetry discovery (perm.py) and symmetric synthetic dataset
against the JAX package's: same groups on the same geometries."""

import pathlib

import numpy as np
import pytest

from sgdml_tpu import perm as jax_perm
from sgdml_tpu.datasets.synthetic import generate_symmetric_md_dataset as jax_sym_dataset
from sgdml_tpu_torch import perm
from sgdml_tpu_torch.datasets.synthetic import generate_symmetric_md_dataset

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def sym_dataset():
    return generate_symmetric_md_dataset(n_frames=60, seed=0)


def test_symmetric_dataset_is_the_jax_packages(sym_dataset):
    ref = jax_sym_dataset(n_frames=60, seed=0)
    assert sorted(sym_dataset) == sorted(ref)
    for key in ('z', 'R', 'E', 'F'):
        np.testing.assert_array_equal(sym_dataset[key], ref[key])
    assert sym_dataset['md5'] == ref['md5']


@pytest.mark.parametrize('source', ['perms_ref', 'symmetric'])
def test_find_perms_matches_jax(source, sym_dataset):
    if source == 'perms_ref':
        data = np.load(GOLDEN / 'perms_ref.npz')
        R, z = data['R'], data['z']
    else:
        R, z = sym_dataset['R'][:40], sym_dataset['z']
    ours = perm.find_perms(R, z)
    np.testing.assert_array_equal(ours, jax_perm.find_perms(R, z))
    if source == 'perms_ref':  # the group the reference implementation found
        assert {tuple(p) for p in ours} == {tuple(p) for p in data['perms']}
    else:
        assert ours.shape[0] > 1


def _fragments():
    frag = np.array([[0.0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    return np.vstack([frag, frag + np.array([5.0, 0, 0])]), np.array([8, 1, 1, 8, 1, 1])


def _mirror():
    r = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.5, 0.8, 0.3],
                  [0.5, -0.8, 0.3], [1.5, 0.4, -0.2], [1.5, -0.4, -0.2]])
    return r, np.array([6, 6, 8, 1, 1, 1, 1])


@pytest.mark.parametrize('case', [
    'complete_sym_group', 'salvage_subgroup', 'find_frag_perms', 'find_perms_in_frag',
    'find_perms_via_alignment', 'find_perms_via_reflection', 'bipartite_match+sync_perm_mat',
])
def test_helpers_match_jax(case, sym_dataset):
    """Each function of the module gives the JAX package's result."""
    rng = np.random.default_rng(0)
    if case == 'complete_sym_group':
        args = (np.array([[0, 1, 2, 3, 4], [1, 2, 0, 3, 4], [0, 1, 2, 4, 3]]),)
    elif case == 'salvage_subgroup':
        args = (np.array([[0, 1, 2, 3], [1, 0, 2, 3], [1, 2, 0, 3], [0, 1, 3, 2]]),)
    elif case == 'find_frag_perms':
        r, z = _fragments()
        args = (r[None], z)
    elif case == 'find_perms_in_frag':
        args = (sym_dataset['R'][:20], sym_dataset['z'], np.arange(7))
    elif case == 'find_perms_via_alignment':
        r, c, s = rng.normal(size=(6, 3)), np.cos(0.7), np.sin(0.7)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        args = (r, r @ rot.T + np.array([1.0, -2.0, 3.0]), np.array([6, 6, 1, 1, 8, 8]))
    elif case == 'find_perms_via_reflection':
        r, z = _mirror()
        args = (r, z)
    if case == 'bipartite_match+sync_perm_mat':
        R, z = sym_dataset['R'][:12], sym_dataset['z']
        matches, cost = perm.bipartite_match(R, z)
        matches_j, cost_j = jax_perm.bipartite_match(R, z)
        assert matches.keys() == matches_j.keys()
        np.testing.assert_array_equal(cost.toarray(), cost_j.toarray())
        ours, ref = perm.sync_perm_mat(matches, cost, 8), jax_perm.sync_perm_mat(matches_j, cost_j, 8)
    elif case == 'find_perms_via_reflection':
        ours = perm.find_perms_via_reflection(*args, plane_3idxs=((3, 4), (5, 6), 2))
        ref = jax_perm.find_perms_via_reflection(*args, plane_3idxs=((3, 4), (5, 6), 2))
    else:
        ours, ref = getattr(perm, case)(*args), getattr(jax_perm, case)(*args)
    assert ours is not None
    np.testing.assert_array_equal(ours, ref)
