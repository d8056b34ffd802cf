"""The PyTorch descriptor ops against sgdml_tpu.ops.descriptor (CPU, f64)
and against the reference implementation's golden descriptor."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import descriptor as jax_desc
from sgdml_tpu_torch.ops import descriptor as desc

GOLDEN = pathlib.Path(__file__).parent / 'golden'
RTOL = 1e-12  # both sides f64; only the summation order may differ
N_ATOMS = 7


def _t(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def _geoms(n=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3 * N_ATOMS)) * 2.0


def _lattice():
    lat = np.diag([6.0, 7.0, 8.0]) + 0.3 * np.random.default_rng(1).normal(size=(3, 3))
    return lat, np.linalg.inv(lat)


@pytest.mark.parametrize('periodic', [False, True])
def test_descriptor_batch_matches_jax(periodic):
    R = _geoms()
    lat = _lattice() if periodic else None
    x_ref, jc_ref = jax_desc.descriptor_batch(
        jnp.asarray(R), N_ATOMS, None if lat is None else tuple(map(jnp.asarray, lat))
    )
    x, jc = desc.descriptor_batch(
        _t(R), N_ATOMS, None if lat is None else tuple(map(_t, lat))
    )
    assert x.dtype == torch.float64 and x.shape == (6, desc.descriptor_dim(N_ATOMS))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=RTOL)
    np.testing.assert_allclose(jc.numpy(), np.asarray(jc_ref), rtol=RTOL, atol=1e-15)


def test_single_geometry_descriptor_matches_jax():
    r = _geoms(1)[0]
    np.testing.assert_allclose(
        desc.descriptor(_t(r), N_ATOMS).numpy(),
        np.asarray(jax_desc.descriptor(jnp.asarray(r), N_ATOMS)), rtol=RTOL,
    )
    x, jc = desc.descriptor_jacobian(_t(r).reshape(N_ATOMS, 3), N_ATOMS)
    x_ref, jc_ref = jax_desc.descriptor_jacobian(jnp.asarray(r), N_ATOMS)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=RTOL)
    np.testing.assert_allclose(jc.numpy(), np.asarray(jc_ref), rtol=RTOL, atol=1e-15)


def test_pbc_diff_matches_jax():
    diffs = np.random.default_rng(2).normal(size=(5, 11, 3)) * 9.0
    lat = _lattice()
    out = desc.pbc_diff(_t(diffs), tuple(map(_t, lat)))
    ref = jax_desc.pbc_diff(jnp.asarray(diffs), tuple(map(jnp.asarray, lat)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-12)


def test_jacobian_contractions_match_jax():
    R = _geoms()
    _, jc_ref = jax_desc.descriptor_batch(jnp.asarray(R), N_ATOMS)
    jc = _t(jc_ref)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(6, 3 * N_ATOMS))
    u = rng.normal(size=(6, desc.descriptor_dim(N_ATOMS)))
    np.testing.assert_allclose(
        desc.jacobian_full(jc, N_ATOMS).numpy(),
        np.asarray(jax_desc.jacobian_full(jc_ref, N_ATOMS)), rtol=RTOL,
    )
    np.testing.assert_allclose(
        desc.jac_dot_vec(jc, _t(v), N_ATOMS).numpy(),
        np.asarray(jax_desc.jac_dot_vec(jc_ref, jnp.asarray(v), N_ATOMS)), rtol=RTOL, atol=1e-14,
    )
    np.testing.assert_allclose(
        desc.vec_dot_jac(jc, _t(u), N_ATOMS).numpy(),
        np.asarray(jax_desc.vec_dot_jac(jc_ref, jnp.asarray(u), N_ATOMS)), rtol=RTOL, atol=1e-14,
    )


def test_static_tables_match_jax_and_cache_per_device_and_dtype():
    np.testing.assert_array_equal(desc.tril_pairs(N_ATOMS), jax_desc.tril_pairs(N_ATOMS))
    np.testing.assert_array_equal(desc.incidence(N_ATOMS), jax_desc.incidence(N_ATOMS))
    perm = np.random.default_rng(4).permutation(N_ATOMS)
    np.testing.assert_array_equal(
        desc.perm_to_desc_perm(perm), jax_desc.perm_to_desc_perm(perm)
    )
    cpu = torch.device('cpu')
    s64 = desc._incidence_t(N_ATOMS, cpu, torch.float64)
    assert s64 is desc._incidence_t(N_ATOMS, cpu, torch.float64)
    assert desc._incidence_t(N_ATOMS, cpu, torch.float32).dtype == torch.float32


def test_golden_descriptor_from_reference():
    ref = np.load(GOLDEN / 'descriptor_ref.npz')
    r = ref['r']
    x, jc = desc.descriptor_jacobian(_t(r), r.shape[0])
    np.testing.assert_allclose(x.numpy(), ref['R_desc'], rtol=1e-12)
    np.testing.assert_allclose(jc.numpy(), ref['R_d_desc'], rtol=1e-12)
