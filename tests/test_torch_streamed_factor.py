"""The streamed int8 slice-stack Nystrom factor of the port's iterative
solver (solvers/iterative.py ``_build_factor_streamed``) and its assembly
pieces (ops/kernel.py ``assemble_kernel_columns_range`` and
``assemble_kernel_E_rows``) on the CPU against the JAX package's
(tests/test_streamed_factor.py's system: N=6, M=40, two inducing points):
the range assembly, the energy rows, the factor's apply and leverage scores
with and without energy constraints, the 6-slice renormalization, the
stack's layout, and the streamed budgets."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import kernel as jax_kernel
from sgdml_tpu.ops.descriptor import descriptor_batch as jax_descriptor_batch
from sgdml_tpu.solvers import iterative as jax_it
from sgdml_tpu.train import GDMLTrain as JaxTrain
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.ops import ozaki
from sgdml_tpu_torch.predict import desc_perm_table
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.train import GDMLTrain

SIG, LAM, N_ATOMS, M = 8.0, 1e-10, 6, 40
LOGGER = 'sgdml_tpu_torch.solvers.iterative'
PERMS = {1: np.arange(15)[None, :], 2: desc_perm_table(np.stack([np.arange(6), np.array([1, 0, 2, 3, 5, 4])]))}


@pytest.fixture(scope='module')
def setup():
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=120, seed=7)
    R = ds['R'][:M].reshape(M, -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R), N_ATOMS)
    Xj, Jcj = jax_descriptor_batch(jnp.asarray(R), N_ATOMS)
    cols = np.sort(np.random.RandomState(3).choice(M * 18, 2 * 18, replace=False))
    return X, Jc, Xj, Jcj, cols


@pytest.mark.parametrize('n_perms', [1, 2])
def test_range_assembly_matches_full_and_jax(setup, n_perms):
    """A sweep of 7-point chunks (the last padded) reproduces
    assemble_kernel_columns (1e-12: the row tiles group the products
    otherwise), padded rows are zero, and each chunk agrees with the JAX
    package's range assembly (1e-10 of max |K|)."""
    X, Jc, Xj, Jcj, cols = setup
    dperms = PERMS[n_perms]
    full = kernel_ops.assemble_kernel_columns(X, Jc, dperms, SIG, N_ATOMS, cols).numpy()
    chunks = [kernel_ops.assemble_kernel_columns_range(X, Jc, dperms, SIG, N_ATOMS, cols, c * 7, 7, M, tile_i=3)
              for c in range(6)]
    got = torch.cat(chunks).numpy()
    assert got.shape == (42 * 18, len(cols)) and np.all(got[M * 18:] == 0.0)
    np.testing.assert_allclose(got[:M * 18], full, rtol=0, atol=1e-12)
    Xp, Jcp = jnp.pad(Xj, ((0, 2), (0, 0))), jnp.pad(Jcj, ((0, 2), (0, 0), (0, 0)))
    ref = np.concatenate([np.asarray(jax_kernel.assemble_kernel_columns_range(
        Xp, Jcp, dperms, SIG, N_ATOMS, cols, c * 7, 7, M)) for c in range(6)])
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize('n_perms', [1, 2])
def test_e_rows_match_jax_and_columns(setup, n_perms):
    """The (M, k) energy rows in matmul form against the E block of the
    port's one-pass columns and the JAX package's E rows (1e-10)."""
    X, Jc, Xj, Jcj, cols = setup
    dperms = PERMS[n_perms]
    got = kernel_ops.assemble_kernel_E_rows(X, Jc, dperms, SIG, N_ATOMS, cols, tile_i=7).numpy()
    full = kernel_ops.assemble_kernel_columns(X, Jc, dperms, SIG, N_ATOMS, cols, use_E_cstr=True).numpy()[M * 18:]
    ref = np.asarray(jax_kernel.assemble_kernel_E_rows(Xj, Jcj, dperms, SIG, N_ATOMS, cols))
    np.testing.assert_allclose(got, full, rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-11)


def _apply_jax(F, v):
    sF, sigF = F
    vp = jnp.pad(jnp.asarray(v), (0, sF.shape[2] - v.shape[0]))
    return np.asarray(jax_it._factor_apply_ozaki(sF, sigF, vp))[:v.shape[0]]


def _apply(F, v):
    return it_mod._precond(F, torch.as_tensor(v), 1.0).numpy()


@pytest.mark.parametrize('n_slices', [8, 6])
@pytest.mark.parametrize('use_E_cstr', [False, True])
def test_streamed_factor_matches_jax(setup, n_slices, use_E_cstr):
    """The streamed build against the JAX package's: leverage scores within
    1e-6 (plain sums of F^2), the Woodbury apply within 1e-7 of |v| on a
    random vector, the per-chunk scales of the 8-slice stack equal; the
    stack is laid out for in-place products (chunks at a stride of 16, rows
    padded to 16, zeros in the padding)."""
    X, Jc, Xj, Jcj, cols = setup
    n = M * 18 + (M if use_E_cstr else 0)
    F, lev = it_mod.Iterative(GDMLTrain(device='cpu'), factor_mode='ozaki', factor_slices=n_slices,
                              device='cpu')._build_factor(X, Jc, PERMS[1], SIG, LAM, cols, N_ATOMS, use_E_cstr)
    F_j, lev_j = jax_it.Iterative(JaxTrain(), factor_mode='ozaki', factor_slices=n_slices)._build_factor(
        Xj, Jcj, PERMS[1], SIG, LAM, cols, N_ATOMS, use_E_cstr)
    assert lev.shape == (n,)
    np.testing.assert_allclose(lev, np.asarray(lev_j), rtol=1e-6, atol=1e-12)
    v = np.random.default_rng(0).standard_normal(n)
    assert np.linalg.norm(_apply(F, v) - _apply_jax(F_j, v)) / np.linalg.norm(v) < 1e-7
    assert it_mod._factor_ncols(F) == F_j[0].shape[2] and F.rows == len(cols)
    if n_slices == 8:
        np.testing.assert_array_equal(F.sig.numpy(), np.asarray(F_j[1]))
    n_ch = F.sig.shape[0]
    stride = F.s.shape[2] // n_ch
    assert F.s.shape[:2] == (n_slices, 48) and stride % 16 == 0 and F.s.is_contiguous()
    assert not F.s[:, F.rows:].any() and not F.s.view(n_slices, 48, n_ch, stride)[..., F.width:].any()


def test_six_slice_factor_is_psd_and_close(setup):
    """factor_slices=6: the represented ``I - F^T F`` stays PSD (power
    iteration on the stack's own products: norm <= 1), and the apply agrees
    with the 8-slice stack's to 1e-5 of |w| (tests/test_streamed_factor.py:
    176-218)."""
    X, Jc, _, _, cols = setup
    factors = {ns: it_mod.Iterative(GDMLTrain(device='cpu'), factor_mode='ozaki', factor_slices=ns,
                                    device='cpu')._build_factor_streamed(X, Jc, PERMS[1], SIG, LAM, cols, N_ATOMS)[0]
               for ns in (8, 6)}
    F6 = factors[6]
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(it_mod._factor_ncols(F6)))
    for _ in range(60):
        u = it_mod._gram_apply(F6, v / torch.linalg.vector_norm(v))
        v, nrm = u, float(torch.linalg.vector_norm(u))
    assert nrm <= 1.0, nrm
    w = rng.standard_normal(M * 18)
    assert np.linalg.norm(_apply(F6, w) - _apply(factors[8], w)) / np.linalg.norm(w) < 1e-5


def test_streamed_budgets_match_jax(monkeypatch, caplog):
    """resolve_factor_slices and max_n_inducing_pts(streamed=True) equal the
    JAX package's at its tests' budgets (tests/test_iterative.py:653-685,
    test_streamed_factor.py:103-113, 221-231); at an aspirin-like budget
    (N=21, M=1000, 79 GB) the two bounds past the JAX plan set k, with a
    log line, and the AT-AT width on the same card stays at the plan."""
    monkeypatch.delenv('SGDML_FACTOR_SLICES', raising=False)
    for gb, m, n in ((15.5, 3000, 60), (12, 24, 5), (15.5, 200, 21), (79 / 1.073741824, 3000, 60)):
        ours, ref = it_mod.Iterative(max_memory=gb, device='cpu'), jax_it.Iterative(max_memory=gb)
        assert ours.resolve_factor_slices(m, n) == ref.resolve_factor_slices(m, n), (gb, m, n)
        for fb in (9.0, 7.0, 16.0):
            assert it_mod.Iterative.max_n_inducing_pts(m, n, gb * 1024**3, factor_bytes=fb, streamed=True) == \
                jax_it.Iterative.max_n_inducing_pts(m, n, gb * 1024**3, factor_bytes=fb, streamed=True)
            assert it_mod.Iterative.max_n_inducing_pts(m, n, gb * 1024**3, factor_bytes=fb) == \
                jax_it.Iterative.max_n_inducing_pts(m, n, gb * 1024**3, factor_bytes=fb)
    assert it_mod.Iterative(max_memory=15.5, device='cpu').resolve_factor_slices(3000, 60) == (6, 15)
    solver = it_mod.Iterative(max_memory=79e9 / 1024**3, factor_mode='ozaki', device='cpu')
    with caplog.at_level(logging.INFO, logger=LOGGER):
        assert solver._factor_plan(3000, 60) == jax_it.Iterative.max_n_inducing_pts(
            3000, 60, 79e9, factor_bytes=7.0, streamed=True) == 81 and solver._ns() == 6
        assert 'capped' not in caplog.text and 'Auto-selected the 6-slice' in caplog.text
        k = solver._factor_plan(1000, 21)
    assert solver._ns() == 8 and k == ozaki.max_contraction_dim(8) // 63 == 462
    assert 'capped at k=462' in caplog.text and 'the plan affords 1000' in caplog.text
    caps = it_mod.Iterative._streamed_caps(1000, 21, 30e9, 8)
    assert caps['blocks'] == int(np.sqrt(0.28 * 30e9 / 16)) // 63 < caps['int32'] < caps['plan']
