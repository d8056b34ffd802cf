"""The fused (E, F) contraction's plain version and wrapper on the CPU,
held against the JAX package: the Pallas kernel in interpret mode and the
XLA ``predict_from_tables``. The CUDA kernel itself runs only on a GPU
(``python3 chip_smoke.py``); on CPU tensors the wrapper takes the plain
version and never builds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu import predict as jax_predict
from sgdml_tpu.datasets.synthetic import generate_md_dataset
from sgdml_tpu.ops import descriptor as jax_desc
from sgdml_tpu.ops.kernel import Mat52Coeffs as JaxMat52
from sgdml_tpu.ops.pallas_predict import HAS_PALLAS, pallas_predict_tables
from sgdml_tpu_torch import predict
from sgdml_tpu_torch.ops import _build, fused_predict
from sgdml_tpu_torch.ops.kernel import Mat52Coeffs


def _t(x, dtype=torch.float64):
    return torch.tensor(np.array(x), dtype=dtype)


def _problem(n_atoms, m, n_perms, b, seed):
    """Descriptors of synthetic MD frames as tables and queries, random
    alpha-contracted Jacobians, P random permutations and energy weights."""
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=m + b, seed=seed)
    R = ds['R'].reshape(m + b, -1)
    X, Jc = (np.asarray(a) for a in jax_desc.descriptor_batch(jnp.asarray(R), n_atoms))
    rng = np.random.default_rng(seed)
    perms = np.stack([np.arange(n_atoms)] + [rng.permutation(n_atoms) for _ in range(n_perms - 1)])
    dperms = predict.desc_perm_table(perms)
    JA_flat = rng.normal(size=(m, X.shape[1]))
    aE = rng.normal(size=(m * n_perms,))
    return X[:m], JA_flat, dperms, X[m:], Jc[m:], aE


@pytest.mark.skipif(not HAS_PALLAS, reason='pallas unavailable')
def test_plain_version_matches_pallas_interpret_f32():
    """Same inputs as tests/test_pallas_predict.py (B=17 unaligned, tiles
    8/16), pre-centered in f32 on both sides; the Pallas kernel lacks the
    centering, so it gets the centered tables as its inputs."""
    X, JA_flat, dperms, Xq, _, _ = _problem(6, 40, 1, 17, seed=5)
    sig = 7.0
    Xt, JA = predict.build_tables(_t(X), _t(JA_flat), dperms)
    tables = predict.center_tables(Xt.float(), JA.float())
    Xq_c = _t(Xq, torch.float32) - tables.mu

    E_pal, F_pal = pallas_predict_tables(
        Xq_c.numpy(), tables.Xt.numpy(), tables.JA.numpy(), sig,
        tile_b=8, tile_t=16, interpret=True,
    )
    E, F_d = fused_predict.fused_predict_tables_reference(
        Xq_c, tables.Xt, tables.JA, tables.xt_sq, tables.tja, None, sig
    )
    for ours, ref in ((E, E_pal), (F_d, F_pal)):
        ref = np.asarray(ref)
        assert ours.dtype == torch.float32 and ours.shape == ref.shape
        assert np.abs(ours.numpy() - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize('with_aE', [False, True])
@pytest.mark.parametrize(
    'n_atoms,m,n_perms,b',
    [(6, 40, 1, 17), (10, 37, 1, 17), (6, 13, 3, 5)],
    ids=['pallas-shape', 'ragged-T37-D45', 'sym-P3'],
)
def test_predict_from_tables_matches_jax_f64(n_atoms, m, n_perms, b, with_aE):
    """The port's contraction (wrapper -> plain version on the CPU) against
    the JAX package's in f64, energy-constraint term included; T and D of
    the ragged case are multiples of no tile (T=37, D=45)."""
    X, JA_flat, dperms, Xq, Jcq, aE = _problem(n_atoms, m, n_perms, b, seed=11)
    sig, std, c = 6.0, 1.7, -3.2
    aE = aE if with_aE else None

    Xt_j, JA_j = jax_predict.build_tables(jnp.asarray(X), jnp.asarray(JA_flat), dperms)
    E_ref, F_ref = jax_predict.predict_from_tables(
        jnp.asarray(Xq), jnp.asarray(Jcq), Xt_j, JA_j,
        None if aE is None else jnp.asarray(aE), sig, std, c, n_atoms=n_atoms,
    )
    tables = predict.center_tables(*predict.build_tables(_t(X), _t(JA_flat), dperms))
    E, F = predict.predict_from_tables(
        _t(Xq), _t(Jcq), tables, None if aE is None else _t(aE), sig, std, c,
        n_atoms=n_atoms,
    )
    np.testing.assert_allclose(E.numpy(), np.asarray(E_ref), rtol=1e-10)
    np.testing.assert_allclose(
        F.numpy(), np.asarray(F_ref), rtol=1e-10, atol=1e-10 * np.abs(F_ref).max()
    )


def test_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    """CPU tensors never reach the kernel build or the launch counter."""

    def no_build():
        raise AssertionError('the CPU path must not build the CUDA kernel')

    monkeypatch.setattr(_build, 'load_library', no_build)
    X, JA_flat, dperms, Xq, _, aE = _problem(6, 20, 2, 4, seed=2)
    tables = predict.center_tables(*predict.build_tables(_t(X), _t(JA_flat), dperms))
    args = (_t(Xq) - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja, _t(aE), 5.0)
    before = fused_predict.LAUNCHES
    E, F_d = fused_predict.fused_predict_tables(*args)
    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert fused_predict.LAUNCHES == before
    torch.testing.assert_close(E, E_ref, rtol=0, atol=0)
    torch.testing.assert_close(F_d, F_ref, rtol=0, atol=0)


@pytest.mark.parametrize(
    'break_',
    ['meta-device', 'int-dtype', 'mixed-dtype', 'bad-shape', 'bad-aE', 'empty'],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(break_):
    B, T, D = 3, 5, 6
    g = torch.Generator().manual_seed(0)
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64)
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64)
    JA = torch.randn(T, D, generator=g, dtype=torch.float64)
    xt_sq, tja, aE = (Xt * Xt).sum(1), (Xt * JA).sum(1), None
    if break_ == 'meta-device':
        Xq, Xt, JA, xt_sq, tja = (x.to('meta') for x in (Xq, Xt, JA, xt_sq, tja))
    elif break_ == 'int-dtype':
        Xq, Xt, JA, xt_sq, tja = (x.long() for x in (Xq, Xt, JA, xt_sq, tja))
    elif break_ == 'mixed-dtype':
        JA = JA.float()
    elif break_ == 'bad-shape':
        Xt = Xt[:, :-1]
    elif break_ == 'bad-aE':
        aE = torch.zeros(T + 1, dtype=torch.float64)
    else:
        Xq = Xq[:0]
    with pytest.raises(ValueError):
        fused_predict.fused_predict_tables(Xq, Xt, JA, xt_sq, tja, aE, 4.0)


@pytest.mark.parametrize('fn', ['hess', 'grad', 'value'])
def test_mat52_coeffs_match_jax(fn):
    u5 = np.random.default_rng(7).random(50) * 30.0
    ours = getattr(Mat52Coeffs, fn)(_t(u5), 4.5)
    ref = getattr(JaxMat52, fn)(jnp.asarray(u5), 4.5)
    if fn != 'hess':  # hess returns the pair (b, cc)
        ours, ref = (ours,), (ref,)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    """With no CUDA compiler the build raises a RuntimeError that names
    nvcc; it neither falls back nor creates its build directory."""
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'isfile', lambda path: False)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'kernels')
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.load_library.__wrapped__()
    assert not (tmp_path / 'kernels').exists()
