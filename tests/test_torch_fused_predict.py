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


def _rel(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('splits', [1, 3])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('with_aE', [False, True])
@pytest.mark.parametrize(
    'n_atoms,m,n_perms,b',
    [(6, 40, 1, 17), (10, 37, 1, 17), (6, 13, 3, 5)],
    ids=['pallas-shape', 'ragged-T37-D45', 'sym-P3'],
)
def test_two_pass_plain_versions_match_reference_and_jax(n_atoms, m, n_perms, b, with_aE, dtype, splits):
    """Pass A's planes and per-tile row sums, then pass B cut into ``splits``
    K runs (3 runs of 3, 3 and 2 steps cut T=37, 39 and 40 at no tile edge),
    composed: equal to the one-pass plain version and, after the scaling
    and the Jacobian map, to the JAX package's ``predict_from_tables``.
    Bounds relative to max |value|: f64 1e-12, f32 1e-5."""
    X, JA_flat, dperms, Xq, Jcq, aE = _problem(n_atoms, m, n_perms, b, seed=11)
    sig, std, c = 6.0, 1.7, -3.2
    aE = aE if with_aE else None
    bound = 1e-12 if dtype == torch.float64 else 1e-5

    Xt_j, JA_j = jax_predict.build_tables(jnp.asarray(X), jnp.asarray(JA_flat), dperms)
    E_jax, F_jax = jax_predict.predict_from_tables(
        jnp.asarray(Xq), jnp.asarray(Jcq), Xt_j, JA_j,
        None if aE is None else jnp.asarray(aE), sig, std, c, n_atoms=n_atoms,
    )
    tables = predict.center_tables(*predict.build_tables(_t(X, dtype), _t(JA_flat, dtype), dperms))
    args = (_t(Xq, dtype) - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja,
            None if aE is None else _t(aE, dtype), sig)
    T = tables.Xt.shape[0]
    n_k = 2 * fused_predict.TILE // fused_predict.K_STEP  # T < TILE: one table tile
    per = -(-n_k // splits)

    planes, e_part, s_part = fused_predict.planes_reference(*args)
    assert planes.shape == (b, 2 * fused_predict.TILE) and e_part.shape == s_part.shape == (b, 1)
    assert not planes[:, T:fused_predict.TILE].any() and not planes[:, fused_predict.TILE + T:].any()
    E, F_d = fused_predict.forces_reference(*args[:3], planes, e_part, s_part, splits, per)
    assert E.dtype == F_d.dtype == dtype

    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert _rel(E, E_ref) <= bound and _rel(F_d, F_ref) <= bound
    E_s, F_s = predict._scale(E, F_d, _t(Jcq, dtype), std, c, n_atoms)
    assert _rel(E_s, E_jax) <= bound and _rel(F_s, F_jax) <= bound


def test_two_pass_partial_sums_over_several_table_tiles():
    """T=150 spans three table tiles: the per-tile row sums add up to the
    plain planes' row sums, and the rule's K split (here 2 runs, cutting
    T at no tile edge) gives the one-pass result."""
    g = torch.Generator().manual_seed(3)
    B, T, D = 7, 150, 20
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64) * 0.3
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64) * 0.3
    JA = torch.randn(T, D, generator=g, dtype=torch.float64) * 1e-2
    aE = torch.randn(T, generator=g, dtype=torch.float64)
    args = (Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * JA).sum(1), aE, 1.5)
    planes, e_part, s_part = fused_predict.planes_reference(*args)
    assert planes.shape == (B, 2 * 192) and e_part.shape == (B, 3)
    torch.testing.assert_close(s_part.sum(1), planes[:, :192].sum(1), rtol=1e-13, atol=0)
    splits, per = fused_predict.split_k(B, D, T, n_sms=2)
    assert (splits, per) == (2, 12)
    E, F_d = fused_predict.forces_reference(*args[:3], planes, e_part, s_part, splits, per)
    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert _rel(E, E_ref) <= 1e-12 and _rel(F_d, F_ref) <= 1e-12


@pytest.mark.parametrize(
    'T,D,expected',
    [
        (32 * fused_predict.ONE_PASS_MAX_STEPS, 32, 'one_pass'),      # at the bound
        (32 * fused_predict.ONE_PASS_MAX_STEPS + 1, 32, 'two_pass'),  # one step over
        (32, 32 * fused_predict.ONE_PASS_MAX_STEPS, 'one_pass'),
        (32, 32 * fused_predict.ONE_PASS_MAX_STEPS + 1, 'two_pass'),
        (1, 1, 'one_pass'),
        (30, 10, 'one_pass'),       # the golden model: N=5, M=30
        (1000, 36, 'two_pass'),     # ethanol width, M=1000
        (3000, 1770, 'two_pass'),   # AT-AT width
    ],
)
def test_route_at_its_edges(T, D, expected):
    assert fused_predict.route(T, D) == expected


@pytest.mark.parametrize(
    'B,D,T,n_sms,expected',
    [
        (512, 1770, 3000, 132, (1, 376)),   # 8 x 28 blocks fill the card
        (1, 1770, 3000, 132, (5, 76)),      # 28 blocks: five runs, the last of 72 steps
        (64, 1770, 3000, 132, (5, 76)),     # one row tile, as B=1
        (65, 1770, 3000, 132, (3, 126)),    # 56 blocks
        (1024, 210, 1000, 132, (3, 43)),    # 64 blocks
        (17, 45, 37, 132, (1, 8)),          # 8 K steps cannot be split further
        (1, 36, 1000, 132, (16, 8)),        # at least 8 steps a run
    ],
)
def test_split_k_rule(B, D, T, n_sms, expected):
    splits, per = fused_predict.split_k(B, D, T, n_sms)
    assert (splits, per) == expected
    n_k = 2 * -(-T // fused_predict.TILE) * fused_predict.TILE // fused_predict.K_STEP
    assert (splits - 1) * per < n_k <= splits * per  # no empty run


@pytest.mark.parametrize('fn', ['one_pass', 'two_pass', 'planes', 'forces'])
def test_route_and_pass_wrappers_take_plain_versions_for_cpu_tensors(monkeypatch, fn):
    """CPU tensors never reach the kernel build or a launch count."""

    def no_build():
        raise AssertionError('the CPU path must not build the CUDA kernel')

    monkeypatch.setattr(_build, 'load_library', no_build)
    X, JA_flat, dperms, Xq, _, aE = _problem(6, 20, 2, 4, seed=2)
    tables = predict.center_tables(*predict.build_tables(_t(X), _t(JA_flat), dperms))
    args = (_t(Xq) - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja, _t(aE), 5.0)
    before = (fused_predict.LAUNCHES, dict(fused_predict.PATH_LAUNCHES))
    if fn == 'planes':
        out, ref = fused_predict.planes(*args), fused_predict.planes_reference(*args)
    elif fn == 'forces':
        planes = fused_predict.planes_reference(*args)
        out = fused_predict.forces(*args[:3], *planes, 2, 4)
        ref = fused_predict.forces_reference(*args[:3], *planes, 2, 4)
    else:
        out = getattr(fused_predict, fn)(*args)
        ref = fused_predict.fused_predict_tables_reference(*args)
    assert (fused_predict.LAUNCHES, fused_predict.PATH_LAUNCHES) == before
    tol = 0 if fn != 'two_pass' else 1e-12
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=tol, atol=tol * float(r.abs().max()))


def test_reset_launches_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(fused_predict, 'LAUNCHES', 7)
    monkeypatch.setitem(fused_predict.PATH_LAUNCHES, 'pass_a', 3)
    monkeypatch.setitem(fused_predict.PATH_LAUNCHES, 'one_pass', 2)
    fused_predict.reset_launches()
    assert fused_predict.LAUNCHES == 0 and set(fused_predict.PATH_LAUNCHES.values()) == {0}


@pytest.mark.parametrize('break_', ['split-short', 'split-empty-run', 'planes-shape', 'parts-dtype'])
def test_forces_rejects_what_the_kernel_does_not_take(break_):
    B, T, D = 3, 5, 6
    g = torch.Generator().manual_seed(0)
    Xq, Xt, JA = (torch.randn(n, D, generator=g, dtype=torch.float64) for n in (B, T, T))
    planes, e_part, s_part = fused_predict.planes_reference(
        Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * JA).sum(1), None, 4.0)
    splits, per = 1, 8  # T=5: one table tile, 8 K steps
    if break_ == 'split-short':
        per = 7
    elif break_ == 'split-empty-run':
        splits, per = 3, 4
    elif break_ == 'planes-shape':
        planes = planes[:, :-1]
    else:
        e_part = e_part.float()
    with pytest.raises(ValueError):
        fused_predict.forces(Xq, Xt, JA, planes, e_part, s_part, splits, per)


def test_ptxas_report_names_each_kernel(tmp_path):
    """The ptxas report beside a built library is read per kernel, named
    by its function and scalar type."""
    lib = tmp_path / 'libsgdml_kernels_0.so'
    lib.with_suffix('.ptxas.txt').write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113planes_kernelIdNS_3CfgIdLi2EEEEEvPKT_' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113planes_kernelIdNS_3CfgIdLi2EEEEEvPKT_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 122 registers, 512 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113reduce_kernelIfEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers\n"
    )

    class Lib:
        _name = str(lib)

    report = _build.ptxas_report(Lib())
    assert set(report) == {'planes_kernel<double>', 'reduce_kernel<float>'}
    assert '0 bytes spill stores' in report['planes_kernel<double>']
    assert 'Used 122 registers' in report['planes_kernel<double>']
    assert report['reduce_kernel<float>'] == 'Used 32 registers'
