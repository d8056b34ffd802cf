"""The fused (E, F) contraction's plain version and wrapper on the CPU,
held against the JAX package: the Pallas kernel in interpret mode and the
XLA ``predict_from_tables``. The CUDA kernel itself runs only on a GPU
(``python3 chip_smoke.py``); on CPU tensors the wrapper takes the plain
version and never builds. The wide route's kernel is held against its
plain version on a card in ``tests/test_torch_wide_card.py``."""

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
from sgdml_tpu_torch.utils import profiling


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
    composed: equal to ``fused_predict_tables_reference`` and, after the
    scaling and the Jacobian map, to the JAX package's ``predict_from_tables``.
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
    T at no tile edge) gives ``fused_predict_tables_reference``'s result."""
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


_ABOVE_SPLIT_T = fused_predict.SPLIT_T_MAX_B + 1  # a batch past the split-T route


# The table size T names each shape; the route does not read it.
@pytest.mark.parametrize(
    'T,D,B,expected',
    [
        (512, 32, _ABOVE_SPLIT_T, 'two_pass'),
        # The descriptors' bytes at their edge: 2 queries of 4096 f64 take
        # SPLIT_T_XQ_BYTES exactly, one column more does not.
        (513, fused_predict.SPLIT_T_XQ_BYTES // 16, 2, 'split_t'),
        (32, fused_predict.SPLIT_T_XQ_BYTES // 16 + 1, 2, 'two_pass'),
        (32, 512, _ABOVE_SPLIT_T, 'two_pass'),
        (32, fused_predict.SPLIT_T_XQ_BYTES // 16 + 1, _ABOVE_SPLIT_T, 'two_pass'),
        (1, 1, _ABOVE_SPLIT_T, 'two_pass'),
        (30, 10, _ABOVE_SPLIT_T, 'two_pass'),       # the golden model: N=5, M=30
        (1000, 36, _ABOVE_SPLIT_T, 'two_pass'),     # ethanol width, M=1000
        (3000, 1770, _ABOVE_SPLIT_T, 'two_pass'),   # AT-AT width
        # The split-T route: at its batch bound and one over.
        (1000, 210, fused_predict.SPLIT_T_MAX_B, 'split_t'),
        (1000, 210, fused_predict.SPLIT_T_MAX_B + 1, 'two_pass'),
        (1000, 36, fused_predict.SPLIT_T_MAX_B, 'split_t'),
        (1000, 36, fused_predict.SPLIT_T_MAX_B + 1, 'two_pass'),
        # MD and the calculator: one geometry at the aspirin and AT-AT widths.
        (1000, 210, 1, 'split_t'),
        (3000, 1770, 1, 'split_t'),
        # The descriptors' bytes: 4 AT-AT queries in SPLIT_T_XQ_BYTES, 5 not.
        (3000, 1770, 4, 'split_t'),
        (3000, 1770, 5, 'two_pass'),
        # The golden model's small table takes split T up to the batch bound too.
        (30, 10, 1, 'split_t'),
        (30, 10, 3, 'split_t'),
        (30, 10, fused_predict.SPLIT_T_MAX_B, 'split_t'),
        (200, 36, fused_predict.SPLIT_T_MAX_B, 'split_t'),  # ethanol M=200
        # atat.serve_test's bucket of 256, and CG matvecs (B = T): unchanged.
        (3000, 1770, 256, 'two_pass'),
        (600, 1770, 600, 'two_pass'),
        (1000, 210, 1000, 'two_pass'),
        # The wide route past split T's bytes: one geometry at 128 atoms
        # (D = 8,128) and at 8,192 columns stays on split T, one column more
        # and the 129 and 148 atoms of MD22 (the buckyball catcher) do not.
        (600, 8128, 1, 'split_t'),
        (600, 8192, 1, 'split_t'),
        (600, 8193, 1, 'wide'),
        (600, 8256, 1, 'wide'),
        (600, 10_878, 1, 'wide'),
        (600, 10_878, fused_predict.WIDE_MAX_B, 'wide'),
        # Batches that only their count takes past split T's bytes keep two
        # passes: GDMLPredict's buckets of 2 and 4 at MD22's AT-AT-CG-CG (N =
        # 118) and stachyose (N = 87), and 2 geometries one column short of
        # the wide route's width.
        (600, 6903, 2, 'two_pass'),
        (600, 6903, 4, 'two_pass'),
        (600, 3741, 4, 'two_pass'),
        (600, 8192, 2, 'two_pass'),
        (600, 8193, 2, 'wide'),
        (600, 10_878, fused_predict.WIDE_MAX_B + 1, 'two_pass'),
        (600, 10_878, 600, 'two_pass'),  # the buckyball's CG matvecs
        # The widest slice the kernel takes: 4 x 480 x 6 columns (152 atoms).
        (600, 11_476, 1, 'wide'),
        (600, 11_520, 1, 'wide'),
        (600, 11_521, 1, 'two_pass'),
        (800, 68_265, 1, 'two_pass'),  # MD22's nanotube, N = 370
    ],
)
def test_route_at_its_edges(T, D, B, expected):
    assert fused_predict.route(D, B) == expected


def _old_route(D, B):
    """The route before the wide route existed."""
    return 'split_t' if B <= fused_predict.SPLIT_T_MAX_B and B * D * 8 <= fused_predict.SPLIT_T_XQ_BYTES else 'two_pass'


def test_route_keeps_every_batch_the_wide_route_does_not_take():
    """Every batch within split T's bytes, above WIDE_MAX_B or of queries
    that split T would take one at a time keeps its route; the others take
    the wide route where its kernel takes their width."""
    for B in range(1, 3 * fused_predict.SPLIT_T_MAX_B):
        for D in sorted({*range(1, 600, 7), *range(2040, 2090), *range(4090, 4100), *range(8000, 8400),
                         10_878, 11_520, 11_521, 40_000}):
            if D * 8 <= fused_predict.SPLIT_T_XQ_BYTES or B > fused_predict.WIDE_MAX_B:
                assert fused_predict.route(D, B) == _old_route(D, B), (D, B)
            else:
                assert fused_predict.route(D, B) == ('wide' if D <= 11_520 else 'two_pass'), (D, B)


def test_chip_smoke_bound_counts_with_the_package_peaks():
    """``chip_smoke.bound`` takes its operations from ``bench.k1_flops`` and
    its peaks from ``bench``: K1's least time at AT-AT B=512 (by
    operations) and at aspirin B=1 (by bytes), to the bit."""
    import chip_smoke

    assert chip_smoke.bound(512, 3000, 1770, 8) == (0.3246232835820896, 'operations')
    assert chip_smoke.bound(1, 1000, 210, 8) == (0.001008766567164179, 'bytes')


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


@pytest.mark.parametrize('fn', ['two_pass', 'planes', 'forces', 'split_t', 'wide'])
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
    tol = 0 if fn not in ('two_pass', 'split_t', 'wide') else 1e-12
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=tol, atol=tol * float(r.abs().max()))


def test_reset_launches_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(fused_predict, 'LAUNCHES', 7)
    monkeypatch.setitem(fused_predict.PATH_LAUNCHES, 'pass_a', 3)
    monkeypatch.setitem(fused_predict.PATH_LAUNCHES, 'split_t', 2)
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
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120fused_predict_kernelIdLi4EEEvPKT_' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 128 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120fused_predict_kernelIdNS_4WideILi1EEEEEvNS_8WideArgsIT_EE' for 'sm_90a'\n"
        "ptxas info    : Used 96 registers\n"
    )

    class Lib:
        _name = str(lib)

    report = _build.ptxas_report(Lib())
    assert set(report) == {'planes_kernel<double>', 'reduce_kernel<float>', 'fused_predict_kernel<double, 4>',
                           'fused_predict_kernel<double, Wide<1>>'}
    assert '0 bytes spill stores' in report['planes_kernel<double>']
    assert 'Used 122 registers' in report['planes_kernel<double>']
    assert report['reduce_kernel<float>'] == 'Used 32 registers'
    assert report['fused_predict_kernel<double, 4>'] == 'Used 128 registers'
    assert report['fused_predict_kernel<double, Wide<1>>'] == 'Used 96 registers'


@pytest.mark.parametrize('blocks', ['one', 'ragged', 'more-than-T'])
@pytest.mark.parametrize('B', [1, 3, fused_predict.SPLIT_T_MAX_B])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('with_aE', [False, True])
@pytest.mark.parametrize(
    'n_atoms,m,n_perms', [(10, 37, 1), (6, 13, 3)], ids=['ragged-T37-D45', 'sym-P3'],
)
def test_split_t_plain_version_matches_reference_and_jax(n_atoms, m, n_perms, with_aE, dtype, B, blocks):
    """The split-T route's plain version: the table cut into one run, into 5
    runs of 8 rows (T=37 and 39 end in a shorter run), or into more runs
    than rows (the runs past T empty), the block partials added as the
    reduction adds them; equal to ``fused_predict_tables_reference`` and,
    after the scaling and the Jacobian map, to the JAX package's ``predict_from_tables``.
    Bounds relative to max |value|: f64 1e-12, f32 1e-5."""
    X, JA_flat, dperms, Xq, Jcq, aE = _problem(n_atoms, m, n_perms, B, seed=11)
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
    n_blocks = {'one': 1, 'ragged': 5, 'more-than-T': T + 3}[blocks]
    assert blocks != 'ragged' or T % -(-T // n_blocks) != 0

    E, F_d = fused_predict.split_t_reference(*args, n_blocks)
    assert E.dtype == F_d.dtype == dtype and E.shape == (B,) and F_d.shape == (B, tables.Xt.shape[1])
    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert _rel(E, E_ref) <= bound and _rel(F_d, F_ref) <= bound
    E_s, F_s = predict._scale(E, F_d, _t(Jcq, dtype), std, c, n_atoms)
    assert _rel(E_s, E_jax) <= bound and _rel(F_s, F_jax) <= bound
    # The CPU wrapper takes the plain version with the blocks it is given.
    E_w, F_w = fused_predict.split_t(*args, blocks=n_blocks)
    assert torch.equal(E_w, E) and torch.equal(F_w, F_d)


def test_split_t_reduction_adds_runs_of_blocks_in_order():
    """With more blocks than SPLIT_T_REDUCE_RUNS, the block partials are
    added in runs of consecutive blocks, then the runs: the same sum, to
    rounding, as one run, and the blocks past T add nothing."""
    g = torch.Generator().manual_seed(4)
    B, T, D = 2, 300, 20
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64) * 0.3
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64) * 0.3
    JA = torch.randn(T, D, generator=g, dtype=torch.float64) * 1e-2
    args = (Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * JA).sum(1), None, 1.5)
    assert 100 > fused_predict.SPLIT_T_REDUCE_RUNS
    E1, F1 = fused_predict.split_t_reference(*args, 1)
    for blocks in (100, 150, 301, 700):  # 3, 2, 1 and 1 rows a block
        E, F_d = fused_predict.split_t_reference(*args, blocks)
        assert _rel(E, E1) <= 1e-13 and _rel(F_d, F1) <= 1e-13


@pytest.mark.parametrize(
    'T,n_sms,expected',
    [
        (1000, 132, 125),  # aspirin: 8 rows a block, one for each warp
        (3000, 132, 250),  # AT-AT: two blocks an SM, 12 rows each
        (30, 132, 4),      # the golden model
        (8, 132, 1),       # one block
        (1, 132, 1),
        (100_000, 132, 264),
    ],
)
def test_split_t_blocks_rule(T, n_sms, expected):
    blocks = fused_predict.split_t_blocks(T, n_sms)
    assert blocks == expected
    rows = -(-T // blocks)
    assert (blocks - 1) * rows < T <= blocks * rows  # no empty block
    assert rows >= min(T, fused_predict.SPLIT_T_WARPS)


@pytest.mark.parametrize('break_', ['too-many-queries', 'too-wide', 'no-blocks', 'mixed-dtype'])
def test_split_t_rejects_what_the_kernel_does_not_take(break_):
    """More than 16 queries, descriptors past a block's shared memory (16 x
    2000 f64 is 256 kB), no blocks, or the inputs the wrapper rejects on
    every route."""
    B, T, D = 3, 5, 6
    if break_ == 'too-many-queries':
        B = 17
    elif break_ == 'too-wide':
        B, D = 16, 2000
    g = torch.Generator().manual_seed(0)
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64)
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64)
    JA = torch.randn(T, D, generator=g, dtype=torch.float64)
    if break_ == 'mixed-dtype':
        JA = JA.float()
    with pytest.raises(ValueError):
        fused_predict.split_t(Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * Xt).sum(1), None, 4.0,
                              blocks=0 if break_ == 'no-blocks' else None)
    if break_ == 'too-wide':  # the same descriptors in f32 fit
        args = [x.float() for x in (Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * JA).sum(1))]
        fused_predict.split_t(*args, None, 4.0)


# -- The wide route ---------------------------------------------------------------------


@pytest.mark.parametrize('clusters', ['one', 'ragged', 'more-than-T'])
@pytest.mark.parametrize('B', [1, fused_predict.WIDE_MAX_B])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('with_aE', [False, True])
def test_wide_plain_version_matches_reference(with_aE, dtype, B, clusters):
    """The wide route's plain version at D = 45 (not a multiple of the
    cluster's 4 blocks; an f32 row is 180 bytes, off 16) and T = 37: the
    table cut into one run, 5 runs of 7 or 8 rows, or more runs than rows
    (the runs past T empty), the slices' partial dots added in rank order;
    equal to ``fused_predict_tables_reference`` within 1e-12 (f64) and 1e-5
    (f32) of max |value|, and what the CPU wrapper returns."""
    X, JA_flat, dperms, Xq, _, aE = _problem(10, 37, 1, B, seed=13)
    tables = predict.center_tables(*predict.build_tables(_t(X, dtype), _t(JA_flat, dtype), dperms))
    args = (_t(Xq, dtype) - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja,
            _t(aE, dtype) if with_aE else None, 6.0)
    T, D = tables.Xt.shape
    assert (T, D) == (37, 45) and D % fused_predict.WIDE_CLUSTER and D * 4 % 16
    n = {'one': 1, 'ragged': 5, 'more-than-T': T + 3}[clusters]
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    E, F_d = fused_predict.wide_reference(*args, n)
    assert E.dtype == F_d.dtype == dtype and E.shape == (B,) and F_d.shape == (B, D)
    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert _rel(E, E_ref) <= bound and _rel(F_d, F_ref) <= bound
    E_w, F_w = fused_predict.wide(*args, clusters=n)
    assert torch.equal(E_w, E) and torch.equal(F_w, F_d)


@pytest.mark.parametrize('D', [8193, 10_878])
def test_wide_plain_version_at_the_route_s_widths(D):
    """At the route's lower edge and the buckyball catcher's width, T = 19
    rows in 4 runs: within 1e-12 of max |value| of the plain contraction,
    the slices of ceil(D / 4) columns ragged at the last."""
    g = torch.Generator().manual_seed(D)
    B, T = fused_predict.WIDE_MAX_B, 19
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64) * 0.05
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64) * 0.05
    JA = torch.randn(T, D, generator=g, dtype=torch.float64) * 1e-2
    args = (Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * JA).sum(1), torch.randn(T, generator=g, dtype=torch.float64),
            float(np.sqrt(D)) * 0.05)
    assert fused_predict.route(D, 1) == 'wide'
    E, F_d = fused_predict.wide_reference(*args, 4)
    E_ref, F_ref = fused_predict.fused_predict_tables_reference(*args)
    assert _rel(E, E_ref) <= 1e-12 and _rel(F_d, F_ref) <= 1e-12


@pytest.mark.parametrize('break_', ['too-many-queries', 'too-wide', 'no-clusters', 'mixed-dtype'])
def test_wide_rejects_what_the_kernel_does_not_take(break_):
    """More than 4 queries, a slice past 480 x 6 columns (D = 11,521), no
    clusters, or the inputs the wrapper rejects on every route."""
    B, T, D = 1, 5, 9000
    if break_ == 'too-many-queries':
        B = 5
    elif break_ == 'too-wide':
        D = 11_521
    g = torch.Generator().manual_seed(0)
    Xq = torch.randn(B, D, generator=g, dtype=torch.float64)
    Xt = torch.randn(T, D, generator=g, dtype=torch.float64)
    JA = torch.randn(T, D, generator=g, dtype=torch.float64)
    if break_ == 'mixed-dtype':
        JA = JA.float()
    with pytest.raises(ValueError):
        fused_predict.wide(Xq, Xt, JA, (Xt * Xt).sum(1), (Xt * Xt).sum(1), None, 4.0,
                           clusters=0 if break_ == 'no-clusters' else None)


@pytest.mark.parametrize('session', [True, False])
def test_launches_reach_the_recorder_under_a_profiler_session(monkeypatch, session):
    """Each count of K1's launches, a graph replay's among them, adds its
    contractions to ``k1.launches`` and its wide launches to
    ``k1.wide_launches`` while a profiler session records, and nothing
    while none does."""
    monkeypatch.setattr(fused_predict, 'LAUNCHES', 0)
    monkeypatch.setattr(fused_predict, 'PATH_LAUNCHES', dict.fromkeys(fused_predict.PATH_LAUNCHES, 0))
    profiling.clear()

    def launches():
        with fused_predict.recording_launches() as recorded:
            fused_predict._count({'total': 1, 'wide': 1}, capturing=True)
            fused_predict._count({'total': 1, 'pass_a': 1, 'pass_b': 1}, capturing=True)
        for _ in range(3):
            fused_predict.count_replay(recorded)
        fused_predict._add({'total': 1, 'wide': 1})

    if session:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            launches()
            counted = profiling.counter('k1.launches'), profiling.counter('k1.wide_launches')
        assert counted == (7, 4)
    else:
        launches()
        assert (profiling.counter('k1.launches'), profiling.counter('k1.wide_launches')) == (0, 0)
    assert fused_predict.LAUNCHES == 7 and fused_predict.PATH_LAUNCHES['wide'] == 4
