"""The port's bucketed geometry serving and its CUDA-graph bookkeeping on the
CPU, against the JAX package: the bucket ladder and padding, the padded path's
results, no aliasing between calls, the buckets dropped (and the results
following) when the tables or coefficients change, and K1's launch counts
under capture and replay. On the CPU a bucket runs its body eagerly over the
same static buffers that a GPU's graph replays."""

import gc
import pathlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.predict import GDMLPredict as JaxPredict
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import fused_predict
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import graphs, io

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def golden():
    data = np.load(GOLDEN / 'train_predict_ref.npz', allow_pickle=True)
    return dict(data), io.load_dict(str(GOLDEN / 'model_ref.npz'))


def _queries(data, B, seed=0):
    """B geometries near the golden test set (numpy-seeded jitter)."""
    R = data['R_test'].reshape(len(data['R_test']), -1)
    rng = np.random.default_rng(seed)
    return R[rng.integers(0, len(R), size=B)] + 0.01 * rng.normal(size=(B, R.shape[1]))


def _rel(ours, ref):
    return np.abs(np.asarray(ours) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize('batch_size', [1, 16, 1000, 1024])
def test_bucket_and_pad_match_jax(golden, batch_size):
    _, model = golden
    ours = GDMLPredict(model, batch_size=batch_size, device='cpu')
    ref = JaxPredict(model, batch_size=batch_size)
    for B in range(1, 2101):
        assert (ours._bucket(B), ours._pad(B)) == (ref._bucket(B), ref._pad(B)), B


@pytest.mark.parametrize('B', [1, 3, 17, 65])
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_padded_geometry_path_matches_jax(golden, dtype, B):
    """Requests that need no, some and several buckets' padding at batch size
    16, against JAX's predict at the same batch size and against the port
    unpadded (batch size B: one bucket of B). Padded rows never reach a
    result. f64 within 1e-12 of max |value|. f32 within 3e-4 of JAX: both
    sides round in f32 and sum in other orders, and E = E_raw std + c with
    c = 44.7 against |E| <= 0.45 here; across these four B the two
    packages' f32 answers differ by up to 2.1e-4 in E and 2.0e-4 in F."""
    data, model = golden
    R = _queries(data, B)
    pred = GDMLPredict(model, dtype=getattr(torch, dtype), batch_size=16, device='cpu')
    E, F = pred.predict(R)
    E_j, F_j = JaxPredict(model, dtype=getattr(jnp, dtype), batch_size=16).predict(R)
    assert E.shape == (B,) and F.shape == (B, R.shape[1]) and E.dtype == np.dtype(dtype)
    tol = 1e-12 if dtype == 'float64' else 3e-4
    assert _rel(E, E_j) <= tol and _rel(F, F_j) <= tol, (_rel(E, E_j), _rel(F, F_j))
    assert list(pred._buckets) == [pred._bucket(B)]
    E_1, F_1 = GDMLPredict(model, dtype=getattr(torch, dtype), batch_size=B, device='cpu').predict(R)
    tol = 1e-12 if dtype == 'float64' else 1e-6
    assert _rel(E, E_1) <= tol and _rel(F, F_1) <= tol


def test_results_of_one_call_survive_the_next(golden):
    """The static outputs of a bucket are copied out: a call's arrays are
    not the next call's."""
    data, model = golden
    pred = GDMLPredict(model, batch_size=16, device='cpu')
    E1, F1 = pred.predict(_queries(data, 3, seed=1))
    kept = E1.copy(), F1.copy()
    E2, F2 = pred.predict(_queries(data, 3, seed=2))
    np.testing.assert_array_equal(E1, kept[0])
    np.testing.assert_array_equal(F1, kept[1])
    assert np.abs(E2 - E1).max() > 0


@pytest.mark.parametrize('change', ['set_R_desc', 'set_alphas', 'batch_size'])
def test_buckets_are_dropped_and_results_follow(golden, change):
    """A bucket reads the tables and coefficients it was made with (by
    address, as a graph does): a change of them, or of the batch size, drops
    every bucket, and the next request answers with the new ones, as the JAX
    package does."""
    data, model = golden
    n_atoms = model['z'].shape[0]
    R = _queries(data, 5)
    pred = GDMLPredict(model, batch_size=4, device='cpu')
    ref = JaxPredict(model, batch_size=4)
    E0, _ = pred.predict(R)
    assert pred._buckets
    R_train = data['R'][data['idxs_train']].reshape(len(data['idxs_train']), -1)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(R_train), n_atoms)
    if change == 'set_R_desc':
        X = X * 1.02
        pred.set_R_desc(X)
        ref.set_R_desc(jnp.asarray(X.numpy()))
    elif change == 'set_alphas':
        pred.set_R_desc(X)
        pred.set_R_d_desc(Jc)
        ref.set_R_desc(jnp.asarray(X.numpy()))
        ref.set_R_d_desc(jnp.asarray(Jc.numpy()))
        pred.predict(R)
        assert pred._buckets
        rng = np.random.default_rng(5)
        alphas_F, alphas_E = rng.normal(size=model['alphas_F'].shape), rng.normal(size=len(R_train))
        out = pred.predict_train_forces(alphas_F, alphas_E)
        np.testing.assert_allclose(out, ref.predict_train_forces(alphas_F, alphas_E), rtol=1e-10,
                                   atol=1e-10 * np.abs(out).max())
    else:
        pred.batch_size = 8
        assert pred.batch_size == 8
    assert pred._buckets == {}
    E, F = pred.predict(R)
    E_j, F_j = ref.predict(R)
    assert _rel(E, E_j) <= 1e-10 and _rel(F, F_j) <= 1e-10
    if change != 'batch_size':
        assert np.abs(E - E0).max() > 1e-6 * np.abs(E0).max()  # the change reached the answer


def test_buckets_and_engines_need_no_cyclic_collector(golden):
    """A predictor, its buckets and an MD run's programs are freed by their
    reference counts: a cycle would leave their graphs to the cyclic
    collector, which on a GPU could free them while another graph is
    captured and invalidate that capture."""
    data, model = golden
    enabled = gc.isenabled()
    gc.disable()
    try:
        pred = GDMLPredict(model, batch_size=4, device='cpu')
        pred.predict(_queries(data, 5))
        refs = [weakref.ref(pred)] + [weakref.ref(b) for b in pred._buckets.values()]
        refs += [weakref.ref(b.run) for b in pred._buckets.values()]
        del pred
        eng = MDEngine(model, device='cpu')
        r0 = data['R_test'][0].reshape(-1, 3)
        eng.run_langevin(r0, np.zeros_like(r0), dt=0.02, n_steps=6, snapshot_every=3)
        refs.append(weakref.ref(eng))
        del eng
        assert all(ref() is None for ref in refs)
    finally:
        if enabled:
            gc.enable()


def test_launches_are_recorded_at_capture_and_counted_at_replay(monkeypatch):
    """A launch inside a capture is recorded, not counted; each replay
    counts what its capture recorded; a capture outside the recording (or a
    recording without a capture) raises."""
    for name, value in [('LAUNCHES', 0), ('PATH_LAUNCHES', {'pass_a': 0, 'pass_b': 0, 'split_t': 0})]:
        monkeypatch.setattr(fused_predict, name, value)
    two_pass = {'pass_a': 1, 'pass_b': 1, 'total': 1}
    fused_predict._count({'split_t': 1, 'total': 1}, capturing=False)
    with fused_predict.recording_launches() as recorded:
        fused_predict._count(two_pass, capturing=True)
        fused_predict._count(two_pass, capturing=True)
    assert recorded == {'pass_a': 2, 'pass_b': 2, 'total': 2}
    assert fused_predict.LAUNCHES == 1 and fused_predict.PATH_LAUNCHES['pass_a'] == 0
    for _ in range(3):
        fused_predict.count_replay(recorded)
    assert fused_predict.LAUNCHES == 7
    assert fused_predict.PATH_LAUNCHES == {'pass_a': 6, 'pass_b': 6, 'split_t': 1}
    with pytest.raises(RuntimeError, match='miscounted'):
        fused_predict._count(two_pass, capturing=True)
    with pytest.raises(RuntimeError, match='miscounted'), fused_predict.recording_launches():
        fused_predict._count(two_pass, capturing=False)
    assert fused_predict.LAUNCHES == 7 and fused_predict._RECORDING == []


def test_program_without_a_graph_runs_its_body_each_call():
    calls = []
    run = graphs.Program(lambda: calls.append(len(calls)) or len(calls), graph=False)
    assert [run() for _ in range(3)] == [1, 2, 3] and run.cuda_graph is None
    with graphs.on_stream(None):
        assert run() == 4


@pytest.mark.parametrize('engine', [GDMLPredict, MDEngine])
def test_engines_default_to_the_card(golden, engine):
    _, model = golden
    if torch.cuda.is_available():
        eng = engine(model)
        assert eng.device.type == 'cuda' and eng._graphs
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            engine(model)
    assert not engine(model, device='cpu')._graphs
