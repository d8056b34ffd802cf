"""The port's phase timer, recorder and trace helpers (utils/profiling.py),
and the spans and counters of the serving, MD and CG paths."""

import json
import logging
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io, profiling
from sgdml_tpu_torch.utils.profiling import PhaseTimer

GOLDEN = pathlib.Path(__file__).parent / 'golden'
CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
# Run in a fresh process (the record's first profiling session there):
# profile a few requests and print each span's start against its kineto
# event's, as JSON. argv: the device.
KINETO_PROBE = r'''
import json, sys
import numpy as np, torch
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import io, profiling
device = sys.argv[1]
pred = GDMLPredict(io.load_dict(sys.argv[2]), device=device)
R = np.load(sys.argv[3])['R_test'][:5].reshape(5, -1)
pred.predict(R)  # the warm-up: the bucket, and the profiler's first record_function
with torch.profiler.record_function('warm-up'):
    pass
activities = [torch.profiler.ProfilerActivity.CPU]
if device == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
with torch.profiler.profile(activities=activities) as prof:
    for _ in range(20):
        pred.predict(R)
events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                if e.name().startswith('sgdml/') and e.device_type() == torch.autograd.DeviceType.CPU)
on_card = [e.name() for e in prof.profiler.kineto_results.events()
           if e.name().startswith('sgdml/') and e.device_type() != torch.autograd.DeviceType.CPU]
spans = sorted((s['start_ns'], 'sgdml/' + s['name']) for s in profiling.spans())
print(json.dumps({'events': events, 'spans': spans, 'on_card': on_card}))
'''


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def golden():
    model = io.load_dict(str(GOLDEN / 'model_ref.npz'))
    R = np.load(GOLDEN / 'train_predict_ref.npz')['R_test']
    return model, R.reshape(R.shape[0], -1)


def _session():
    """A ``torch.profiler`` session, of the card too where there is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _profile():
    """A session on an empty record: a session that follows another with no
    span between them would continue its record."""
    profiling.clear()
    return _session()


def test_phases_accumulate_and_summarize_like_jax():
    from sgdml_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer

    timers = (PhaseTimer(), JaxPhaseTimer())
    for t in timers:
        for name in ('assembly', 'solve', 'assembly'):
            with t.phase(name):
                pass
    ours, ref = timers
    assert ours.counts == ref.counts == {'assembly': 2, 'solve': 1}
    assert all(v >= 0 for v in ours.durations.values())
    lines, ref_lines = ours.summary().splitlines(), ref.summary().splitlines()
    assert lines[0] == ref_lines[0] and len(lines) == len(ref_lines) == 4
    assert lines[-1].split()[0] == 'total'


@pytest.mark.parametrize('device, syncs', [(None, 0), ('cpu', 0), ('cuda', 2)])
def test_a_cuda_phase_synchronizes_at_its_end(monkeypatch, device, syncs):
    """Launches are asynchronous: a phase on a CUDA device waits for them,
    also when the phase raises."""
    calls = []
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda dev=None: calls.append(dev))
    t = PhaseTimer(device)
    with t.phase('a'):
        assert calls == []
    with pytest.raises(ValueError), t.phase('b'):
        raise ValueError
    assert len(calls) == syncs and set(t.counts) == {'a', 'b'}


def test_trace_records_annotated_regions(tmp_path):
    """A span is a host event of the trace, under its ``sgdml/`` name."""
    with profiling.trace(str(tmp_path)):
        with profiling.span('assembly-region'):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    assert any(e.get('name') == 'sgdml/assembly-region' for e in events)


def test_trace_writes_the_record_beside_the_trace(tmp_path, golden):
    model, R = golden
    pred = GDMLPredict(model, device='cpu')
    with profiling.trace(str(tmp_path)):
        pred.predict(R[:3])
    record = json.loads((tmp_path / 'spans.json').read_text())
    spans = [dict(zip(record['fields'], s)) for s in record['spans']]
    assert sorted({s['name'] for s in spans}) == ['predict', 'predict.launch', 'predict.stage', 'predict.to_host']
    assert record['counters'] == {'predict.geometries': 3, 'predict.rows': 4}
    assert all(s['start_ns'] <= s['end_ns'] for s in spans)


def test_off_the_recorder_records_nothing_and_enters_no_record_function(monkeypatch, golden):
    """Without a profiler session a span is a flag read and a shared null
    context: no profiler event (``record_function`` takes 15 us a call
    here) and nothing recorded."""
    model, R = golden

    def refuse(*args, **kwargs):
        raise AssertionError('a profiler event entered with the profiler off')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refuse)
    profiling.clear()
    pred = GDMLPredict(model, device='cpu')
    pred.predict(R[:3])
    MDEngine(model, device='cpu').run_nve(R[0].reshape(-1, 3), np.zeros((5, 3)), 0.02, 4, snapshot_every=2)
    with profiling.span('x', B=1) as s, PhaseTimer().phase('y'):
        profiling.count('c', 5)
        profiling.note(B=2)
    assert s is None and profiling.span('x') is profiling.span('z')
    assert profiling.spans() == [] and profiling.counter('c') == 0 and profiling.counter('predict.rows') == 0


def test_predict_is_one_root_a_call_and_its_children_share_its_id(golden):
    model, R = golden
    pred = GDMLPredict(model, device='cpu')
    pred.predict(R[:5])
    with _profile():
        for B in (5, 8, 3):
            pred.predict(R[:B])
    roots = profiling.spans('predict')
    assert [(r['attrs']['B'], r['attrs']['bucket']) for r in roots] == [(5, 8), (8, 8), (3, 4)]
    assert all(r['id'] == r['root'] and r['parent'] is None for r in roots)
    by_root = {r['id']: [] for r in roots}
    for s in profiling.spans():
        if s['name'] != 'predict':
            assert s['parent'] == s['root'] and s['root'] in by_root
            by_root[s['root']].append(s['name'])
    # The 8 needs no padding; the CPU has no pinned buffer to stage into.
    assert [sorted(names) for names in by_root.values()] == [
        ['predict.launch', 'predict.stage', 'predict.to_host'], ['predict.launch', 'predict.to_host'],
        ['predict.launch', 'predict.stage', 'predict.to_host']]
    assert profiling.counter('predict.geometries') == 16 and profiling.counter('predict.rows') == 20
    parts = sum(profiling.seconds(n) for n in ('predict.stage', 'predict.launch', 'predict.to_host'))
    assert math.isclose(parts + profiling.self_seconds('predict'), profiling.seconds('predict'), rel_tol=1e-9)
    assert profiling.calls('predict.launch') == 3 and profiling.self_seconds('predict.launch') > 0


def test_a_second_profiling_session_starts_a_fresh_record(golden):
    """A span made with the profiler on, after one that saw it off, starts
    the record anew; ``trace`` starts it anew at its entry in any case."""
    model, R = golden
    pred = GDMLPredict(model, device='cpu')
    pred.predict(R[:5])
    with _session():
        pred.predict(R[:5])
        pred.predict(R[:5])
    assert profiling.calls('predict') == 2
    pred.predict(R[:5])  # off: the record is kept
    assert profiling.calls('predict') == 2
    with _session():
        pred.predict(R[:3])
    assert profiling.calls('predict') == 1 and profiling.counter('predict.geometries') == 3
    with _session():
        profiling.count('c')
    assert profiling.counter('c') == 1 and profiling.calls('predict') == 1  # no span saw the profiler off


def test_trace_starts_the_record_anew_after_another_session(tmp_path, golden):
    model, R = golden
    pred = GDMLPredict(model, device='cpu')
    with _session():
        pred.predict(R[:5])
    with profiling.trace(str(tmp_path)):
        profiling.count('c')
    assert profiling.calls('predict') == 0 and profiling.counter('c') == 1


def test_phases_are_spans_nested_as_they_run():
    t = PhaseTimer('cpu')
    with _profile():
        with t.phase('solve'):
            with t.phase('factor'):
                pass
            with t.phase('cg'):
                pass
    solve, = profiling.spans('solve')
    assert {s['name']: s['parent'] for s in profiling.spans()} == {'solve': None, 'factor': solve['id'],
                                                                    'cg': solve['id']}
    assert t.counts == {'solve': 1, 'factor': 1, 'cg': 1}
    assert profiling.self_seconds('solve') <= profiling.seconds('solve')


def test_kineto_holds_one_event_a_span_at_the_span_s_stamp():
    """In a fresh process, every span is an ``sgdml/`` host event of the
    kineto trace that starts within 1 ms of the recorder's stamp
    (``time.time_ns()``, the clock of kineto's events)."""
    got = _kineto_probe('cpu')
    assert len(got['events']) == len(got['spans']) == 20 * 4 and got['on_card'] == []
    assert [n for _, n in got['events']] == [n for _, n in got['spans']]
    offsets = [abs(s - e) for (s, _), (e, _) in zip(got['spans'], got['events'])]
    assert max(offsets) < 1e6, offsets


def _kineto_probe(device):
    env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
    proc = subprocess.run([sys.executable, '-c', KINETO_PROBE, device, str(GOLDEN / 'model_ref.npz'),
                           str(GOLDEN / 'train_predict_ref.npz')], capture_output=True, text=True, env=env,
                          timeout=240, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_md_blocks_are_one_span_a_snapshot(golden):
    model, R = golden
    eng = MDEngine(model, device='cpu')
    r0, v0 = R[0].reshape(-1, 3), np.random.default_rng(0).normal(size=(5, 3)) * 0.05
    with _profile():
        eng.run_nve(r0, v0, 0.02, 20, snapshot_every=2)
    root, = profiling.spans('md.trajectory')
    assert root['attrs'] == {'steps': 20} and root['id'] == root['root']
    blocks = profiling.spans('md.blocks')
    assert len(blocks) == 10 and profiling.calls('md.to_host') == 1
    assert all(s['root'] == root['id'] for s in profiling.spans())
    assert profiling.counter('graph.captures') == 0  # the CPU runs every block eagerly


def test_host_reads_count_every_read_of_a_cpu_cg_solve(caplog):
    """Each host read the CG loop waits on is a ``host.read`` and one
    ``host_reads``: in each chunk one for each block of
    CG_ACTIVE_READ_ITERS iterations begun, and the one that finds the
    chunk done; outside the chunks the start's residual, the PSD guard of
    each start and replacement, and each chunk's head."""
    n_atoms = 6
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=200, seed=4)
    trainer = GDMLTrain(device='cpu')
    task = trainer.create_task(ds, 30, ds, 8, sig=8.0, lam=1e-10, use_sym=False, use_E=True,
                               rng=np.random.RandomState(3))
    from sgdml_tpu_torch.ops import descriptor as desc_ops

    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(task['R_train'].reshape(30, -1)), n_atoms)
    dperms = np.arange(desc_ops.descriptor_dim(n_atoms))[None, :]
    y = task['F_train'].ravel()
    y_std = float(np.std(y))
    solver = it_mod.Iterative(trainer, max_memory=0.01)
    with caplog.at_level(logging.INFO, logger='sgdml_tpu_torch.solvers.iterative'), _profile():
        out = solver.solve(task, X, Jc, dperms, y / y_std, y_std)
    iters = out[2]
    chunks = profiling.spans('cg.chunk')
    reads = profiling.spans('host.read')
    assert profiling.counter('host_reads') == len(reads) and chunks
    inside = {c['id']: 0 for c in chunks}
    for r in reads:
        if r['parent'] in inside:
            inside[r['parent']] += 1
    per_block = it_mod.CG_ACTIVE_READ_ITERS
    # A chunk of it < CG_CHUNK_ITERS iterations reads ceil(it / 10) + 1
    # times, a full one CG_CHUNK_ITERS / 10 times.
    full = it_mod.CG_CHUNK_ITERS // per_block
    assert all(1 <= k <= full for k in inside.values())
    assert sum(inside.values()) >= -(-iters // per_block)
    replaced = sum('residual replacement' in r.getMessage() for r in caplog.records)
    starts = 1 + sum('re-seeding' in r.getMessage() or 'restarting' in r.getMessage() for r in caplog.records)
    assert len(reads) - sum(inside.values()) == 1 + starts + replaced + len(chunks)


@pytest.mark.card
def test_each_run_nve_call_captures_its_block_once_on_the_card(card, golden):
    """On the chip: ``python3 -m pytest --noconftest tests/test_torch_profiling.py -m card``."""
    model, R = golden
    eng = MDEngine(model, device=card)
    r0, v0 = R[0].reshape(-1, 3), np.zeros((5, 3))
    eng.run_nve(r0, v0, 0.02, 20, snapshot_every=10)
    with _profile():
        for k in range(1, 4):
            eng.run_nve(r0, v0, 0.02, 40, snapshot_every=10)
            assert profiling.counter('graph.captures') == k
    assert profiling.calls('graph.capture') == 3 and profiling.seconds('graph.capture') > 0
    roots = {s['id'] for s in profiling.spans('md.trajectory')}
    assert all(s['root'] in roots for s in profiling.spans('graph.capture'))


@pytest.mark.card
def test_the_spans_stamps_meet_kineto_s_on_the_card(card):
    """The median offset of a span's stamp from its kineto event's start
    is under 50 us on the card (printed with ``-s``), and no span is an
    event of the card's timeline."""
    got = _kineto_probe('cuda')
    offsets = sorted((s - e) * 1e-3 for (s, _), (e, _) in zip(got['spans'], got['events']))
    median = offsets[len(offsets) // 2]
    print('span stamp - kineto start, us: median %.2f, min %.2f, max %.2f over %d spans'
          % (median, offsets[0], offsets[-1], len(offsets)))
    assert [n for _, n in got['events']] == [n for _, n in got['spans']] and got['on_card'] == []
    assert abs(median) < 50
