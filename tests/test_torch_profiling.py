"""The port's phase timer and trace helpers (utils/profiling.py)."""

import json

import pytest
import torch

from sgdml_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from sgdml_tpu_torch.utils import profiling
from sgdml_tpu_torch.utils.profiling import PhaseTimer


def test_phases_accumulate_and_summarize_like_jax():
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
    with profiling.trace(str(tmp_path)):
        with profiling.annotate('assembly-region'):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    assert any(e.get('name') == 'assembly-region' for e in events)
