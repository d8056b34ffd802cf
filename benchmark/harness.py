"""The harness: finds a cell's pieces by name, runs it, and prints the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads

* the configuration's file (``configs[].file`` in ``BENCHMARK.json``),
* ``traffic/<mix>.json``, the mix's parameters, which the one generator
  (``generator.py``) reads and hands to the driver its ``kind`` names,
  ``kinds/<kind>.py``,
* ``workloads/<cell>.json``, what belongs to the cell alone: the limits of
  the numbers that decide ``correct`` and the traced window's length,
* ``metrics/<metric>.py`` for each metric whose ``workloads`` in
  ``BENCHMARK.json`` name the cell: a reader ``read(run)`` that returns
  the metric's value from the run's records (:class:`Run`) or None where
  it finds nothing to read.

So a later cell, configuration, mix or metric is new files and entries.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys
import timeit

import torch

from . import counts, generator, trace

__all__ = ['ROOT', 'Cell', 'Run', 'load_cell', 'run_cell', 'foreign_modules', 'emit']

ROOT = pathlib.Path(__file__).resolve().parent
# Top-level modules that no run of the port may hold, compared whole: the
# port's own name begins with the JAX package's.
FOREIGN = ('jax', 'jaxlib', 'flax', 'sgdml_tpu')


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list
    root: pathlib.Path


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec_path=None, root=None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (``spec_path``, by default
    the one beside this folder) with its pieces from ``root`` (by default
    this folder)."""
    root = pathlib.Path(root) if root else ROOT
    spec_path = pathlib.Path(spec_path) if spec_path else ROOT.parent / 'BENCHMARK.json'
    spec = _json(spec_path)
    entry = next((w for w in spec['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError('no workload %r in %s' % (name, spec_path))
    conf = next(c for c in spec['configs'] if c['name'] == entry['config'])
    config = _json(spec_path.parent / conf['file'])
    e2e = [m for m in spec['end_to_end'] if 'workloads' not in m or name in m['workloads']]
    per_layer = [m for m in spec['per_layer'] if name in m['workloads']]
    return Cell(name, int(entry['chips']), config, _json(root / 'traffic' / (entry['traffic'] + '.json')),
                _json(root / 'workloads' / (name + '.json')), e2e, per_layer, root)


@dataclasses.dataclass
class Run:
    """What the metric readers read: the cell, the set-up's and the
    window's seconds, the units of work done (trainings, requests, chunks)
    and their sum (trainings, geometries, steps), the generator's records,
    and the trace's summary in a traced run."""

    cell: Cell
    setup_s: float
    window_s: float
    units: int
    work: float
    records: dict
    trace: trace.Summary | None = None

    @property
    def table_rows(self) -> int:
        """T: the model's training points (no symmetries: one permutation)."""
        return self.cell.config['n_train']

    @property
    def dim(self) -> int:
        """D: the descriptor's width."""
        return counts.descriptor_dim(self.cell.config['n_atoms'])


def _reader(root: pathlib.Path, name: str):
    return generator.load_file(root, 'metrics', name).read


def foreign_modules() -> list:
    """The modules of ``FOREIGN`` that this process holds."""
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)} & set(FOREIGN))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device='cuda', t_start=None):
    """Run the cell once; returns the result dict of the contract (the
    ``checks`` last) and, apart, the foreign modules found after the window."""
    t_start = timeit.default_timer() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == 'cuda'
    gen = generator.make(cell.config, cell.traffic, seed, device, cell.root)
    gen.setup()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = timeit.default_timer() - t_start
    if traced:
        seconds = min(seconds, cell.workload['trace_seconds'])
    units = work = 0
    with trace.profile(traced, device) as prof:
        t0 = timeit.default_timer()
        while True:
            work += gen.unit()
            units += 1
            if timeit.default_timer() - t0 >= seconds:
                break
        window_s = timeit.default_timer() - t0
    foreign = foreign_modules()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell, setup_s, window_s, units, work, gen.records, prof.get('summary'))
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = _reader(cell.root, m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    gen.free()
    numbers = gen.judge()
    limits = cell.workload['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit'] for c in checks.values())
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': correct, 'attempted': units, 'failed': 0 if correct else 1, 'metrics': metrics,
              'device': dev}
    if traced and run.trace is not None:
        dev['busy_s'], dev['window_s'] = run.trace.busy_s, run.trace.window_s
        result['breakdown'] = run.trace.breakdown()
    result['checks'] = checks
    return result, foreign


def emit(result, foreign, out=None, err=None) -> int:
    """Print the checks as the last lines of standard error and the result
    as the last line of standard output; or, where a foreign module was
    loaded, name it and print no result. Returns the exit code."""
    out, err = out or sys.stdout, err or sys.stderr
    foreign = sorted(set(foreign) | set(foreign_modules()))
    if foreign:
        print('refused: the run loaded %s' % ', '.join(foreign), file=err)
        return 3
    print('%d units of work in the window' % result['attempted'], file=err)
    for name, c in result['checks'].items():
        print('check %s %r limit %r' % (name, c['value'], c['limit']), file=err)
        if not math.isfinite(c['value']):
            c['value'] = None  # JSON has no infinity
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
