"""Readings that the limits of ``correct`` are set from, at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5

For each seed it runs the cell's set-up and a short window of the program
(the sound reading), then judges by the same plain reference

* the control: the reference itself in the program's place, computed in
  float32, the precision below the configuration's float64 (TF32 off);
* the faults the cell can have, planted in what the program produced: an
  answer altered where it is produced, half of a batch left out with the
  mean of the rest in its place, a step or a solve that returns its state
  unchanged.

Each driver (``kinds/<kind>.py``) plants the faults its cell can have and
runs the control in its ``control``. Each seed prints one JSON line of
``{reading: {number: value}}``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys
import timeit

if __package__ in (None, ''):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import generator, harness  # noqa: E402

__all__ = ['readings']


def readings(cell, seed, seconds, device='cuda'):
    """``{reading: {number: value}}`` of one seed (see the module's doc)."""
    gen = generator.make(cell.config, copy.deepcopy(cell.traffic), seed, device, cell.root)
    gen.setup()
    t0 = timeit.default_timer()
    while True:
        gen.unit()
        if timeit.default_timer() - t0 >= seconds:
            break
    gen.free()
    return gen.control()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True, help='comma-separated')
    ap.add_argument('--seconds', type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in map(int, args.seeds.split(',')):
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'readings': readings(cell, seed, args.seconds)}), flush=True)


if __name__ == '__main__':
    main()
