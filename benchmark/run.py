"""Run one cell of the benchmark of ``sgdml_tpu_torch`` on the card(s):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m benchmark.run`` alike). Prints the
numbers that decide ``correct`` as the last lines of standard error and the
result as one JSON object on the last line of standard output. Exits with 2,
printing no result, where PyTorch sees fewer CUDA cards than the cell
needs, and with 3 where the run loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import timeit

T_START = timeit.default_timer()
CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds. K1's nvcc build already goes
    to ``build/kernels/`` there."""
    build = CHECKOUT / 'build'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = str(build / 'cuda_cache')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='benchmark/run.py', description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print('refused: %s needs %d CUDA card(s); PyTorch sees %d' % (
            args.workload, cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    result, foreign = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda', T_START)
    return harness.emit(result, foreign)


if __name__ == '__main__':
    sys.exit(main())
