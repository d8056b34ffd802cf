"""The port's own record of a traced run (``sgdml_tpu_torch/utils/profiling.py``:
spans and counters, recorded while the benchmark's profiler is on), as the
metrics of program spans and counters read it."""

from __future__ import annotations

from sgdml_tpu_torch.utils import profiling


def record(root: str):
    """The recorder, where it holds spans named ``root``; None where it
    recorded none, or where the program has no recorder."""
    if not hasattr(profiling, 'calls') or not profiling.calls(root):
        return None
    return profiling
