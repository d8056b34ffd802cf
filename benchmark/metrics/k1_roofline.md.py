"""k1_roofline.md (%): K1's least time at B=1, times its calls in the traced
window (the port's own count, ``fused_predict.LAUNCHES``, which counts each
graph replay's launches), over the device time of K1's kernels."""

from benchmark import counts
from benchmark.metrics_k1 import K1_KERNELS


def read(run):
    if run.trace is None or 'steps' not in run.records:
        return None
    seconds = run.trace.kernel_seconds(K1_KERNELS)
    if not seconds or not run.records['k1_calls']:
        return None
    return 100.0 * run.records['k1_calls'] * counts.k1_bound_s(1, run.table_rows, run.dim) / seconds
