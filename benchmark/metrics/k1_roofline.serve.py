"""k1_roofline.serve (%): K1's least time for the geometries actually
requested in the traced window (chunks of at most the batch size, not the
padded buckets) over the device time of K1's kernels in the trace."""

from benchmark import counts
from benchmark.metrics_k1 import K1_KERNELS


def read(run):
    if run.trace is None or 'requests' not in run.records:
        return None
    seconds = run.trace.kernel_seconds(K1_KERNELS)
    if not seconds:
        return None
    bs, T, D = run.cell.traffic['batch_size'], run.table_rows, run.dim
    bound = sum(counts.request_bound_s(b, bs, T, D) for b, _ in run.records['requests'])
    return 100.0 * bound / seconds
