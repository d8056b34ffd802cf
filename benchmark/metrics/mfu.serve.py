"""mfu.serve (%): 8 T D operations a geometry answered in the window, over
its seconds and the H100's 67 TFLOP/s."""

from benchmark import counts


def read(run):
    if 'requests' not in run.records:
        return None
    flops = counts.k1_flops(sum(b for b, _ in run.records['requests']), run.table_rows, run.dim)
    return 100.0 * flops / (run.window_s * counts.H100_FLOPS)
