"""mfu.md (%): 8 T D operations an integrator step of the window, over its
seconds and the H100's 67 TFLOP/s."""

from benchmark import counts


def read(run):
    if 'steps' not in run.records:
        return None
    return 100.0 * counts.k1_flops(run.records['steps'], run.table_rows, run.dim) / (run.window_s * counts.H100_FLOPS)
