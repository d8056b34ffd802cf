"""mfu.train (%): the work a training needs over its seconds and the H100's
67 TFLOP/s, over the window's trainings: n^3/3 for a dense factor; for CG
the Nystrom build from the model's inducing columns and, for each of its
iterations, K1 over the training points and the Woodbury apply."""

from benchmark import counts


def read(run):
    flops = seconds = 0.0
    c = run.cell.config
    for t in run.records.get('trainings', ()):
        if 'cg' in t['times']:
            n, k = t['n'], t['n_cols']
            flops += counts.nystrom_build_flops(n, k) + t['iters'] * counts.cg_iteration_flops(
                c['n_train'], 1, run.dim, n, k)
        else:
            flops += counts.cholesky_flops(t['n'])
        seconds += t['seconds']
    return 100.0 * flops / (seconds * counts.H100_FLOPS) if seconds else None
