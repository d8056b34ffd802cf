"""factor_roofline.train (%): the dense factor's least time on an H100 (n^3/3
operations at the peak, or the lower triangle read and written once at the
bandwidth) over the seconds of the training's 'factor' phase, averaged over
the window's trainings."""

from benchmark import counts


def read(run):
    shares = []
    for t in run.records.get('trainings', ()):
        if 'factor' in t['times'] and 'cg' not in t['times']:
            n = t['n']
            shares.append(counts.dense_bound_s(counts.cholesky_flops(n), 8.0 * n * n) / t['times']['factor'])
    return 100.0 * sum(shares) / len(shares) if shares else None
