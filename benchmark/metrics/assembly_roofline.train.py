"""assembly_roofline.train (%): the permutation-summed assembly's least time
on an H100 (``counts_sym.assembly_bound_s``: M (M + 1) / 2 P Hessian
blocks at the peak, or K's lower triangle written once at the bandwidth;
M and N from the configuration, P from each training's record, 1 where it
has none) over the mean seconds of the 'assembly' phase of the set-up's
untraced dense and in-place trainings (the driver's ``warmups``), the
first of them left out as the process's first use of every kernel.

Not the traced window's phases: under the profiler the assembly's many
short launches stretch them 50-70%, which would make this share read the
profiler's cost. None where the driver keeps no such trainings."""

from benchmark import counts_sym


def read(run):
    c = run.cell.config
    bounds, seconds = [], []
    for t in run.records.get('warmups', ())[1:]:
        if 'assembly' in t['times'] and 'cg' not in t['times']:
            bounds.append(counts_sym.assembly_bound_s(c['n_train'], c['n_atoms'], t.get('n_perms', 1)))
            seconds.append(t['times']['assembly'])
    return 100.0 * sum(bounds) / sum(seconds) if seconds else None
