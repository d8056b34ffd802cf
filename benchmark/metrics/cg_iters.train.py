"""cg_iters.train: the CG iterations of a training (the model's
solver_iters), averaged over the window's CG trainings."""


def read(run):
    iters = [t['iters'] for t in run.records.get('trainings', ()) if 'cg' in t['times']]
    return sum(iters) / len(iters) if iters else None
