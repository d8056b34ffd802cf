"""cg_iters_per_s.train: the CG iterations of the window's trainings over
the seconds of their 'cg' phases (PhaseTimer)."""


def read(run):
    cg = [t for t in run.records.get('trainings', ()) if 'cg' in t['times']]
    seconds = sum(t['times']['cg'] for t in cg)
    return sum(t['iters'] for t in cg) / seconds if seconds else None
