"""host_reads_per_iter.train (reads): the port's ``host_reads`` counter
(every read of the card that the CG loop waits on: a block's ``active``,
a chunk's head, the PSD guard, the start's residual) over the CG iterations
of the traced window's trainings."""

from benchmark import recorder


def read(run):
    rec = recorder.record('cg.chunk')
    iters = sum(t['iters'] for t in run.records.get('trainings', ()) if 'cg' in t['times'])
    return None if rec is None or not iters else rec.counter('host_reads') / iters
