"""perm_blocks_per_training.train (blocks): the port's
``assembly.perm_blocks`` counter (the (row geometry, column geometry,
permutation) Hessian blocks its kernel assemblies computed) over the
trainings (``train`` spans) of the traced window. None where the program
counts no such blocks."""

from benchmark import recorder


def read(run):
    rec = recorder.record('train')
    if rec is None or not rec.counter('assembly.perm_blocks'):
        return None
    return rec.counter('assembly.perm_blocks') / rec.calls('train')
