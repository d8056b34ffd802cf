"""assembly_kernel_share.train (%): the port's ``assembly.kernel_blocks``
counter (the (row geometry, column geometry, permutation) Hessian blocks
that the hand-written permutation-summed Hessian kernel computed) over its
``assembly.perm_blocks`` counter (the blocks of the kernel assemblies'
force blocks), within the traced window's trainings (``train`` spans).
None where the program counts no kernel blocks: a program without the
kernel counts none."""

from benchmark import recorder


def read(run):
    rec = recorder.record('train')
    kernel = 0 if rec is None else rec.counter('assembly.kernel_blocks')
    if not kernel or not rec.counter('assembly.perm_blocks'):
        return None
    return 100.0 * kernel / rec.counter('assembly.perm_blocks')
