"""unfused_step_share.md (%): the port's ``md.unfused_steps`` counter (the NVE
steps that ``MDEngine.run_nve`` took as the step's operations one by one
around K1, not as one fused step kernel) over the steps of the traced
window's ``md.trajectory`` spans (their ``steps``). 0 where the steps ran
fused (``md.fused_steps``); None where the window holds no
``md.trajectory`` span, or no step counted by either counter: a program
that does not count its steps by route."""

from benchmark import recorder


def read(run):
    rec = recorder.record('md.trajectory')
    if rec is None:
        return None
    unfused = rec.counter('md.unfused_steps')
    if not unfused + rec.counter('md.fused_steps'):
        return None
    return 100.0 * unfused / sum(s['attrs'].get('steps', 0) for s in rec.spans('md.trajectory'))
