"""fused_step_share.md (%): the port's ``md.fused_steps`` counter (the steps
that ``MDEngine.run_nve`` took as one fused step kernel each) over the steps
of the traced window's ``md.trajectory`` spans (their ``steps``). None where
no step was fused: a program without the fused step counts none."""

from benchmark import recorder


def read(run):
    rec = recorder.record('md.trajectory')
    fused = 0 if rec is None else rec.counter('md.fused_steps')
    if not fused:
        return None
    return 100.0 * fused / sum(s['attrs'].get('steps', 0) for s in rec.spans('md.trajectory'))
