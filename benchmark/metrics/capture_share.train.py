"""capture_share.train (%): the seconds of the port's ``graph.capture``
spans (the CG chunk graphs' first, eager blocks and their captures) in the
traced window, over the window."""

from benchmark import recorder


def read(run):
    rec = recorder.record('train')
    return None if rec is None else 100.0 * rec.seconds('graph.capture') / run.window_s
