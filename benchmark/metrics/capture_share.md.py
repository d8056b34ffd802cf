"""capture_share.md (%): the seconds of the port's ``graph.capture`` spans
(a graph's first, eager call and its capture) in the traced window, over the
window: what each ``run_nve`` call pays to capture its block anew."""

from benchmark import recorder


def read(run):
    rec = recorder.record('md.trajectory')
    return None if rec is None else 100.0 * rec.seconds('graph.capture') / run.window_s
