"""caller_us_per_geometry.serve (us): the traced window less the seconds of
the port's ``predict`` spans, over the geometries answered: the client's own
time, which no change to the port shortens. With the three parts of a
request and ``predict``'s self time it splits the window a geometry."""

from benchmark import recorder


def read(run):
    rec = recorder.record('predict')
    return None if rec is None or not run.work else 1e6 * (run.window_s - rec.seconds('predict')) / run.work
