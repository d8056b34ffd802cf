"""idle_us_per_geometry.serve (us): the seconds of the traced window in which
the card was idle, over the geometries answered in it: the host path's time
a geometry that the card does not hide (conversions, copies to and from
numpy, launches)."""


def read(run):
    if run.trace is None or not run.trace.busy_s or 'requests' not in run.records:
        return None
    return 1e6 * (run.trace.window_s - run.trace.busy_s) / run.work
