"""device_us_per_geometry.serve (us): the seconds in which the card was busy
in the traced window (the union of its kernels, copies and fills) over the
geometries answered in it. Host noise moves it little; the device's own
work per geometry (K1, padding, the descriptors) moves it."""


def read(run):
    if run.trace is None or not run.trace.busy_s or 'requests' not in run.records:
        return None
    return 1e6 * run.trace.busy_s / run.work
