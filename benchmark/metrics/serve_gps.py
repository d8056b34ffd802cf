"""serve_gps: geometries answered in the window, host to host, over its
seconds."""


def read(run):
    if 'requests' not in run.records:
        return None
    return sum(b for b, _ in run.records['requests']) / run.window_s
