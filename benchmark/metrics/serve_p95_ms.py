"""serve_p95_ms: the 95th percentile of every request's host-to-host
latency in the window (numpy's linear interpolation)."""

import numpy as np


def read(run):
    if 'requests' not in run.records:
        return None
    return float(np.percentile([s for _, s in run.records['requests']], 95)) * 1e3
