"""stage_us_per_geometry.serve (us): the seconds of the port's
``predict.stage`` spans in the traced window (the padding, the wait on the
pinned buffer and the host copy into it) over the geometries answered."""

from benchmark import recorder


def read(run):
    rec = recorder.record('predict')
    return None if rec is None or not run.work else 1e6 * rec.seconds('predict.stage') / run.work
