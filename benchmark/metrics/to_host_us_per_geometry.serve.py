"""to_host_us_per_geometry.serve (us): the seconds of the port's
``predict.to_host`` spans in the traced window (the copies to numpy, which
first wait for the replay) over the geometries answered."""

from benchmark import recorder


def read(run):
    rec = recorder.record('predict')
    return None if rec is None or not run.work else 1e6 * rec.seconds('predict.to_host') / run.work
