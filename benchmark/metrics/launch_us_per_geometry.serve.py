"""launch_us_per_geometry.serve (us): the seconds of the port's
``predict.launch`` spans in the traced window (the copy in, the bucket's
graph replay and the copies of its results) over the geometries answered."""

from benchmark import recorder


def read(run):
    rec = recorder.record('predict')
    return None if rec is None or not run.work else 1e6 * rec.seconds('predict.launch') / run.work
