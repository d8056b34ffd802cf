"""captures_per_chunk.md (captures): the port's ``graph.captures`` counter
over the chunks (``run_nve`` calls) of the traced window."""

from benchmark import recorder


def read(run):
    rec = recorder.record('md.trajectory')
    return None if rec is None else rec.counter('graph.captures') / run.units
