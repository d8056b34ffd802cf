"""k1_wide_share.md (%): the port's ``k1.wide_launches`` counter (K1's launches
by the wide route, which spreads one to four geometries past split T's
width over thread-block clusters) over its ``k1.launches`` counter (every
K1 launch, graph replays included), within the traced window's
``md.trajectory`` record. None where no K1 launch was counted: a program
without the counters counts none."""

from benchmark import recorder


def read(run):
    rec = recorder.record('md.trajectory')
    launches = 0 if rec is None else rec.counter('k1.launches')
    if not launches:
        return None
    return 100.0 * rec.counter('k1.wide_launches') / launches
