"""assembly_s.train: the mean seconds of the 'assembly' phase of
GDMLTrain.train's PhaseTimer (which synchronizes the card at each phase's
end) over the window's trainings."""


def read(run):
    times = [t['times']['assembly'] for t in run.records.get('trainings', ()) if 'assembly' in t['times']]
    return sum(times) / len(times) if times else None
