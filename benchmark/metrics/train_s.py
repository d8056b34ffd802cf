"""train_s: the window's seconds over the trainings it completed. The window
closes at the end of the first training that ends after --seconds."""


def read(run):
    if 'trainings' not in run.records:
        return None
    return run.window_s / run.units
