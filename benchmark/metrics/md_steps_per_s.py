"""md_steps_per_s: integrator steps of the window over its seconds."""


def read(run):
    if 'steps' not in run.records:
        return None
    return run.records['steps'] / run.window_s
