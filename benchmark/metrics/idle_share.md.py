"""idle_share.md (%): the share of the traced window in which no kernel,
copy or fill ran on the card (torch.profiler's timeline)."""


def read(run):
    return run.trace.idle_share() if run.trace else None
