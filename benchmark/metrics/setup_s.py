"""setup_s: seconds from the process's start to the window's: imports, the
inputs made from the seed, the program's set-up (the kernel's build in a
checkout's first run) and the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
