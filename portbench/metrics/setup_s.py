"""Process start to the window's start: imports, the kernel libraries,
weights, warm-up and the check steps."""


def read(run):
    return run.setup_s
