"""setup_s: seconds from the start of the process to the start of the
window (host clock)."""


def read(run):
    return run.setup_s
