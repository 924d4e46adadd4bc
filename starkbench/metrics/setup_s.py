"""setup_s: seconds from the process's start to the window's: the build
check, the client's start, its inputs and its warm-up calls."""


def read(run):
    return run.setup_s
