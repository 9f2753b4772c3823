"""Process start to the first timed point: imports, the kernel library's
build or load, and the warm-up point (host clock)."""


def read(run):
    return run.setup_s
