"""Seconds from the process's start to its first timed case: the pool, the
program's construction, its kernel builds and autotune sweeps where the
checkout has none yet, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
