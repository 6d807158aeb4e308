"""Kernel, copy and set launches on the device in the traced window, per
case completed there."""


def read(run):
    if run.trace is None or not run.cases:
        return None
    return run.trace.launches / run.cases
