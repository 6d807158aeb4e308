"""Share of the traced window in which no kernel, copy or set ran on the
device, in %."""
from radbench import readers


def read(run):
    return readers.idle_share(run)
