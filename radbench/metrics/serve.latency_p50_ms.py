"""Median, in ms, of the service's requests over the window, each from its
submit (a closed loop; an open loop: its due time) to the moment its client
holds the rows (host clock)."""
from radbench import readers


def read(run):
    return readers.latency_ms(run, 0.50)
