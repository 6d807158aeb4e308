"""The compact kernel's share of its roofline, in % (``readers.roofline_share``)."""
from radbench import readers


def read(run):
    return readers.roofline_share(run, "compact")
