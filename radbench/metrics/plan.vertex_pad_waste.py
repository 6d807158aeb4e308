"""Share of the vertex-list slots that are padding
(``plan.stats()["vertex_pad_waste"]`` through ``stats_callback``), weighted
by each stream window's padded voxels, in %."""
from radbench import readers


def read(run):
    return readers.pad_waste(run, "vertex_pad_waste")
