"""Share of the staged mask voxels that are bucket padding
(``plan.stats()["mask_pad_waste"]`` through ``stats_callback``), weighted
by each stream window's padded voxels, in %."""
from radbench import readers


def read(run):
    return readers.pad_waste(run, "mask_pad_waste")
