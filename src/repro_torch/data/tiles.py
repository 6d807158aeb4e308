"""Out-of-core tile streaming: slab sources and the ``TiledCase`` unit.

The port's own copy of ``repro.data.tiles`` (numpy only).  A
:class:`TiledCase` is what the tiled extraction engine
(``core/tiled.py``) consumes instead of a materialised ``(image, mask,
spacing)`` tuple: a pair of *slab sources* that can serve any z-window
``[z0, z1)`` of the volume on demand, without the whole volume ever
existing in memory.  NIfTI stores Fortran order (x fastest), so a
z-slab is one contiguous byte range on disk -- the natural streaming
unit (see ``data/nifti.py::read_nifti_slab``).

Three source flavours cover the loader spectrum:

* :class:`NiftiSlabSource` -- an uncompressed ``.nii`` on disk, windowed
  via header peek + seek; the genuinely out-of-core path.
* :class:`ArraySlabSource` -- an in-memory ndarray; the volume exists on
  the host but is staged to the card one tile at a time (the device
  budget is what the tile layer guards).
* :class:`FnSlabSource` -- an analytic/synthetic generator
  ``fn(z0, z1) -> (X, Y, z1-z0)``; lets a 1024^3 case exist nowhere at
  all.

Halo contract: the engine asks each source for frame-aligned slabs plus
one extra plane (halo width 1), so marching-cubes cells and vertex edges
on a tile face are computed from the same neighbour values as the
in-core path and counted by exactly one owning tile.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.data.nifti import read_nifti_header, read_nifti_slab

__all__ = [
    "ArraySlabSource",
    "FnSlabSource",
    "NiftiSlabSource",
    "TiledCase",
    "as_slab_source",
]


class ArraySlabSource:
    """Slab views over an in-memory 3D array (no copy until sliced)."""

    def __init__(self, array, spacing=None):
        array = np.asarray(array)
        if array.ndim != 3:
            raise ValueError(f"slab source needs a 3D array, got {array.shape}")
        self._array = array
        self.shape = tuple(int(s) for s in array.shape)
        self.spacing = None if spacing is None else np.asarray(spacing, np.float32)

    def read(self, z0: int, z1: int) -> np.ndarray:
        return self._array[:, :, z0:z1]


class NiftiSlabSource:
    """Windowed reads from an uncompressed ``.nii`` file.

    The constructor only peeks the 352-byte header (shape, dtype,
    spacing); data planes are read per ``read`` call.  A compressed
    ``.nii.gz`` is refused up front with the ``read_nifti_slab``
    workaround message -- better at construction than on the first
    mid-stream slab.
    """

    def __init__(self, path):
        self.path = Path(path)
        hdr = read_nifti_header(self.path)
        if hdr.gzipped:
            # surface the seek restriction immediately, with the workaround
            read_nifti_slab(self.path, 0, 0)
        if len(hdr.shape) != 3:
            raise ValueError(
                f"tiled extraction needs a 3D volume, {self.path.name} has "
                f"shape {hdr.shape}"
            )
        self.header = hdr
        self.shape = tuple(int(s) for s in hdr.shape)
        self.spacing = np.asarray(hdr.spacing, np.float32)

    def read(self, z0: int, z1: int) -> np.ndarray:
        slab, _ = read_nifti_slab(self.path, z0, z1)
        return slab


class FnSlabSource:
    """Analytic slab generator: ``fn(z0, z1) -> (X, Y, z1-z0)`` ndarray.

    The volume never exists anywhere -- each window is synthesised on
    demand.
    """

    def __init__(self, fn, shape, spacing=None):
        self._fn = fn
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != 3:
            raise ValueError(f"slab source needs a 3D shape, got {shape}")
        self.spacing = None if spacing is None else np.asarray(spacing, np.float32)

    def read(self, z0: int, z1: int) -> np.ndarray:
        slab = np.asarray(self._fn(z0, z1))
        want = (self.shape[0], self.shape[1], z1 - z0)
        if slab.shape != want:
            raise ValueError(
                f"slab fn returned shape {slab.shape} for planes "
                f"[{z0}, {z1}), expected {want}"
            )
        return slab


def as_slab_source(obj, spacing=None):
    """Coerce an ndarray / path / existing source into a slab source."""
    if hasattr(obj, "read") and hasattr(obj, "shape"):
        return obj
    if isinstance(obj, (str, Path)):
        return NiftiSlabSource(obj)
    return ArraySlabSource(obj, spacing)


class TiledCase:
    """One extraction case served as z-slabs instead of whole volumes.

    ``mask`` is required; ``image`` only when an intensity family
    (first-order) is requested.  ``spacing`` resolution order: explicit
    argument > mask source's own spacing (NIfTI header) > unit spacing.
    ``BatchedExtractor`` routes any ``TiledCase`` through the tiled
    engine unconditionally -- constructing one is the opt-in.
    """

    def __init__(self, mask, image=None, spacing=None, name=None):
        self.mask_source = as_slab_source(mask, spacing)
        self.image_source = None if image is None else as_slab_source(image, spacing)
        if (self.image_source is not None
                and tuple(self.image_source.shape) != tuple(self.mask_source.shape)):
            raise ValueError(
                f"image shape {tuple(self.image_source.shape)} != mask shape "
                f"{tuple(self.mask_source.shape)}"
            )
        if spacing is None:
            spacing = getattr(self.mask_source, "spacing", None)
        self.spacing = np.asarray(
            (1.0, 1.0, 1.0) if spacing is None else spacing, np.float32
        )
        self.name = name

    @property
    def shape(self) -> tuple:
        return tuple(self.mask_source.shape)

    def mask_slab(self, z0: int, z1: int) -> np.ndarray:
        return self.mask_source.read(z0, z1)

    def image_slab(self, z0: int, z1: int) -> np.ndarray:
        if self.image_source is None:
            raise ValueError(
                "this TiledCase has no image source (intensity families "
                "need one)"
            )
        return self.image_source.read(z0, z1)

    def materialize(self):
        """Whole volumes, for parity tests on sizes the in-core path can
        run.  Defeats the point on genuinely large cases -- test use only."""
        nz = self.shape[2]
        mask = np.ascontiguousarray(self.mask_slab(0, nz))
        image = None
        if self.image_source is not None:
            image = np.ascontiguousarray(self.image_slab(0, nz))
        return image, mask, self.spacing
