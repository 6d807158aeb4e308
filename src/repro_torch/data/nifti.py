"""Minimal NIfTI-1 reader (pure numpy + stdlib gzip).

The port's own copy of ``repro.data.nifti``, so ``repro_torch`` reads
and writes real NIfTI files without importing the JAX package.

Supports the subset PyRadiomics workflows need: single-file ``.nii`` /
``.nii.gz``, scalar volumes, little-endian, dtypes {uint8, int16, int32,
float32, float64}, pixdim spacing, ``scl_slope``/``scl_inter`` intensity
rescaling, and >3D files whose trailing dims are all size 1 (a common
export quirk: 4D with one timepoint).  Enough to ingest real CT volumes
and segmentation masks.  Big-endian files are detected and rejected with a
clear error rather than misread.

* :func:`read_nifti_header` -- 352-byte peek (shape, dtype, spacing,
  rescale, offset) without touching the data section.
* :func:`read_nifti_slab` -- a z-window ``[z0, z1)`` of an uncompressed
  ``.nii`` without loading the volume (NIfTI is Fortran order, so a
  z-slab is one contiguous byte range): the tiled path's reader.
* :func:`read_nifti` -- the full volume, read as one z-slab over the whole
  z-range (gz files are decompressed to an in-memory stream first).
* :func:`write_nifti` -- a volume to ``.nii`` or ``.nii.gz``, byte for
  byte the reference's writer.
"""
from __future__ import annotations

import gzip
import io
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_BYTES = 352  # 348-byte header + 4-byte extension flag


class NiftiHeader(NamedTuple):
    """Parsed NIfTI-1 header: everything needed to plan a read.

    ``shape`` has degenerate trailing dims already squeezed (so it is at
    most 3-long); ``vox_offset`` is the byte offset of the data section;
    ``gzipped`` records how the bytes on disk are stored.
    """

    shape: tuple
    dtype: np.dtype
    spacing: np.ndarray
    vox_offset: int
    scl_slope: float
    scl_inter: float
    gzipped: bool

    @property
    def shape3(self) -> tuple:
        """``shape`` padded with trailing 1s to exactly 3 dims."""
        return tuple(self.shape) + (1,) * (3 - len(self.shape))

    @property
    def data_bytes(self) -> int:
        """Size of the stored data section (pre-rescale dtype)."""
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


def _parse_header(raw: bytes, gzipped: bool) -> NiftiHeader:
    if len(raw) < _HDR_BYTES:
        raise ValueError("not a NIfTI-1 file (too short)")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        # a byte-swapped sizeof_hdr is the standard's endianness probe:
        # tell the user what the file IS, not just that the header looks bad
        if struct.unpack_from(">i", raw, 0)[0] == 348:
            raise ValueError(
                "big-endian NIfTI byte order unsupported (this reader is "
                "little-endian only); convert the file first"
            )
        raise ValueError(f"unsupported NIfTI header size {sizeof_hdr}")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad NIfTI dim[0]={ndim}, got dim={dim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    # tolerate degenerate >3D exports (e.g. a 4D file with one timepoint):
    # squeeze trailing size-1 dims, reject anything still >3D after that
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    if len(shape) > 3:
        raise ValueError(f"only 1-3D volumes supported, got dim={dim}")
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported datatype code {datatype}")
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    spacing = np.asarray(pixdim[1:4], np.float32)
    spacing[spacing == 0] = 1.0
    return NiftiHeader(
        shape=shape,
        dtype=np.dtype(_DTYPES[datatype]).newbyteorder("<"),
        spacing=spacing,
        vox_offset=vox_offset or _HDR_BYTES,
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        gzipped=gzipped,
    )


def _is_gzipped(path: Path) -> bool:
    if path.suffix == ".gz":
        return True
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def read_nifti_header(path) -> NiftiHeader:
    """Peek the 352-byte header without reading the data section.

    For ``.nii.gz`` this streams just enough of the DEFLATE stream to
    decompress the header -- still O(1) in the volume size.
    """
    path = Path(path)
    gzipped = _is_gzipped(path)
    opener = gzip.open if gzipped else open
    with opener(path, "rb") as f:
        raw = f.read(_HDR_BYTES)
    return _parse_header(raw, gzipped)


def _apply_scl(data: np.ndarray, hdr: NiftiHeader) -> np.ndarray:
    """Header intensity rescale (``slope * stored + inter``, float32).

    Applied whenever it is a real rescale -- slope outside {0, 1} or a
    nonzero intercept; a slope of 0 means "unset" per the standard and
    is treated as 1.
    """
    scl_slope, scl_inter = hdr.scl_slope, hdr.scl_inter
    if (
        (scl_slope not in (0.0, 1.0) or scl_inter != 0.0)
        and np.isfinite(scl_slope)
        and np.isfinite(scl_inter)
    ):
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = (np.float32(slope) * data.astype(np.float32)
                + np.float32(scl_inter))
    return data


def _slab_from_stream(f, hdr: NiftiHeader, z0: int, z1: int) -> np.ndarray:
    """Read planes ``[z0, z1)`` from a seekable byte stream.

    NIfTI data is Fortran order: flat offset of voxel ``(x, y, z)`` is
    ``x + y*X + z*X*Y``, so a z-slab is a single contiguous byte range.
    Returns an ``(X, Y, z1-z0)`` C-contiguous array (stored dtype,
    rescale not yet applied).
    """
    nx, ny, nz = hdr.shape3
    if not 0 <= z0 <= z1 <= nz:
        raise ValueError(f"slab [{z0}, {z1}) out of range for nz={nz}")
    plane = nx * ny * hdr.dtype.itemsize
    f.seek(hdr.vox_offset + z0 * plane)
    want = (z1 - z0) * plane
    buf = f.read(want)
    if len(buf) < want:
        raise ValueError(
            f"truncated NIfTI data section: wanted {want} bytes for planes "
            f"[{z0}, {z1}), got {len(buf)}"
        )
    data = np.frombuffer(buf, hdr.dtype, count=nx * ny * (z1 - z0))
    return np.ascontiguousarray(data.reshape((nx, ny, z1 - z0), order="F"))


def read_nifti_slab(path, z0: int, z1: int):
    """Windowed read of z-planes ``[z0, z1)`` without loading the volume.

    Returns ``(slab (X, Y, z1-z0) ndarray, spacing (3,) float32)`` with
    the header's intensity rescale applied (same rule as
    :func:`read_nifti`).  Only uncompressed ``.nii`` can be windowed: a
    ``.nii.gz`` DEFLATE stream has no random access, so it is refused
    with the workaround spelled out rather than silently buffering the
    whole file.
    """
    path = Path(path)
    hdr = read_nifti_header(path)
    if hdr.gzipped:
        raise ValueError(
            f"cannot read a slab from compressed NIfTI {path.name}: gzip "
            "streams do not support seeking; decompress it first (e.g. "
            "`gunzip` to a .nii file, or load fully via read_nifti)"
        )
    with open(path, "rb") as f:
        slab = _slab_from_stream(f, hdr, z0, z1)
    return _apply_scl(slab, hdr), hdr.spacing


def read_nifti(path):
    """Returns (data (x,y,z) ndarray, spacing (3,) float32).

    Applies the header's ``scl_slope``/``scl_inter`` intensity rescale
    (``slope * stored + inter``, as float32) whenever it is a real
    rescale -- slope outside {0, 1} or a nonzero intercept; a slope of 0
    means "unset" per the standard and is treated as 1.  Files with more
    than 3 dims are accepted when every trailing dim is 1 (squeezed
    away); genuinely >3D data still raises.

    Implemented as a whole-z-range :func:`_slab_from_stream` read;
    ``.nii.gz`` is decompressed to an in-memory stream first.
    """
    path = Path(path)
    if _is_gzipped(path):
        raw = gzip.decompress(path.read_bytes())
        hdr = _parse_header(raw[:_HDR_BYTES], gzipped=True)
        stream = io.BytesIO(raw)
    else:
        hdr = read_nifti_header(path)
        stream = open(path, "rb")
    try:
        data = _slab_from_stream(stream, hdr, 0, hdr.shape3[2])
    finally:
        stream.close()
    data = data.reshape(hdr.shape)
    return _apply_scl(data, hdr), hdr.spacing


def write_nifti(path, data: np.ndarray, spacing=(1.0, 1.0, 1.0),
                scl_slope: float = 0.0, scl_inter: float = 0.0):
    """Writes ``data`` (up to 7 dims, Fortran order on disk) as a NIfTI-1
    single file: ``.nii``, or gzip-compressed where ``path`` ends in
    ``.gz``.  A dtype outside {uint8, int16, int32, float32, float64} is
    stored as float32; ``spacing`` fills pixdim[1:4], ``scl_slope`` and
    ``scl_inter`` the header's rescale (0 leaves it unset).  Returns the
    path."""
    path = Path(path)
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    hdr = bytearray(_HDR_BYTES)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    pix = [0.0] + list(np.asarray(spacing, np.float32)) + [0.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, float(_HDR_BYTES))
    struct.pack_into("<2f", hdr, 112, scl_slope, scl_inter)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    if str(path).endswith(".gz"):
        path.write_bytes(gzip.compress(payload, compresslevel=1))
    else:
        path.write_bytes(payload)
    return path
