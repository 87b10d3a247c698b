"""Pure-Python NIfTI-1 reader (and minimal writer for tests).

Replaces the reference's nibabel dependency (reference dataset_ucsf.py:82 uses
MONAI ``LoadImaged(reader='nibabelreader')``).  Semantics match
``nibabel.load(...).get_fdata()``:

  * voxel data is column-major (Fortran order: x fastest) with shape
    ``dim[1:1+ndim]``;
  * when ``scl_slope`` is set (non-zero, non-NaN) the affine intensity
    scaling ``data * scl_slope + scl_inter`` is applied (UCSF-PDGM volumes
    store int16 with per-volume slope/inter — verified on the bundled data);
  * ``scl_slope == 0`` means "no scaling" (raw values), per the NIfTI-1 spec.

Both ``.nii`` and ``.nii.gz`` are supported, little- and big-endian headers.
The hot path (gunzip + frombuffer) is all C under the hood (zlib/NumPy).

This is the PyTorch port's own copy of ``cross_attention_vit_tpu/data/nifti.py``
(the pure-Python reader path; the native decoder's binding is
``data/native.py``).
"""

from __future__ import annotations

import gzip
import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_HEADER_SIZE = 348

# NIfTI-1 datatype codes → numpy dtypes (spec section "datatype").
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


@dataclass
class NiftiHeader:
    dim: tuple[int, ...]          # spatial/temporal shape, dim[1:1+ndim]
    datatype: int
    bitpix: int
    pixdim: tuple[float, ...]
    vox_offset: int
    scl_slope: float
    scl_inter: float
    byteorder: str                # '<' or '>'
    magic: bytes

    @property
    def shape(self) -> tuple[int, ...]:
        return self.dim

    @property
    def numpy_dtype(self) -> np.dtype:
        try:
            return np.dtype(_DTYPES[self.datatype]).newbyteorder(self.byteorder)
        except KeyError:
            raise ValueError(f"unsupported NIfTI datatype code {self.datatype}") from None

    @property
    def has_scaling(self) -> bool:
        s = self.scl_slope
        return s != 0.0 and not math.isnan(s) and not (s == 1.0 and self.scl_inter == 0.0)


def _read_bytes(path: str | Path) -> bytes:
    path = Path(path)
    if path.suffix == ".gz" or path.name.endswith(".nii.gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


def parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"file too short for a NIfTI-1 header ({len(raw)} bytes)")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    if sizeof_hdr == 348:
        bo = "<"
    elif struct.unpack(">i", raw[0:4])[0] == 348:
        bo = ">"
    else:
        raise ValueError("not a NIfTI-1 file (sizeof_hdr != 348 in either byte order)")

    dim_raw = struct.unpack(bo + "8h", raw[40:56])
    ndim = dim_raw[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"invalid NIfTI ndim {ndim}")
    datatype, bitpix = struct.unpack(bo + "2h", raw[70:74])
    pixdim = struct.unpack(bo + "8f", raw[76:108])
    vox_offset, scl_slope, scl_inter = struct.unpack(bo + "3f", raw[108:120])
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    return NiftiHeader(
        dim=tuple(int(d) for d in dim_raw[1:1 + ndim]),
        datatype=int(datatype),
        bitpix=int(bitpix),
        pixdim=tuple(float(p) for p in pixdim[1:1 + ndim]),
        vox_offset=int(vox_offset),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        byteorder=bo,
        magic=magic,
    )


def read_header(path: str | Path) -> NiftiHeader:
    """Parse only the header (the first block of a gzip stream)."""
    path = Path(path)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rb") as f:
        return parse_header(f.read(_HEADER_SIZE + 4))


def read_volume(path: str | Path, dtype=np.float32) -> np.ndarray:
    """Load a NIfTI volume with nibabel get_fdata semantics, cast to `dtype`.

    Returns a C-contiguous array of shape ``header.dim`` (x, y, z[, t...]).
    Scaling is computed in float32 (int16 source values are exact in f32;
    relative error vs nibabel's float64 path is ≤1e-7, far inside the 1e-3
    parity budget) and float64 elementwise math is several times slower.
    """
    raw = _read_bytes(path)
    hdr = parse_header(raw)
    count = int(np.prod(hdr.dim))
    data = np.frombuffer(raw, dtype=hdr.numpy_dtype, count=count,
                         offset=hdr.vox_offset)
    data = data.reshape(hdr.dim, order="F")
    return _scale(np.ascontiguousarray(data), hdr, dtype)


def _scale(data: np.ndarray, hdr: NiftiHeader, dtype) -> np.ndarray:
    out = data.astype(np.float32 if hdr.has_scaling else dtype, copy=False)
    if hdr.has_scaling:
        out = out * np.float32(hdr.scl_slope) + np.float32(hdr.scl_inter)
    return out.astype(dtype, copy=False)


def read_volume_cropped(path: str | Path, target: tuple[int, int, int],
                        fill: float = -1.0, dtype=np.float32) -> np.ndarray:
    """Decode + MONAI-style ResizeWithPadOrCrop in one pass, cropping in the
    source dtype BEFORE intensity scaling — the hot ingest path.

    For the live shapes this touches 1/7th of the voxels the naive
    decode-then-crop path does.  Returns (target...) C-contiguous `dtype`.
    """
    from .preprocess import crop_bounds

    raw = _read_bytes(path)
    hdr = parse_header(raw)
    if len(hdr.dim) != 3:
        raise ValueError(f"read_volume_cropped expects 3-D volumes, got {hdr.dim}")
    count = int(np.prod(hdr.dim))
    data = np.frombuffer(raw, dtype=hdr.numpy_dtype, count=count,
                         offset=hdr.vox_offset).reshape(hdr.dim, order="F")

    bounds = crop_bounds(hdr.dim, target)
    slices = tuple(slice(max(s0 - pf, 0), min(s1 - pf, dim))
                   for (pf, _, s0, s1), dim in zip(bounds, hdr.dim))
    core = _scale(np.ascontiguousarray(data[slices]), hdr, dtype)

    if core.shape == tuple(target):
        return core
    out = np.full(target, fill, dtype=dtype)
    # placement offset: where the (possibly padded) source region lands
    place = tuple(
        slice(max(pf - s0, 0), max(pf - s0, 0) + core.shape[i])
        for i, (pf, _, s0, s1) in enumerate(bounds))
    out[place] = core
    return out


def write_volume(path: str | Path, data: np.ndarray,
                 scl_slope: float = 0.0, scl_inter: float = 0.0,
                 pixdim: tuple[float, ...] | None = None) -> None:
    """Minimal single-file (.nii / .nii.gz) NIfTI-1 writer — test fixtures and
    export; stores data as-is (no scaling applied on write)."""
    data = np.asarray(data)
    code = None
    for c, dt in _DTYPES.items():
        if np.dtype(dt) == data.dtype:
            code = c
            break
    if code is None:
        raise ValueError(f"unsupported dtype for NIfTI write: {data.dtype}")

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pd = [1.0] + list(pixdim or (1.0,) * ndim) + [0.0] * (7 - ndim)

    hdr = bytearray(352)  # header + 4-byte extender
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<3f", hdr, 108, 352.0, scl_slope, scl_inter)
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    path = Path(path)
    if path.name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


def volume_path(folder: str | Path, case_id: str, mri_type: str) -> Path:
    """UCSF-PDGM layout: {folder}/{case}_nifti/{case}_{type}.nii.gz
    (reference dataset_ucsf.py:152)."""
    return Path(folder) / f"{case_id}_nifti" / f"{case_id}_{mri_type}.nii.gz"
