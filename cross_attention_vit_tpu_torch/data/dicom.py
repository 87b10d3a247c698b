"""Minimal pure-Python DICOM reader (+ writer for test fixtures).

Supplies the legacy RSNA-BraTS ingest capability (reference dataset.py uses
pydicom + apply_voi_lut; neither pydicom nor that dataset ship here).  Scope:
single-frame grayscale MR images in Implicit or Explicit VR Little Endian
with native (uncompressed) pixel data — what the RSNA-MICCAI brain-tumor
DICOMs actually are.

Implements:
  * part-10 parsing (preamble + 'DICM' + explicit-VR meta group, transfer
    syntax negotiation);
  * the handful of data elements the pipeline needs (Rows, Columns,
    BitsAllocated/Stored, PixelRepresentation, RescaleSlope/Intercept,
    WindowCenter/Width, PixelData);
  * `pixel_array` with Rescale applied, and `apply_voi_lut` — the DICOM
    PS3.3 C.11.2.1.2.1 LINEAR windowing function, matching pydicom's.

This is the PyTorch port's own copy of ``cross_attention_vit_tpu/data/dicom.py``
(numpy only), so the port never imports the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"

# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}

_TAGS = {
    (0x0002, 0x0010): "transfer_syntax",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0101): "bits_stored",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1050): "window_center",
    (0x0028, 0x1051): "window_width",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x0020, 0x0013): "instance_number",
    (0x7FE0, 0x0010): "pixel_data",
}


@dataclass
class DicomImage:
    rows: int = 0
    cols: int = 0
    bits_allocated: int = 16
    bits_stored: int = 16
    pixel_representation: int = 0     # 0 unsigned, 1 signed
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    window_center: float | None = None
    window_width: float | None = None
    instance_number: int | None = None
    pixel_bytes: bytes = b""
    extra: dict = field(default_factory=dict)

    @property
    def pixel_array(self) -> np.ndarray:
        if self.bits_allocated == 16:
            dt = np.int16 if self.pixel_representation else np.uint16
        elif self.bits_allocated == 8:
            dt = np.int8 if self.pixel_representation else np.uint8
        else:
            raise ValueError(f"unsupported BitsAllocated {self.bits_allocated}")
        arr = np.frombuffer(self.pixel_bytes, dtype=np.dtype(dt).newbyteorder("<"),
                            count=self.rows * self.cols)
        return arr.reshape(self.rows, self.cols)


def _parse_elements(buf: bytes, pos: int, explicit: bool, stop_group=None):
    out = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_group is not None and group != stop_group:
            break
        pos += 4
        if explicit:
            vr = buf[pos:pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            raise ValueError("undefined-length elements (encapsulated pixel "
                             "data?) are not supported — native LE only")
        value = buf[pos:pos + length]
        pos += length
        out[(group, elem)] = (vr, value)
    return out, pos


def _decode_value(vr: bytes, raw: bytes):
    if vr in (b"US",):
        return struct.unpack("<H", raw[:2])[0]
    if vr in (b"UL",):
        return struct.unpack("<I", raw[:4])[0]
    if vr in (b"DS", b"IS", b"LO", b"SH", b"UI", b"CS", b"PN", b"DA", b"TM"):
        return raw.decode("ascii", "ignore").strip("\x00 ").strip()
    return raw


def read_dicom(path: str | Path) -> DicomImage:
    buf = Path(path).read_bytes()
    if buf[128:132] != b"DICM":
        raise ValueError(f"{path}: missing DICM magic (not part-10?)")
    # file meta group (0002,*) is always explicit VR LE
    meta, pos = _parse_elements(buf, 132, explicit=True, stop_group=0x0002)
    ts = EXPLICIT_VR_LE
    if (0x0002, 0x0010) in meta:
        ts = _decode_value(b"UI", meta[(0x0002, 0x0010)][1])
    if ts not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE):
        raise ValueError(f"unsupported transfer syntax {ts!r} "
                         "(compressed pixel data not handled)")
    elements, _ = _parse_elements(buf, pos, explicit=(ts == EXPLICIT_VR_LE))

    img = DicomImage()
    for tag, (vr, raw) in elements.items():
        name = _TAGS.get(tag)
        if name is None:
            continue
        if name == "pixel_data":
            img.pixel_bytes = raw
        elif name in ("rows", "cols", "bits_allocated", "bits_stored",
                      "pixel_representation"):
            v = (struct.unpack("<H", raw[:2])[0] if vr in (b"US", b"UN")
                 else int(_decode_value(vr, raw)))
            setattr(img, name, v)
        elif name in ("rescale_slope", "rescale_intercept", "window_center",
                      "window_width"):
            txt = raw.decode("ascii", "ignore").strip("\x00 ")
            if txt:
                setattr(img, name, float(txt.split("\\")[0]))
        elif name == "instance_number":
            txt = raw.decode("ascii", "ignore").strip("\x00 ")
            if txt:
                img.instance_number = int(txt)
    if not img.rows or not img.cols:
        raise ValueError(f"{path}: missing Rows/Columns")
    return img


def apply_voi_lut(arr: np.ndarray, img: DicomImage) -> np.ndarray:
    """DICOM PS3.3 C.11.2.1.2.1 LINEAR windowing (pydicom apply_voi_lut for
    images with WindowCenter/Width and no VOI LUT sequence).  Output spans
    the input dtype's representable range like pydicom's implementation."""
    if img.window_center is None or img.window_width is None:
        return arr
    c, w = float(img.window_center), float(img.window_width)
    arr_f = arr.astype(np.float64)
    # output range spans BitsStored (pydicom apply_voi_lut uses BitsStored,
    # not BitsAllocated, to size the representable range)
    if img.pixel_representation:
        y_min, y_max = (-(2 ** (img.bits_stored - 1)),
                        2 ** (img.bits_stored - 1) - 1)
    else:
        y_min, y_max = 0, 2 ** img.bits_stored - 1
    below = arr_f <= c - 0.5 - (w - 1) / 2
    above = arr_f > c - 0.5 + (w - 1) / 2
    out = ((arr_f - (c - 0.5)) / (w - 1) + 0.5) * (y_max - y_min) + y_min
    out = np.where(below, y_min, np.where(above, y_max, out))
    return out


def write_dicom(path: str | Path, pixels: np.ndarray,
                window_center: float | None = None,
                window_width: float | None = None,
                instance_number: int | None = None) -> None:
    """Minimal Explicit-VR-LE part-10 writer for test fixtures."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype not in (np.dtype(np.uint16), np.dtype(np.int16)):
        raise ValueError("write_dicom supports int16/uint16 pixels")
    signed = pixels.dtype == np.dtype(np.int16)

    def elem(group, el, vr, value: bytes) -> bytes:
        head = struct.pack("<HH", group, el)
        if vr in _LONG_VRS:
            if len(value) % 2:
                value += b"\x00"
            return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
        if len(value) % 2:
            value += b" " if vr in (b"DS", b"IS", b"UI", b"CS") else b"\x00"
        return head + vr + struct.pack("<H", len(value)) + value

    meta = elem(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode())
    body = b""
    if instance_number is not None:
        body += elem(0x0020, 0x0013, b"IS", str(instance_number).encode())
    body += elem(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0]))
    body += elem(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1]))
    body += elem(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += elem(0x0028, 0x0101, b"US", struct.pack("<H", 16))
    body += elem(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0))
    if window_center is not None:
        body += elem(0x0028, 0x1050, b"DS", repr(float(window_center)).encode())
        body += elem(0x0028, 0x1051, b"DS", repr(float(window_width)).encode())
    body += elem(0x7FE0, 0x0010, b"OW", pixels.astype("<" + ("i2" if signed else "u2")).tobytes())
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + body)
