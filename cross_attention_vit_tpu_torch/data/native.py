"""ctypes binding for the native NIfTI decoder (``native/nifti_decode.cpp``).

Port of ``cross_attention_vit_tpu/data/native.py``: the same C ABI
(``nifti_decode_crop`` and ``nifti_decode_crop_batch``), compiled on first
use with ``g++ -O3`` into this package's own ``data/build/`` (listed in
.gitignore), rebuilt when the source is newer.  This is host decode (zlib or
libdeflate and numpy-free C++), not a device kernel.  Where the library
cannot be built (no compiler, no libdeflate), ``available()`` is False and
the dataset reads volumes with the pure-Python reader (``data/nifti.py``);
the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "nifti_decode.cpp"
_LIB = Path(__file__).resolve().parent / "build" / "libniftidecode.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _build() -> bool:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")   # test workers build at once
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp),
           "-ldeflate", "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    tmp.replace(_LIB)
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not _SRC.exists():
            _failed = True
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            _failed = True
            return None
        lib.nifti_decode_crop.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_size_t]
        lib.nifti_decode_crop.restype = ctypes.c_int
        lib.nifti_decode_crop_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.nifti_decode_crop_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable (no g++ or libdeflate?)")
    return lib


def decode_crop(path: str | Path, target: tuple[int, int, int], fill: float = -1.0) -> np.ndarray:
    """Native equivalent of ``nifti.read_volume_cropped``."""
    lib = _library()
    tx, ty, tz = target
    out = np.empty(target, np.float32)
    err = ctypes.create_string_buffer(256)
    rc = lib.nifti_decode_crop(str(path).encode(), tx, ty, tz, ctypes.c_float(fill),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
    if rc:
        raise IOError(f"native decode failed for {path}: {err.value.decode(errors='replace')}")
    return out


def decode_crop_batch(paths, target: tuple[int, int, int], fill: float = -1.0,
                      num_threads: int = 4) -> np.ndarray:
    """Decode n files into (n, *target) float32 with a C++ thread pool."""
    lib = _library()
    paths = [str(p) for p in paths]
    n = len(paths)
    tx, ty, tz = target
    out = np.empty((n, tx, ty, tz), np.float32)
    arr = (ctypes.c_char_p * n)(*(p.encode() for p in paths))
    err = ctypes.create_string_buffer(256)
    rc = lib.nifti_decode_crop_batch(arr, n, tx, ty, tz, ctypes.c_float(fill),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     num_threads, err, 256)
    if rc:
        raise IOError(f"native batch decode failed at {paths[rc - 1]}: "
                      f"{err.value.decode(errors='replace')}")
    return out
