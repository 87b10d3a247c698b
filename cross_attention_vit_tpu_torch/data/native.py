"""ctypes binding for the native NIfTI decoder (``data/csrc/nifti_decode.cpp``).

Port of ``cross_attention_vit_tpu/data/native.py``: the same C ABI
(``nifti_decode_crop`` and ``nifti_decode_crop_batch``), from the port's own
copy of the source, compiled on first use with ``g++ -O3`` into this
package's ``data/build/`` (listed in .gitignore) through a per-process
temporary file, and rebuilt when the source is newer.  This is host decode
(numpy-free C++), not a device kernel.

Two variants, chosen by a compile-time define (``VARIANTS``):
``native-libdeflate`` gunzips with libdeflate (zlib for multi-member files),
``native-zlib`` with zlib's ``inflate`` alone.  The first use builds the
first that compiles and links on this host; ``variant()`` names it, or
``"python"`` when neither builds (no compiler, no ``zlib.h``) — then
``available()`` is False and the dataset reads volumes with the
pure-Python reader (``data/nifti.py``).  All three agree bit for bit.
``toolchain()`` says what this host has of what the builds need.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "nifti_decode.cpp"
_BUILD = Path(__file__).resolve().parent / "build"
# variant -> (compile flags, link flags), in the order the first use tries them
VARIANTS = {
    "native-libdeflate": (["-DNIFTI_LIBDEFLATE"], ["-ldeflate", "-lz"]),
    "native-zlib": ([], ["-lz"]),
}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}     # variant -> library, None: did not build
_chosen: str | None = None


def _library_path(variant: str) -> Path:
    return _BUILD / f"libniftidecode-{variant}.so"


def _build(variant: str) -> bool:
    """Compile ``variant`` into ``_library_path(variant)``; False if the
    compiler is missing or the build fails."""
    cflags, libs = VARIANTS[variant]
    out = _library_path(variant)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")   # test workers build at once
    cmd = ["g++", "-O3", "-shared", "-fPIC", *cflags, str(_SRC), "-o", str(tmp), *libs,
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    tmp.replace(out)
    return True


def _open(variant: str) -> ctypes.CDLL | None:
    """``variant``'s library, built if absent or older than the source;
    None if it does not build or load.  Call with the lock held."""
    if variant in _libs:
        return _libs[variant]
    path = _library_path(variant)
    lib = None
    if _SRC.exists() and ((path.exists() and path.stat().st_mtime >= _SRC.stat().st_mtime)
                          or _build(variant)):
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            lib = None
    if lib is not None:
        lib.nifti_decode_crop.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_size_t]
        lib.nifti_decode_crop.restype = ctypes.c_int
        lib.nifti_decode_crop_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.nifti_decode_crop_batch.restype = ctypes.c_int
    _libs[variant] = lib
    return lib


def load(variant: str) -> ctypes.CDLL | None:
    """The library of one variant (built on first use), or None where it
    does not build here."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown decoder variant {variant!r}: {list(VARIANTS)}")
    with _lock:
        return _open(variant)


def variant() -> str:
    """The decoder the dataset uses: the first of ``VARIANTS`` that builds
    here, else ``"python"`` (the pure-Python reader)."""
    global _chosen
    with _lock:
        if _chosen is None:
            _chosen = next((v for v in VARIANTS if _open(v) is not None), "python")
        return _chosen


def available() -> bool:
    """Whether a native variant built (``variant() != "python"``)."""
    return variant() != "python"


def toolchain() -> dict:
    """What this host has of what the builds need: ``g++`` on the PATH,
    ``zlib.h`` and ``libdeflate.h`` on its include path, and ``libz.so`` /
    ``libdeflate.so`` for its linker (each found by asking g++)."""
    gxx = shutil.which("g++")

    def ok(source: str, *args: str) -> bool:
        if gxx is None:
            return False
        try:
            return subprocess.run([gxx, "-x", "c++", "-", *args], input=source,
                                  capture_output=True, text=True, timeout=60).returncode == 0
        except subprocess.SubprocessError:
            return False

    def links(lib: str) -> bool:
        return ok("int main() { return 0; }", "-o", os.devnull, f"-l{lib}")

    return {"g++": gxx is not None,
            "zlib.h": ok("#include <zlib.h>\n", "-fsyntax-only"),
            "libdeflate.h": ok("#include <libdeflate.h>\n", "-fsyntax-only"),
            "libz.so": links("z"), "libdeflate.so": links("deflate")}


def _library(which: str | None) -> ctypes.CDLL:
    name = which or variant()
    lib = load(name) if name != "python" else None
    if lib is None:
        raise RuntimeError(f"native decoder {name} unavailable: no g++ or zlib.h "
                           "(see native.toolchain())")
    return lib


def decode_crop(path: str | Path, target: tuple[int, int, int], fill: float = -1.0,
                variant: str | None = None) -> np.ndarray:
    """Native equivalent of ``nifti.read_volume_cropped``, by the chosen
    variant or the one named."""
    lib = _library(variant)
    tx, ty, tz = target
    out = np.empty(target, np.float32)
    err = ctypes.create_string_buffer(256)
    rc = lib.nifti_decode_crop(str(path).encode(), tx, ty, tz, ctypes.c_float(fill),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
    if rc:
        raise IOError(f"native decode failed for {path}: {err.value.decode(errors='replace')}")
    return out


def decode_crop_batch(paths, target: tuple[int, int, int], fill: float = -1.0,
                      num_threads: int = 4, variant: str | None = None) -> np.ndarray:
    """Decode n files into (n, *target) float32 with a C++ thread pool."""
    lib = _library(variant)
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
