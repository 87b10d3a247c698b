"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds) and is compiled for Hopper at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

into ``kernels/build/`` (listed in .gitignore).  The file name carries a hash
of the source, the shared headers and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is built
when a module is imported: the CPU tests import every module on a host
without ``nvcc``.

Every library keeps one calling convention: an entry point that launches
kernels takes the CUDA stream and the device index as its last two
arguments and returns 0 or a CUDA error code, which the library's own
``*_error_string`` names.  ``Library`` binds a library's entry points at
first use and launches them on the device's current stream, raising on an
error, so that no kernel wrapper declares a signature or checks an error
code of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels are built on a host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, force: bool = False) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu``.  Returns (library path, seconds spent in
    nvcc — 0.0 when an up-to-date library was reused, ptxas report)."""
    lib = library_path(name)
    if lib.exists() and not force:
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode} building {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            lib, _, _ = build(name)
            _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


class Library:
    """The entry points of ``csrc/<name>.cu``, bound at first use.

    ``launches`` maps each entry point that launches kernels to the ctypes
    types of its arguments before (stream, device); each returns a
    ``c_int``.  ``functions`` maps any other entry point to (argument
    types, result type); those are called as they are, as attributes of the
    library.  ``error_string`` names the library's ``const char* (int)``
    that describes an error code.  Nothing is built or loaded until the
    first call."""

    def __init__(self, name: str, error_string: str, launches: dict[str, list],
                 functions: dict[str, tuple[list, object]] | None = None):
        self.name = name
        self.error_string = error_string
        self.launches = launches
        self.functions = functions or {}
        self._lib: ctypes.CDLL | None = None

    def _bound(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            signatures = {fn: ([*args, ctypes.c_void_p, ctypes.c_int], ctypes.c_int)
                          for fn, args in self.launches.items()}
            signatures.update(self.functions)
            signatures[self.error_string] = ([ctypes.c_int], ctypes.c_char_p)
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def message(self, err: int) -> str:
        """The library's description of CUDA error ``err``."""
        return getattr(self._bound(), self.error_string)(err).decode()

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call entry point ``fn`` with ``args``, then the current stream of
        ``device`` and its index; raise RuntimeError when it returns an
        error."""
        err = getattr(self._bound(), fn)(*args, torch.cuda.current_stream(device).cuda_stream,
                                         device.index)
        if err:
            raise RuntimeError(f"{fn} failed: CUDA error {err} ({self.message(err)})")

    def __getattr__(self, fn: str):
        if fn in self.__dict__.get("functions", ()):
            return getattr(self._bound(), fn)
        raise AttributeError(f"{self.__dict__.get('name')} declares no plain entry point {fn}")
