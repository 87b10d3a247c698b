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
