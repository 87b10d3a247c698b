"""``kernels/_build.Library``, the one binder and launcher of the port's CUDA
libraries, on the CPU: against a fake ctypes library it declares every
entry point's types at first use, appends the current stream and the
device index to a launch, and raises with the entry point, the code and
the library's own message when a launch returns an error.  Every library
the kernel modules declare matches the C prototypes of its source, and
importing those modules builds and loads nothing."""

from __future__ import annotations

import ctypes
import importlib
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cross_attention_vit_tpu_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("flash_attention", "layernorm", "linear_epilogue", "pool_attention", "resample",
           "window_attention",
           "window_layout")


class _FakeFunction:
    """A ctypes function pointer's surface: declared types and a call."""

    def __init__(self, result):
        self.argtypes = None
        self.restype = None
        self.result = result
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


class _FakeLibrary:
    def __init__(self, results: dict):
        self.functions = {name: _FakeFunction(r) for name, r in results.items()}

    def __getattr__(self, name):
        return self.functions[name]


@pytest.fixture
def fake(monkeypatch):
    """A fake library behind ``_build.load`` and a fake current stream; the
    names loaded go to ``fake.loaded``."""
    lib = _FakeLibrary({"demo_launch": 0, "demo_fails": 700, "demo_count": 42,
                        "demo_error_string": b"an illegal memory access was encountered"})
    state = SimpleNamespace(lib=lib, loaded=[])

    def load(name):
        state.loaded.append(name)
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0xC0FFEE))
    return state


def _demo() -> _build.Library:
    return _build.Library("demo", "demo_error_string",
                          {"demo_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_float],
                           "demo_fails": [ctypes.c_int]},
                          functions={"demo_count": ([ctypes.c_int], ctypes.c_longlong)})


def test_a_library_binds_its_entry_points_at_first_use(fake):
    lib = _demo()
    assert fake.loaded == []
    assert fake.lib.demo_launch.argtypes is None
    lib.launch("demo_launch", torch.device("cuda", 3), 16, 2, 0.5)
    assert fake.loaded == ["demo"]
    f = fake.lib.functions
    assert f["demo_launch"].argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_void_p, ctypes.c_int]
    assert f["demo_launch"].restype is ctypes.c_int
    assert f["demo_fails"].argtypes == [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    assert f["demo_fails"].restype is ctypes.c_int
    assert (f["demo_count"].argtypes, f["demo_count"].restype) == ([ctypes.c_int],
                                                                   ctypes.c_longlong)
    assert (f["demo_error_string"].argtypes, f["demo_error_string"].restype) == (
        [ctypes.c_int], ctypes.c_char_p)
    lib.launch("demo_launch", torch.device("cuda", 3), 16, 2, 0.5)
    assert fake.loaded == ["demo"]


def test_a_launch_appends_the_current_stream_and_the_device(fake):
    _demo().launch("demo_launch", torch.device("cuda", 3), 16, 2, 0.5)
    assert fake.lib.demo_launch.calls == [(16, 2, 0.5, 0xC0FFEE, 3)]


def test_a_failed_launch_raises_with_the_entry_point_the_code_and_the_message(fake):
    with pytest.raises(RuntimeError) as raised:
        _demo().launch("demo_fails", torch.device("cuda", 0), 1)
    assert str(raised.value) == ("demo_fails failed: CUDA error 700 (an illegal memory access "
                                 "was encountered)")
    assert fake.lib.demo_error_string.calls == [(700,)]


def test_a_plain_entry_point_is_called_as_it_is(fake):
    lib = _demo()
    assert lib.demo_count(5) == 42
    assert fake.lib.demo_count.calls == [(5,)]
    with pytest.raises(AttributeError, match="demo_launch"):
        lib.demo_launch


def _c_prototypes(source: str) -> dict[str, list[str]]:
    """Each ``extern "C"`` function of a CUDA source: its parameters' types,
    with the ``#define NAME_PARAMS`` lists the sources share expanded."""
    macros = {m[1]: m[2] for m in re.finditer(r"#define (\w+PARAMS)\s+((?:.*\\\n)*.*)", source)}
    out = {}
    for m in re.finditer(r'extern "C" [\w\s*]+?\b(\w+)\(([^)]*)\)', source):
        params = macros.get(m[2].strip(), m[2]).replace("\\\n", " ")
        out[m[1]] = [re.sub(r"\s*\*", "*", re.sub(r"\s*\b\w+$", "", p.strip()))
                     for p in params.split(",")]
    return out


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "int*": ctypes.POINTER(ctypes.c_int)}


def _ctype(param: str):
    param = param.replace("const ", "")
    return _C_TYPES.get(param, ctypes.c_void_p) if "*" in param else _C_TYPES[param]


def _libraries():
    for module in MODULES:
        mod = importlib.import_module(f"cross_attention_vit_tpu_torch.kernels.{module}")
        for value in vars(mod).values():
            if isinstance(value, _build.Library):
                yield value


def _entry_points():
    return [pytest.param(lib, fn, id=fn) for lib in _libraries()
            for fn in [*lib.launches, *lib.functions]]


@pytest.mark.parametrize("lib, fn", _entry_points())
def test_each_declared_entry_point_matches_its_c_prototype(lib, fn):
    prototypes = _c_prototypes((_build.CSRC / f"{lib.name}.cu").read_text())
    assert lib.error_string in prototypes
    if fn in lib.launches:
        assert prototypes[fn][-2:] == ["void*", "int"], prototypes[fn]
        assert [_ctype(p) for p in prototypes[fn][:-2]] == lib.launches[fn]
    else:
        assert [_ctype(p) for p in prototypes[fn]] == lib.functions[fn][0]


def test_every_entry_point_of_every_source_is_declared():
    libs = {lib.name: lib for lib in _libraries()}
    assert sorted(libs) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name, lib in libs.items():
        prototypes = _c_prototypes((_build.CSRC / f"{name}.cu").read_text())
        assert set(prototypes) == {*lib.launches, *lib.functions, lib.error_string}


def test_importing_the_kernel_modules_builds_and_loads_nothing():
    code = textwrap.dedent(f"""
        import importlib
        from cross_attention_vit_tpu_torch.kernels import _build

        def refuse(*args, **kwargs):
            raise SystemExit("built or loaded at import")

        _build.build = _build.load = refuse
        for module in {MODULES!r}:
            importlib.import_module("cross_attention_vit_tpu_torch.kernels." + module)
        assert _build._loaded == {{}}
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
