"""Build CUDA sources once with nvcc and bind the result through ctypes.

Hand kernels written in CUDA C++ export a plain C interface; this module
compiles them for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
one shared library per kernel family and loads it with :mod:`ctypes`.
Every translation unit gets its own ``nvcc`` process, all started
together, then one link step joins them.

The library is keyed by a hash of every source and flag, so an edited
kernel rebuilds and an unchanged one loads the library already built.
Builds land in ``build/repro_torch/`` at the root of the checkout, which
``.gitignore`` lists. The build is set-up cost: callers time it and
report it, it never hides inside a measurement. Different families
build concurrently (one lock per family).

:func:`load_family` is the common shape of a kernel family: a header of
templates whose phase-1 tuning knobs are template parameters, one
exported C launcher per instantiation (generated units that include the
header and expand its instantiation macro), and an error-string
function, all in one library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Mapping, Sequence

#: ``<checkout>/build/repro_torch``: the package lives at ``src/repro_torch``
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: headers every family may include (``sm90.cuh``: the Hopper primitives)
SHARED_CSRC = Path(__file__).resolve().with_name("_csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_MU = threading.Lock()


def _family_lock(name: str) -> threading.Lock:
    with _LOCKS_MU:
        return _LOCKS.setdefault(name, threading.Lock())


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH`` or in the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (nvcc on PATH or under /usr/local/cuda)")


class BuiltLibrary:
    """A loaded shared library and what its build cost."""

    def __init__(self, path: Path, build_s: float, built: bool) -> None:
        self.path = path
        self.lib = ctypes.CDLL(str(path))
        # seconds the nvcc build took in this process (0 when the library
        # was already on disk), and whether this process built it
        self.build_s = build_s
        self.built = built


def _digest(sources: Mapping[str, str], include_dirs: Sequence[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(sources):
        h.update(name.encode())
        h.update(sources[name].encode())
    for inc in include_dirs:
        for path in sorted(Path(inc).glob("*.cuh")):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(name: str, sources: Mapping[str, str],
                  include_dirs: Sequence[Path] = ()) -> BuiltLibrary:
    """Compile ``sources`` (file name -> CUDA source text) into one library.

    Each unit compiles in its own ``nvcc`` process, all in parallel; a
    failing unit raises with the compiler's output. ``-Xptxas -v`` reports
    (registers, shared memory, spills) are kept beside the library in
    ``<name>-<hash>.ptxas.log``.
    """
    with _family_lock(name):
        digest = _digest(sources, include_dirs)
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            return BuiltLibrary(out, 0.0, False)
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_dir = Path(tmp)
            incs = [f"-I{Path(d).resolve()}" for d in include_dirs]
            procs = []
            for unit, text in sorted(sources.items()):
                src = tmp_dir / unit
                src.write_text(text)
                obj = src.with_suffix(".o")
                cmd = [nvcc, *NVCC_FLAGS, *incs, "-c", str(src), "-o", str(obj)]
                procs.append((unit, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for unit, _obj, proc in procs:
                text, _ = proc.communicate()
                logs.append(f"== {unit}\n{text}")
                if proc.returncode != 0:
                    failed.append(f"{unit} (exit {proc.returncode}):\n{text}")
            if failed:
                raise RuntimeError(
                    f"nvcc failed for {len(failed)} unit(s) of {name}:\n"
                    + "\n".join(failed))
            lib_tmp = tmp_dir / out.name
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(lib_tmp),
                 *(str(obj) for _u, obj, _p in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking {name} failed:\n{link.stdout}")
            out.with_suffix(".ptxas.log").write_text("\n".join(logs))
            os.replace(lib_tmp, out)
        return BuiltLibrary(out, time.perf_counter() - t0, True)


_ERROR_UNIT = """#include <cuda_runtime.h>
extern "C" const char* {family}_error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
"""


class KernelLibrary:
    """A family's built instantiations, resolved by exported symbol."""

    def __init__(self, built: BuiltLibrary, family: str,
                 symbols: Sequence[str], argtypes: Sequence[type]) -> None:
        self.built = built
        self.build_s = built.build_s
        self.family = family
        self.symbols = tuple(symbols)
        lib = built.lib
        err = getattr(lib, f"{family}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string = err
        # seconds load_all took, once it has run
        self.load_s: float | None = None
        self._fns: dict[str, ctypes._CFuncPtr] = {}
        for sym in self.symbols:
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._fns[sym] = fn

    def resolve(self, symbol: str):
        """The launcher of one instantiation (raises if it was not built)."""
        fn = self._fns.get(symbol)
        if fn is None:
            raise KeyError(
                f"no {self.family} instantiation {symbol}: the library holds "
                f"the {len(self._fns)} points it was built for")
        return fn

    def load_all(self, suffix: str) -> float:
        """Call every instantiation's exported ``<symbol><suffix>()`` (an
        ``int`` status, 0 for success) and return the seconds it took,
        also kept in ``.load_s``; a non-zero status raises. A family uses
        it to load its kernels into the current CUDA context at set-up,
        instead of at each one's first launch (CUDA loads them lazily by
        default)."""
        t0 = time.perf_counter()
        for sym in self.symbols:
            fn = getattr(self.built.lib, sym + suffix)
            fn.argtypes = []
            fn.restype = ctypes.c_int
            rc = fn()
            if rc != 0:
                raise RuntimeError(f"{sym}{suffix} failed: "
                                   f"{self._error_string(int(rc)).decode()}")
        self.load_s = time.perf_counter() - t0
        return self.load_s

    def launch(self, symbol: str, *args) -> None:
        """Launch one instantiation; a refused launch raises."""
        rc = self.resolve(symbol)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{symbol} launch failed: "
                f"{self._error_string(int(rc)).decode()}")


def instantiation_units(family: str, header: str, lines: Sequence[str],
                        n_units: int) -> dict[str, str]:
    """Translation units of a family: its error-string unit, and the
    instantiation lines dealt round-robin over ``n_units`` files that
    include ``header``."""
    units = {f"{family}_errors.cu": _ERROR_UNIT.format(family=family)}
    for i in range(min(n_units, len(lines))):
        body = [f'#include "{header}"', *lines[i::n_units]]
        units[f"{family}_inst{i}.cu"] = "\n".join(body) + "\n"
    return units


_FAMILIES: dict[tuple, KernelLibrary] = {}
_FAMILIES_MU = threading.Lock()


def load_family(family: str, csrc: Path, header: str,
                instantiations: Mapping[str, str],
                argtypes: Sequence[type], *, n_units: int = 8) -> KernelLibrary:
    """Build (once per process and source hash) and load a kernel family.

    ``instantiations`` maps each exported launcher's symbol to the macro
    line of ``header`` that defines it; the lines are dealt round-robin
    over ``n_units`` translation units, compiled in parallel. The units
    see ``csrc`` and the shared :data:`SHARED_CSRC` as include
    directories, and the library's hash covers the headers of both, so
    an edit of a shared header rebuilds every family.
    """
    key = (family, tuple(sorted(instantiations.items())))
    with _family_lock(f"load:{family}"):
        with _FAMILIES_MU:
            found = _FAMILIES.get(key)
        if found is not None:
            return found
        lines = [line for _sym, line in sorted(instantiations.items())]
        units = instantiation_units(family, header, lines, n_units)
        built = build_library(family, units, include_dirs=[csrc, SHARED_CSRC])
        lib = KernelLibrary(built, family, sorted(instantiations), argtypes)
        with _FAMILIES_MU:
            _FAMILIES[key] = lib
        return lib
