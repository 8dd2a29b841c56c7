"""Build the package's native sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, where
the hash covers the source and the flags, then loaded with ``ctypes``.
Each ``csrc/<name>.cpp`` (host code: the ``.raw`` reader) is compiled the
same way with the host C++ compiler.  The build directory is not
committed; a checkout builds on its first use, or all at once with
:func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false: no multiply-add contraction, so the kernel rounds every
# product and sum as the plain PyTorch twin does and the two agree bit for
# bit (a contracted projection can flip a voxel's pixel near a pixel edge)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: the host sources' compiler flags (those of the JAX package's
#: ``csrc/Makefile``, so that both builds round alike)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _command(name: str):
    """The compiler and its flags for ``name``."""
    if name in HOST_SOURCES:
        return [os.environ.get("CXX") or shutil.which("c++") or "g++",
                *CXX_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


def _host_cpu() -> str:
    """The host CPU's feature flags (``-march=native`` builds for them)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (or ``.cpp``) builds to, keyed by source
    and flags (and, for host code, the CPU's features)."""
    flags = " ".join(NVCC_FLAGS)
    if name in HOST_SOURCES:
        flags = " ".join(CXX_FLAGS) + _host_cpu()
    digest = hashlib.sha256(_source(name).read_bytes()
                            + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


#: every kernel source of the package
SOURCES = ("integrate", "gather_probe", "icp", "pyramid", "numerics",
           "raycast")
#: host sources, built with the C++ compiler
HOST_SOURCES = ("io_native",)


def constants(name: str) -> Dict[str, int]:
    """The integer constants that ``csrc/<name>.cu`` defines by a literal
    (``constexpr int kName = 64;``), read from the source, so that the host
    code that needs a kernel's geometry (for its bounds) takes it from the
    one place the kernel does."""
    src = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"^constexpr int (k\w+) = (\d+);", src, re.M)}


def _start(name: str):
    """Start the compiler on ``name``'s source unless it is built; returns
    (library, temporary output, process) or None."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [*_command(name), "-o", str(tmp), str(_source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return so, tmp, proc


def _finish(name: str, so: Path, tmp: Path, proc) -> None:
    out, err = proc.communicate()
    so.with_name(so.name + ".log").write_text(out + err)
    if proc.returncode != 0:
        raise RuntimeError(f"the compiler failed building {name}:\n{err}")
    os.replace(tmp, so)        # atomic: concurrent builds never race


def build_all(names=SOURCES) -> None:
    """Build every source in ``names`` that is not built yet, one ``nvcc``
    each, all started together."""
    started = {name: _start(name) for name in names}
    for name, job in started.items():
        if job is not None:
            _finish(name, *job)


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (or ``.cpp``), compiling it
    if needed.  The compiler's output (for a kernel ``-Xptxas -v``:
    registers, spills) is kept beside it in ``<library>.log``."""
    if name in _loaded:
        return _loaded[name]
    build_all((name,))
    _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
