"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled by nvcc for ``sm_90a`` with the same flags (``NVCC_FLAGS``) and
bound with ctypes by the module that owns it (``kernels/dampen.py``,
``fimd.py``, ``gemm_fisher.py``, ``gemm_fisher_int8.py``). A library is
built at first use, from the source in the checkout, into ``_build/``
beside this file (listed in .gitignore), under a name that hashes the
source and the flags, so an edited source or flag rebuilds.
``build_all()`` starts one nvcc per source, all at once, and waits for
them. ``BUILD_LOG`` keeps nvcc's output per library (ptxas registers and
spills) when this process built it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: divides and conversions must stay correctly rounded
# (the dampen kernels are bit-exact against their plain versions).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BUILD_LOG: Dict[str, str] = {}  # library name -> nvcc's output
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """The library names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def source_hash(source: bytes, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """The tag in a library's file name: a hash of its source and flags."""
    return hashlib.sha256(source + b"\0" + " ".join(flags).encode()
                          ).hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"libficabu_{name}-{source_hash(src.read_bytes())}.so"


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named libraries (default: every ``csrc/*.cu``) that are
    not built yet, one nvcc each, started together; returns name -> path.
    Raises on the first nvcc that fails, after all have ended."""
    names = list(names) or sources()
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, so in todo.items():
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build csrc/{n}.cu (exit "
                          f"{proc.returncode}):\n{out}")
            continue
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, todo[n])
        BUILD_LOG[n] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` if this exact source and flag set has not
    been built yet; returns the shared library's path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib


def bind(lib: ctypes.CDLL, entry: str, argtypes) -> ctypes._CFuncPtr:
    """``lib.entry`` with its argument types set and an int return (the
    entry's cudaError)."""
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
