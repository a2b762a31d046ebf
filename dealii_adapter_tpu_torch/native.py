"""ctypes loader for the package's C++ host helpers (csrc/dat_native.cpp).

The port's copy of the JAX package's `native.py`: an O(n) transpose-gather
plan builder, a base64 encoder for the VTU writer and a sorted-unique
helper, all host code (none is a device kernel). The library is built at
first use with the host's C++ compiler (`$CXX`, else `c++`/`g++`) into
the package's `_build/` directory, never into the repository's
`csrc/build` (the JAX package's), under an exclusive `fcntl` lock, so
processes that start at once build it once and all load it; it is
rebuilt when its source changes (a SHA-256 in the file name). Without a
compiler, or if the build fails, every helper returns None and its caller
takes the numpy or standard-library path (`fem/dofspace.py:
build_transpose_gather_plan`, `utils/vtk.py:_b64`), which gives the same
result.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "dat_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    """The library's path for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdat_native_{h.hexdigest()[:16]}.so"


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def build() -> Optional[Path]:
    """Build the library unless it exists; returns its path, or None where
    there is no compiler or the build fails (the reason on stderr)."""
    path = lib_path()
    if path.exists():
        return path
    cxx = _compiler()
    if cxx is None:
        print("dat_native (torch) build skipped: no C++ compiler",
              file=sys.stderr)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the others wait
        if path.exists():
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True,
                           timeout=300)
            os.replace(tmp, path)  # atomic: a loader never sees half a file
        except (OSError, subprocess.SubprocessError) as e:
            print(f"dat_native (torch) build failed: {e}", file=sys.stderr)
            tmp.unlink(missing_ok=True)
            return None
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None if unavailable
    (callers fall back to numpy)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # an incompatible binary -> numpy fallback
        print(f"dat_native (torch) load skipped: {e}", file=sys.stderr)
        return None
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.dat_valence.argtypes = [i32, ctypes.c_int64, ctypes.c_int64, i64]
    lib.dat_fill_plan.argtypes = [i32, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, i32]
    lib.dat_fill_plan.restype = ctypes.c_int64
    lib.dat_b64.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_char)]
    lib.dat_b64.restype = ctypes.c_int64
    lib.dat_unique_sorted.argtypes = [i32, ctypes.c_int64, ctypes.c_int64, i32]
    lib.dat_unique_sorted.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_plan_native(cells: np.ndarray, n_nodes: int):
    """The transpose-gather plan ((n_nodes, max valence) int64, sentinel)
    as `fem/dofspace.py:build_transpose_gather_plan` builds it, in one
    pass; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(cells.reshape(-1), dtype=np.int32)
    n_inc = flat.size
    counts = np.empty(n_nodes, dtype=np.int64)
    lib.dat_valence(_ptr(flat, ctypes.c_int32), n_inc, n_nodes,
                    _ptr(counts, ctypes.c_int64))
    maxval = int(counts.max()) if n_nodes else 1
    plan = np.full((n_nodes, maxval), n_inc, dtype=np.int32)
    used = lib.dat_fill_plan(_ptr(flat, ctypes.c_int32), n_inc, n_nodes,
                             maxval, _ptr(plan, ctypes.c_int32))
    if used != maxval:
        raise RuntimeError(f"dat_fill_plan used {used} of {maxval} slots")
    return plan.astype(np.int64), n_inc


def b64_native(data) -> Optional[str]:
    """Base64 of `data` (bytes or an array's bytes); None if the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = (np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes)
           else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
    out = ctypes.create_string_buffer(4 * ((src.size + 2) // 3) + 1)
    m = lib.dat_b64(_ptr(src, ctypes.c_uint8), src.size, out)
    return out.raw[:m].decode("ascii")


def unique_sorted_native(ids: np.ndarray, n_nodes: int) -> Optional[np.ndarray]:
    """`np.unique` of node ids below `n_nodes` (int32); None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(ids.reshape(-1), dtype=np.int32)
    out = np.empty(flat.size, dtype=np.int32)
    m = lib.dat_unique_sorted(_ptr(flat, ctypes.c_int32), flat.size, n_nodes,
                              _ptr(out, ctypes.c_int32))
    return out[:m].copy()
