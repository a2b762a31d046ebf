"""Build and bind the package's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into one
shared library with a plain C interface, `_build/libdat_torch_kernels.so`
inside the package, and loaded with ctypes. Each C entry point launches on
the stream it is given and returns the `cudaError_t` of the launch.

The build happens at the first call of `load_library()`, never at import,
so the package imports (and its CPU tests run) on hosts without `nvcc`. It
is keyed by a SHA-256 of the sources: an edited kernel rebuilds, an
unchanged one reuses the library. A failed build raises with nvcc's
standard error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libdat_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: (argtypes, restype cudaError_t)
_SIGNATURES = {
    # (KT, u, out, edofs, n_cells, stream)
    "dat_tangent_matvec_f32": (_P, _P, _P, _I, ctypes.c_longlong, _P),
    # (u, y, E, nz, ny, nx, io_bf16, stream)
    "dat_q1_structured": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dat_q2_structured": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lib = None
build_seconds = None  # wall time of the last build in this process


def _sources():
    return sorted(
        p for p in SOURCE_DIR.iterdir() if p.suffix in (".cu", ".cuh")
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "dealii_adapter_tpu_torch cannot be built on this host"
    )


def build(force: bool = False) -> Path:
    """Compile every kernel source into the shared library (skipped when
    the library on disk was built from the same sources). Returns its
    path."""
    global build_seconds
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    key = source_hash()
    if (
        not force
        and lib_path.exists()
        and stamp.exists()
        and stamp.read_text().strip() == key
    ):
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [
        str(p) for p in _sources() if p.suffix == ".cu"
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, lib_path)
    stamp.write_text(key + "\n")
    return lib_path


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
