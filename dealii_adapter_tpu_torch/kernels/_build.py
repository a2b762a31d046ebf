"""Build, bind and health-check the package's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` process for
`sm_90a`, all started together, and the objects are linked into one
shared library with a plain C interface, `_build/libdat_torch_kernels.so`
inside the package, loaded with ctypes. Each C entry point launches on
the stream it is given and returns the `cudaError_t` of the launch.

The build happens at the first call of `load_library()`, never at import,
so the package imports (and its CPU tests run) on hosts without `nvcc`. It
is keyed by a SHA-256 of the sources: an edited kernel rebuilds, an
unchanged one reuses the library. A failed build raises with nvcc's
standard error.

Right after loading the library, before any real kernel runs,
`load_library()` launches the two health-check kernels (C1: y = x * salt,
C2: y = x + 1, csrc/health.cu) and compares them exactly with the same
arithmetic on the host; a launch error or any mismatch raises. There is
no fallback.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: (argtypes, restype cudaError_t)
_SIGNATURES = {
    # (K, u, out, edofs, n_cells, stream): K1 column-major, K1b row-major
    "dat_tangent_matvec_f32": (_P, _P, _P, _I, ctypes.c_longlong, _P),
    "dat_tangent_matvec_rows_f32": (_P, _P, _P, _I, ctypes.c_longlong, _P),
    # K1c (ptrs[dim^2], strides_i[dim^2], strides_j[dim^2], u, out, dim,
    # npc, n_cells, stream)
    "dat_tangent_matvec_blocks_f32": (_P, _P, _P, _P, _P, _I, _I,
                                      ctypes.c_longlong, _P),
    # K2/K2b (ptrs[n_upper_blocks], u, out, dim, npc, n_cells, stream)
    "dat_tangent_matvec_sym_f32": (_P, _P, _P, _I, _I, ctypes.c_longlong, _P),
    # (u, y, coefficients, nz, ny, nx, io, stream): K3 and K4 (class
    # tables, `io` a dat::IoMode), and the first designs of K4 (plane
    # marching), K3 and K5 (gathers) (E; `io` 0 or 1)
    "dat_q1_structured": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dat_q1_plane": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dat_q1_plane_marching": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dat_q1_structured_gather": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dat_q2_structured_gather": (_P, _P, _P, _I, _I, _I, _I, _P),
    # K5 (u, y, mma fragments, E, nz, ny, nx, io_bf16, stream)
    "dat_q2_structured": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # K6 (u, y, class tables, nz, ny, nx, ndim, io_bf16, stream), and its
    # first (pointwise) design
    "dat_q1_stencil": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dat_q1_stencil_pointwise": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (u, y, coefficients, ny, nx, io_bf16, stream): K4b (class tables)
    # and its first (gather) design (E)
    "dat_q1_structured_2d": (_P, _P, _P, _I, _I, _I, _P),
    "dat_q1_structured_2d_gather": (_P, _P, _P, _I, _I, _I, _P),
    # (x, y, salt, n, stream) and (x, y, n, stream)
    "dat_health_scale": (_P, _P, ctypes.c_float, _I, _P),
    "dat_health_add_one": (_P, _P, _I, _P),
    # (stream): an empty kernel, the launch floor chip_smoke.py measures
    "dat_launch_floor": (_P,),
}

_lib = None
build_seconds = None  # wall time of the last build in this process
# ptxas's resource report per source of that build (-Xptxas -v: registers,
# shared memory, spills of each kernel)
ptxas_report = None
health = None  # result of the last health check in this process


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


def _run_all(cmds):
    """Run the commands in parallel; raise with the failures' output.
    Returns each command's standard error."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    failed, errs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def build(force: bool = False) -> Path:
    """Compile every kernel source (one nvcc per source, in parallel) and
    link the shared library (skipped when the library on disk was built
    from the same sources). Returns its path."""
    global build_seconds, ptxas_report
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
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = []
    compiles = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        errs = _run_all(compiles)
        ptxas_report = {Path(c[-1]).name: e for c, e in zip(compiles, errs)}
        _run_all([[nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    stamp.write_text(key + "\n")
    return lib_path


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use and health-checked
    (C1/C2) before it is handed out."""
    global _lib, health
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        health = health_check(lib)
        _lib = lib
    return _lib


def unload() -> None:
    """Forget the bound library: the next `load_library()` binds and
    health-checks it again (the library on disk is reused)."""
    global _lib
    _lib = None


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def io_mode(in_dtype, out_dtype) -> int:
    """The `dat::IoMode` (csrc/structured_gather.cuh) of the level and fine
    kernels K3, K4, K4b, K5 and K6 for an input and output dtype: f32 in
    and out (0), bf16 in and out (1), bf16 in and the f32 accumulation
    out (2), or f64 in and out (3: the Q1 level kernels' f64
    instantiation; K5 refuses it). Any other pair raises."""
    import torch

    modes = {(torch.float32, torch.float32): 0,
             (torch.bfloat16, torch.bfloat16): 1,
             (torch.bfloat16, torch.float32): 2,
             (torch.float64, torch.float64): 3}
    try:
        return modes[(in_dtype, out_dtype)]
    except KeyError:
        raise TypeError(
            f"the level kernels take float32 or bfloat16 input and output "
            f"float32 or the input dtype, or float64 in and out, got "
            f"{in_dtype} -> {out_dtype}") from None


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def c_array(ctype, values):
    """A ctypes array of `values`; pass `ctypes.addressof` of it as a
    pointer argument and keep it alive across the call."""
    return (ctype * len(values))(*values)


def _f32_block(x):
    import torch

    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("health kernels take a contiguous float32 CUDA tensor")


def health_scale(x, salt: float, lib=None):
    """C1 wrapper: y = x * salt (salt rounded to f32)."""
    _f32_block(x)
    import torch

    y = torch.empty_like(x)
    check((load_library() if lib is None else lib).dat_health_scale(
        x.data_ptr(), y.data_ptr(), salt, x.numel(), stream_of(x)), "C1")
    health_scale.launches += 1
    return y


def health_add_one(x, lib=None):
    """C2 wrapper: y = x + 1."""
    _f32_block(x)
    import torch

    y = torch.empty_like(x)
    check((load_library() if lib is None else lib).dat_health_add_one(
        x.data_ptr(), y.data_ptr(), x.numel(), stream_of(x)), "C2")
    health_add_one.launches += 1
    return y


health_scale.launches = 0
health_add_one.launches = 0


def health_check(lib) -> dict:
    """Launch C1 and C2 on a seeded 8 x 128 f32 block with a per-process
    salt and compare bitwise with numpy's f32 arithmetic; raise on a launch
    error or any mismatch. Returns the salt and the mismatch counts."""
    import numpy as np
    import torch

    x_host = np.random.default_rng(os.getpid()).standard_normal(
        (8, 128)).astype(np.float32)
    # exactly representable in f32, different from process to process
    salt = np.float32(1.0 + (os.getpid() % 1021 + 1) / 1024.0)
    x = torch.from_numpy(x_host).cuda()
    y1 = health_scale(x, float(salt), lib).cpu().numpy()
    y2 = health_add_one(x, lib).cpu().numpy()
    torch.cuda.synchronize()
    bad = {
        "C1": int((y1 != x_host * salt).sum()),
        "C2": int((y2 != x_host + np.float32(1.0)).sum()),
    }
    if any(bad.values()):
        raise RuntimeError(
            f"kernel library health check failed: mismatching elements {bad} "
            "of 1024 (C1: y = x * salt, C2: y = x + 1)"
        )
    return {"salt": float(salt), "mismatches": bad, "elements": x_host.size}
