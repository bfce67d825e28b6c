"""Build and load the port's CUDA kernels: nvcc → one shared library → ctypes.

The sources under ``kernels/csrc/`` have a plain C interface (no PyTorch
headers), so one ``nvcc`` call builds them in seconds. The library lands in
``fastoptsolver_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the cached build. Nothing here runs at import: the first
wrapper that launches a kernel calls :func:`library`.

Pointers and the stream go to the C functions as ``ctypes.c_void_p``; each
function returns a ``cudaError_t`` (0 = success) that the wrappers check
with :func:`check`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_solve.cu", "stream.cu")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# No --use_fast_math: τ = 1/L, the norms' sqrt and the gap's divisions must be
# IEEE and denormals must not flush. -Xptxas -v writes each kernel's
# registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # A, b, alpha1, alpha2, betas, X, iters, gap, done, n, m, B, b_tile,
    # pl_iters, l_safety, t_init, chunk, k_end, tol, stream
    "fused_lasso_solve": [_vp] * 9 + [_i, _ll, _ll, _i, _i, _f, _f, _i, _i,
                                      _f, _vp],
    # A, b, out, n, m, B, b_tile, stream
    "stream_ceiling": [_vp, _vp, _vp, _i, _ll, _ll, _i, _vp],
    "fos_cuda_error_string": [_i],
}
_RESTYPES = {"fos_cuda_error_string": ctypes.c_char_p}  # the rest return int

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output for the library this process built or loaded
build_seconds = 0.0  # time spent in nvcc by this process (0 for a cached build)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of fastoptsolver_tpu_torch are built from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet. Raises if nvcc is missing or the build fails."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    digest = _digest()
    so = BUILD_DIR / f"libfos_kernels_{digest}.so"
    log = BUILD_DIR / f"libfos_kernels_{digest}.log"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    build_log = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = library().fos_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
