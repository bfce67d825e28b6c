"""Build and load the port's CUDA kernels: nvcc → one shared library → ctypes.

The sources under ``kernels/csrc/`` have a plain C interface (no PyTorch
headers). Each is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects: seconds in all. The
library lands in ``fastoptsolver_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the flags and of every file under
``csrc/``, so an edited source or header rebuilds and an unchanged tree
loads the cached build. Nothing here runs at import: the first wrapper
that launches a kernel calls :func:`library`.

Every launch takes one path into the library: a wrapper checks its tensors
with :func:`check_tensors`, encodes its momentum mode with
:func:`mode_args` and calls its entry with :func:`call`, which passes each
tensor as its data pointer and the current stream as ``ctypes.c_void_p``
and raises on the ``cudaError_t`` it returns (0 = success) with
:func:`check`. :func:`refuse_interpret` is the one rule that sends a CPU
tensor, never a CUDA one, to the plain twins.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# source -> extra flags. --fmad=false keeps nvcc from contracting a*b + c into
# one FMA, so those kernels round each product and each sum as their plain
# twins do (explicit fmaf() calls stay fused). lipschitz.cu's estimate has no
# bit bar and sums with fmaf().
SOURCES = {
    "fused_solve.cu": (),
    "stream.cu": (),
    "gram_build.cu": ("--fmad=false",),
    "fista_burst.cu": ("--fmad=false",),
    "resident.cu": ("--fmad=false",),
    "qstream.cu": ("--fmad=false",),
    "lipschitz.cu": (),
}
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# No --use_fast_math: τ = 1/L, the norms' sqrt and the gap's divisions must be
# IEEE and denormals must not flush. -Xptxas -v writes each kernel's
# registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # A, b, alpha1, alpha2, betas, X0, Y0, t0, ps0, tv0, k0, done0, iters0,
    # gap0, X, iters, gap, done, Y, t, ps, tv, k, n, m, B, b_tile, pl_iters,
    # l_safety, t_init, chunk, k_end, tol, mode, armijo, restart_threshold,
    # greedy_S, greedy_shrink, armijo_c, armijo_eta, max_backtracks, stream
    "fused_lasso_solve": [_vp] * 23 + [_i, _ll, _ll, _i, _i, _f, _f, _i, _i,
                                       _f, _i, _i, _f, _f, _f, _f, _f, _i, _vp],
    # A, b, out, n, m, B, b_tile, stream
    "stream_ceiling": [_vp, _vp, _vp, _i, _ll, _ll, _i, _vp],
    # A, b, Q, c, btb, n, m, B, stream
    "gram_pairs": [_vp] * 5 + [_i, _ll, _ll, _vp],
    # Q, c, lam, n, B, pl_iters, stream
    "gram_power": [_vp] * 3 + [_i, _ll, _i, _vp],
    # n: gram_power's lanes per CTA on the current device, and their shared bytes
    "gram_power_group": [_i],
    "gram_power_smem_bytes": [_i],
    # Q, S, c, tau, thr, a2, a1, btb, X, Y, t, ps, taumin, tauv, betas,
    # Xo, Yo, to, pso, tauvo, gap, n, B, n_steps, k0, mode, armijo,
    # with_gap, slab, restart_threshold, greedy_S, greedy_shrink, armijo_c,
    # armijo_eta, max_backtracks, stream
    "fista_burst": [_vp] * 21 + [_i, _ll, _i, _i, _i, _i, _i, _i, _f, _f, _f,
                                 _f, _f, _i, _vp],
    # Q, c, tau, thr, a2, a1, btb, taumin, betas, X0, Y0, t0, ps0, tv0, k0,
    # done0, iters0, gap0, X, Y, t, ps, tv, k, done, iters, gap, n, B, G,
    # chunk, k_end, tol, mode, armijo, restart_threshold, greedy_S,
    # greedy_shrink, armijo_c, armijo_eta, max_backtracks, est_l_iters,
    # l_safety, t_init, stream
    "resident_solve": [_vp] * 27 + [_i, _ll, _i, _i, _i, _f, _i, _i, _f, _f,
                                    _f, _f, _f, _i, _i, _f, _f, _vp],
    # Q, Qt, c, tau, thr, a2, a1, btb, X, Y, t, ps, taumin, betas, Xo, Yo,
    # to, pso, gap, n, B, n_steps, k0, mode, with_gap, cluster,
    # restart_threshold, greedy_S, greedy_shrink, stream
    "qstream_burst": [_vp] * 19 + [_i, _ll, _i, _i, _i, _i, _i, _f, _f, _f, _vp],
    # n: the Q-streaming engine's cluster size; (n, C): a CTA's shared bytes,
    # the clusters the card holds at once
    "qstream_cluster_size": [_i],
    "qstream_smem_bytes": [_i, _i],
    "qstream_active_clusters": [_i, _i],
    # Q, v0, hist, n, B, n_iter, Q's strides (si, sj, sb), cluster, stream
    "lipschitz_power": [_vp] * 3 + [_i, _ll, _i, _ll, _ll, _ll, _i, _vp],
    # n: the power kernel's cluster size
    "lipschitz_cluster_size": [_i],
    # n: the resident kernel's lanes per CTA on the current device
    "resident_group": [_i],
    "gram_pairs_smem_bytes": [],
    # B, A, b
    "gram_pairs_copy_bytes": [_ll, _vp, _vp],
    "stream_copy_bytes": [_ll, _vp, _vp],
    # n: the burst kernel's lanes per CTA, their shared bytes and the CTAs an SM
    # of the current device holds; (n, B): the floats of a solve's slab
    "fista_burst_group": [_i],
    "fista_burst_smem_bytes": [_i],
    "fista_burst_ctas_per_sm": [_i],
    "fista_burst_slab_floats": [_i, _ll],
    "fos_cuda_error_string": [_i],
}
_RESTYPES = {"fos_cuda_error_string": ctypes.c_char_p,
             "gram_pairs_smem_bytes": _ll,
             "gram_power_smem_bytes": _ll,
             "fista_burst_smem_bytes": _ll,
             "fista_burst_slab_floats": _ll,
             "qstream_smem_bytes": _ll}  # the rest return int

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


def _digest(csrc: Path = CSRC) -> str:
    """The build's name: a hash of the flags and of every file under ``csrc``
    (the sources and the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, extra in SOURCES.items():
        h.update(name.encode() + " ".join(extra).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, tmpdir: str) -> tuple[list[str], str]:
    """One ``nvcc -c`` per source, all running at once; returns the object
    paths and the compilers' output. Raises if any compile fails."""
    procs = []
    for name, extra in SOURCES.items():
        obj = os.path.join(tmpdir, name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, str(CSRC / name)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for cmd, _, proc in procs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [obj for _, obj, _ in procs], log


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
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs, out = _compile(nvcc, tmpdir)
            tmp = os.path.join(tmpdir, "lib.so")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            log.write_text(out + proc.stdout + proc.stderr)
            os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
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


def check_tensors(floats, ints=()) -> None:
    """Raise unless each ``(name, tensor)`` of ``floats`` is a contiguous
    float32 CUDA tensor and each of ``ints`` a contiguous int32 one, all on
    the device of the first: the kernels read them through raw pointers."""
    anchor, first = floats[0]
    for dtype, named in ((torch.float32, floats), (torch.int32, ints)):
        for name, v in named:
            if (not isinstance(v, torch.Tensor) or not v.is_cuda or v.dtype != dtype
                    or not v.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous "
                                 f"{str(dtype).removeprefix('torch.')} CUDA tensor")
            if v.device != first.device:
                raise ValueError(f"{name} is on {v.device}, {anchor} on {first.device}")


def mode_args(restart_threshold, greedy, armijo):
    """The momentum mode as the C entries read it: ``(mode, restart,
    greedy_S, greedy_shrink, armijo_c, armijo_eta, max_backtracks)``, mode 0
    the fixed β table, 1 adaptive restart, 2 greedy; a mode's unused values
    are zero."""
    mode = 2 if greedy is not None else (0 if restart_threshold is None else 1)
    S, shrink = greedy if greedy is not None else (0.0, 0.0)
    C, eta, max_bt = armijo if armijo is not None else (0.0, 0.0, 0)
    return mode, float(restart_threshold or 0.0), S, shrink, C, eta, max_bt


def call(name: str, device, *args) -> None:
    """Call the C entry ``name`` on ``device``'s current stream: each tensor
    goes as its data pointer, None as a null pointer, anything else as it
    is. Raises on the CUDA error the entry returns."""
    args = [v.data_ptr() if isinstance(v, torch.Tensor) else v for v in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args, stream)
    check(err, name)


def refuse_interpret(interpret: bool, on_cuda: bool) -> None:
    """``interpret=True`` asks for the plain twins, which run on a CPU
    tensor: raise when it comes with a CUDA one."""
    if interpret and on_cuda:
        raise ValueError("interpret=True runs the plain twin on a CPU tensor; "
                         "the input is a CUDA tensor")
