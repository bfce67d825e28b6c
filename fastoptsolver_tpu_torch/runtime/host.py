"""ctypes bindings for the native host runtime (``native/fastopt_host.cpp``)
and the double-buffered scenario loader (port of
``fastoptsolver_tpu/runtime/host.py``, which cannot be imported here: its
package's ``__init__`` imports JAX).

The native library is optional: every entry point has a NumPy fallback with
the same semantics, so the port works unbuilt. :func:`ensure_built`
compiles the repo's ``native/fastopt_host.cpp`` on demand with g++ and the
flags of ``native/Makefile`` into ``fastoptsolver_tpu_torch/_build/``,
never into ``native/``. The library is named by a hash of the source, the
flags and the host's name (``-march=native`` ties a build to its machine's
CPU), and written under a private name and renamed, so processes that build
at once never load a half-written file.

The loader is the data plane on the host: host threads generate and
Gram-precompute scenario batch i+1 (C++, all cores) while the device solves
batch i. NumPy in, NumPy out, as the reference; the consumer moves each
batch to the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from queue import Queue

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastopt_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS + (platform.node(),)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastopt_host_{h.hexdigest()[:16]}.so"


def ensure_built(force: bool = False):
    """Build the host library if this source has no build yet; return the
    loaded library, or None when the source or a toolchain is missing."""
    global _lib
    if _lib is not None and not force:
        return _lib
    if not SOURCE.is_file():
        return None
    so = _lib_path()
    if force or not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(["g++", *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fastopt_generate_scenarios.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p, f32p,
    ]
    lib.fastopt_generate_scenarios.restype = None
    lib.fastopt_standardize.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fastopt_standardize.restype = None
    lib.fastopt_gram_batch.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
    ]
    lib.fastopt_gram_batch.restype = None
    lib.fastopt_version.argtypes = []
    lib.fastopt_version.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return ensure_built() is not None


def _bc(v, batch):
    return np.ascontiguousarray(np.broadcast_to(np.asarray(v, np.float32), (batch,)))


def generate_scenarios_host(
    seed: int, batch: int, m: int, noise_std=2.0, rho1=0.8, rho2=0.9
):
    """Batched Boston-like generation on host threads (C++; NumPy fallback).

    Returns ``(A, b)`` float32 of shapes (batch, m, 5), (batch, m).
    """
    noise, r1, r2 = _bc(noise_std, batch), _bc(rho1, batch), _bc(rho2, batch)
    A = np.empty((batch, m, 5), np.float32)
    b = np.empty((batch, m), np.float32)
    lib = ensure_built()
    if lib is not None:
        lib.fastopt_generate_scenarios(seed, batch, m, noise, r1, r2, A, b)
        return A, b
    # NumPy fallback, same statistics
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((batch, m, 6))
    A[..., 0] = 6.0 + 0.5 * z[..., 0]
    A[..., 1] = 0.2 + 0.5 * (r1[:, None] * z[..., 0] + np.sqrt(1 - r1[:, None] ** 2) * z[..., 1])
    A[..., 2] = 300.0 + 10.0 * z[..., 2]
    A[..., 3] = 60.0 + 10.0 * (r2[:, None] * z[..., 2] + np.sqrt(1 - r2[:, None] ** 2) * z[..., 3])
    A[..., 4] = 4.0 + z[..., 4]
    x_true = np.array([5.0, 0.0, -0.02, -0.05, 1.5], np.float32)
    b[:] = A @ x_true + noise[:, None] * z[..., 5]
    return A, b


def standardize_host(A: np.ndarray) -> np.ndarray:
    """In-place per-instance column standardization (C++; NumPy fallback)."""
    lib = ensure_built()
    A = np.ascontiguousarray(A, np.float32)
    if lib is not None:
        lib.fastopt_standardize(A, A.shape[0], A.shape[1], A.shape[2])
        return A
    mu = A.mean(axis=1, keepdims=True)
    sd = A.std(axis=1, keepdims=True)
    sd[sd == 0] = 1.0
    A -= mu
    A /= sd
    return A


def gram_batch_host(A: np.ndarray, b: np.ndarray):
    """Batched Gram precompute on host (C++; NumPy fallback).

    Returns ``(Q, c, btb)`` with batch-major shapes (B, n, n), (B, n), (B,)
    — transpose to the device's feature-major layout with
    ``Q.permute(1, 2, 0)`` / ``c.T`` when building a GramBatch directly.
    """
    A = np.ascontiguousarray(A, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    B, m, n = A.shape
    Q = np.empty((B, n, n), np.float32)
    c = np.empty((B, n), np.float32)
    btb = np.empty((B,), np.float32)
    lib = ensure_built()
    if lib is not None:
        lib.fastopt_gram_batch(A, b, B, m, n, Q, c, btb)
        return Q, c, btb
    Q[:] = np.einsum("bmi,bmj->bij", A, A)
    c[:] = np.einsum("bmi,bm->bi", A, b)
    btb[:] = np.einsum("bm,bm->b", b, b)
    return Q, c, btb


class ScenarioLoader:
    """Double-buffered host-side scenario pipeline.

    Iterates ``n_batches`` batches of ``(A, b)`` (optionally standardized,
    optionally Gram-precomputed), generating batch i+1 on host threads while
    the consumer (the device solve) works on batch i.

    >>> for A, b in ScenarioLoader(seed=0, batch=4096, m=1000, n_batches=10):
    ...     solve(A, b)
    """

    def __init__(
        self,
        seed: int,
        batch: int,
        m: int,
        n_batches: int,
        noise_std=2.0,
        rho1=0.8,
        rho2=0.9,
        standardize: bool = True,
        gram: bool = False,
        prefetch: int = 2,
    ):
        self.n_batches = n_batches
        self._q: Queue = Queue(maxsize=max(1, prefetch))
        self._args = (seed, batch, m, noise_std, rho1, rho2, standardize, gram)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        seed, batch, m, noise_std, rho1, rho2, standardize, gram = self._args
        for i in range(self.n_batches):
            A, b = generate_scenarios_host(seed + i, batch, m, noise_std, rho1, rho2)
            if standardize:
                A = standardize_host(A)
            item = (A, b, *gram_batch_host(A, b)) if gram else (A, b)
            self._q.put(item)
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
