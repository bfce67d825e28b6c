"""Beyond-device-memory lasso benchmark (port of
``fastoptsolver_tpu/bench/streaming_lasso.py``): one-pass streamed Gram and
a certified solve on the device.

Host-generated row chunks stream through the device once and are reduced to
Q = AᵀA, c = Aᵀb, bᵀb (``problems/streaming.py``); the certified FISTA then
runs on the device at O(n²) an iteration (``solvers/gram_dense.py``). A is
never resident: the device holds Q, its compensation, one chunk's product
and the ring's ``prefetch`` chunks.

The data are the reference's, bit for bit (NumPy on both sides): chunk i
from ``SFC64(seed·1_000_003 + i)``, x_true from ``default_rng(seed)``,
pre-generated into host RAM by two threads, untimed. On a CUDA device the
pass and the solve are timed on the host clock after
``torch.cuda.synchronize()``; beside the reference's keys the record has:

- ``device``: the card's name and power limit (nvidia-smi), or ``cpu``;
- ``link_ceiling_gbps``: a copy of one chunk from a pinned buffer to the
  device, no math, repeated in the same process (CUDA events), and
  ``stream_pct_of_link``, the pass's rate over it;
- ``host_copy_gbps``: the rate of the host's cast of chunks into a pinned
  buffer, the pass's other stage;
- ``solve_setup_s``, the solve's power loop and float64 up-cast (one
  more call with ``max_iter=0``), and ``solve_us_per_iter``, the rest of
  the solve over its iterations, with its bound, Q's bytes an iteration
  over 3.35 TB/s (``solve_bound_by`` says whether Q fits in the 50 MB L2,
  where the card can serve it faster; no L2 rate is published);
- ``exceeds_hbm``: A's bytes against the card's own memory (null on the
  CPU).

Default: m=2²¹, n=1280 → A = 10.7 GB streamed, Q = 6.6 MB solved.
North-star width: --m 1000000 --n 10000 (40 GB, Q = 400 MB).

CLI (one JSON line, on the card):
    python -m fastoptsolver_tpu_torch.bench.streaming_lasso [--m M] [--n N]
        [--chunk-rows R] [--tol 1e-6]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # the H100 SXM's data-sheet memory rate
L2_BYTES = 50 * 2 ** 20  # the H100's L2
LINK_REPS = 10  # copies a link-ceiling measurement times
HOST_COPY_CHUNKS = 8  # chunks the host-copy rate is measured over


class StreamingRun(NamedTuple):
    record: dict  # the JSON record
    chunks: list  # the host chunks (A_i, b_i)
    gram: object  # the streamed DenseGram
    result: object  # the timed solve's DenseResult
    alpha1: float


def make_chunks(m: int, n: int, chunk_rows_n: int, seed: int = 0):
    """The reference's chunk recipe: ``(make_chunk, n_chunks)``, chunk i
    ``(rows, n)`` float32 from ``SFC64(seed·1_000_003 + i)`` with b = A
    x_true + 0.1·noise, x_true 5% nonzero from ``default_rng(seed)``."""
    n_chunks = -(-m // chunk_rows_n)
    x_true = np.zeros(n, np.float32)
    rng0 = np.random.default_rng(seed)
    idx = rng0.choice(n, size=max(1, n // 20), replace=False)
    x_true[idx] = (rng0.normal(size=idx.size) * 3.0).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(n))

    def make_chunk(i: int):
        rows = min(chunk_rows_n, m - i * chunk_rows_n)
        # SFC64: fastest numpy bit generator; chunk-seeded → reproducible
        rng = np.random.Generator(np.random.SFC64(seed * 1_000_003 + i))
        A_i = rng.standard_normal((rows, n), dtype=np.float32)
        A_i *= scale
        b_i = A_i @ x_true + 0.1 * rng.standard_normal(rows, dtype=np.float32)
        return A_i, b_i

    return make_chunk, n_chunks


def _link_ceiling_gbps(A_i: np.ndarray, device) -> float:
    """Best rate of a pinned-buffer → device copy of one chunk, no math."""
    host = torch.empty(A_i.shape, dtype=torch.float32, pin_memory=True)
    host.numpy()[:] = A_i
    dev = torch.empty(A_i.shape, dtype=torch.float32, device=device)
    dev.copy_(host, non_blocking=True)  # warm
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LINK_REPS):
            dev.copy_(host, non_blocking=True)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3 / LINK_REPS)
    return host.numel() * 4 / best / 1e9


def _host_copy_gbps(chunks, pinned: bool) -> float:
    """Rate of the feed's host stage: casting chunks into one (pinned on a
    card) buffer, over the first few chunks."""
    some = chunks[:HOST_COPY_CHUNKS]
    rows = max(A.shape[0] for A, _ in some)
    buf = torch.empty((rows, some[0][0].shape[1]), dtype=torch.float32,
                      pin_memory=pinned).numpy()
    t0 = time.perf_counter()
    for A_i, _ in some:
        buf[:A_i.shape[0]] = A_i
    return sum(A.size for A, _ in some) * 4 / (time.perf_counter() - t0) / 1e9


def measure(m: int, n: int, chunk_rows_n: int, tol: float, seed: int = 0,
            device=None) -> StreamingRun:
    """The benchmark: the record, with the chunks, the Gram and the timed
    solve (``run`` returns the record alone)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..problems import stream_gram
    from ..problems.base import target_device
    from ..solvers import DenseGramConfig, fista_gram_dense
    from .wide_n import _power_limit

    device = target_device(device)
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda else (lambda: None)
    make_chunk, n_chunks = make_chunks(m, n, chunk_rows_n, seed)
    # Pre-generate into host RAM (untimed, threaded, as bench.py excludes data
    # generation; a real deployment reads A from storage). Host RAM holds A;
    # the device never does.
    with ThreadPoolExecutor(max_workers=2) as ex:
        chunks = list(ex.map(make_chunk, range(n_chunks)))

    stream_gram(chunks[:1], n=n, device=device)  # warm: buffers, cuBLAS
    sync()
    t0 = time.perf_counter()
    gram = stream_gram(iter(chunks), n=n, device=device)
    sync()
    stream_s = time.perf_counter() - t0

    a1 = 0.1 * float(torch.max(torch.abs(gram.c)))
    cfg = DenseGramConfig(max_iter=3000, check_every=100, rel_gap_tol=tol)
    res = fista_gram_dense(gram, a1, 0.0, cfg)  # warm
    nnz = float(torch.mean((torch.abs(res.x) > 0).to(torch.float32)))
    sync()
    t0 = time.perf_counter()
    res = fista_gram_dense(gram, a1, 0.0, cfg)
    sync()
    solve_s = time.perf_counter() - t0
    iters = int(res.iters)
    # the solve's set-up alone: the power loop and the float64 up-cast
    t0 = time.perf_counter()
    fista_gram_dense(gram, a1, 0.0, dataclasses.replace(cfg, max_iter=0))
    sync()
    setup_s = time.perf_counter() - t0

    a_bytes = m * n * 4.0
    q_bytes = n * n * 4.0
    stream_gbps = a_bytes / stream_s / 1e9
    rec = {
        "m": m,
        "n": n,
        "a_gb": a_bytes / 1e9,
        "exceeds_hbm": (a_bytes > torch.cuda.get_device_properties(device).total_memory
                        if on_cuda else None),
        "chunks": n_chunks,
        "stream_s": stream_s,
        "stream_gbps": stream_gbps,
        "solve_s": solve_s,
        "solve_iters": iters,
        "iters_per_s": iters / solve_s,
        "rel_gap": float(res.rel_gap),
        "converged": bool(res.converged),
        "nnz_frac": nnz,
        "device": _power_limit() if on_cuda else "cpu",
        "link_ceiling_gbps": None,
        "stream_pct_of_link": None,
        "host_copy_gbps": _host_copy_gbps(chunks, pinned=on_cuda),
        "solve_setup_s": setup_s,
        "solve_us_per_iter": (solve_s - setup_s) / iters * 1e6,
        "solve_bound_us_per_iter": None,
        "solve_bound_by": None,
    }
    if on_cuda:
        link = _link_ceiling_gbps(chunks[0][0], device)
        rec["link_ceiling_gbps"] = link
        rec["stream_pct_of_link"] = 100.0 * stream_gbps / link
        rec["solve_bound_by"] = "Q read at 3.35 TB/s; " + (
            "Q fits in the 50 MB L2" if q_bytes <= L2_BYTES else "Q is read from HBM")
        rec["solve_bound_us_per_iter"] = q_bytes / PEAK_BYTES_PER_S * 1e6
    return StreamingRun(rec, chunks, gram, res, a1)


def run(m: int, n: int, chunk_rows_n: int, tol: float, seed: int = 0,
        device=None) -> dict:
    """The benchmark's record (see the module note)."""
    return measure(m, n, chunk_rows_n, tol, seed, device).record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2**21)
    ap.add_argument("--n", type=int, default=1280)
    ap.add_argument("--chunk-rows", type=int, default=65536)
    ap.add_argument("--tol", type=float, default=1e-6)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.m, args.n, args.chunk_rows, args.tol)))


if __name__ == "__main__":
    main()
