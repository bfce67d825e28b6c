"""Out-of-memory design matrices: one-pass streaming Gram reduction (port of
``fastoptsolver_tpu/problems/streaming.py``).

The composite objective touches A only through ``Q = AᵀA`` (n×n), ``c = Aᵀb``
and ``bᵀb``, so a single chunked pass over A accumulates those on the
device, and the certified solve (:mod:`..solvers.gram_dense`) then runs at
O(n²) an iteration, independent of m. For n = 1e4, Q is 400 MB, far smaller
than A; m is bounded by nothing on the device (chunks may come from RAM, an
``np.memmap`` or a generator).

The arithmetic is the reference's: per chunk one f32 ``A_iᵀA_i``, ``A_iᵀb_i``
and ``b_i·b_i`` (the package pins "highest" matmul precision at import, so
no TF32), then a Kahan step into each accumulator in the order
``y = delta − comp; t = acc + y; comp = (t − acc) − y; acc = t``. Eager torch
does not reassociate, so the reference's ``optimization_barrier`` has no
counterpart here; do not ``torch.compile`` :func:`_kahan`.

The feed, which ``jax.device_put`` hid in the reference, is written out on a
CUDA device:

- a ring of ``prefetch`` pinned host buffers, each sized to the largest
  chunk that has used it; a chunk is cast into its slot by NumPy
  (``pinned.numpy()[:rows] = chunk``: float64 → float32 in the same pass,
  and a read-only ``np.memmap`` needs no copy first);
- ``copy_(non_blocking=True)`` of the slot into the slot's device buffer on
  a side stream, after an event that says the compute stream has finished
  with that device buffer; the compute stream waits on the copy's event;
- the host waits on the copy's event before it casts the next chunk into the
  same pinned buffer, so a buffer is never overwritten while its copy is in
  flight.

Resident on the device: Q, its compensation and one chunk's ``A_iᵀA_i``
(3·n²·4 bytes, 1.2 GB at n = 10000, as the reference's donated
accumulators and the product keep it), the vectors, and ``prefetch`` device
chunk buffers. On the CPU the same loop runs with plain host buffers and no
stream.

``merge_grams`` (the reference's row-distributed merge across hosts) needs a
process group and comes with the port of ``parallel/``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from ..utils.pytree import register_dataclass
from .base import target_device


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseGram:
    """Gram form of one (possibly enormous) least-squares instance."""

    Q: torch.Tensor  # (n, n) — AᵀA
    c: torch.Tensor  # (n,)   — Aᵀb
    btb: torch.Tensor  # ()   — bᵀb
    m: torch.Tensor  # ()     — rows reduced, int64 (informational)

    @property
    def dim(self) -> int:
        return self.Q.shape[0]


def _kahan(acc: torch.Tensor, comp: torch.Tensor, delta: torch.Tensor) -> None:
    """``acc += delta`` with the running rounding error carried in ``comp``,
    in place: ``y = delta − comp; t = acc + y; comp = (t − acc) − y;
    acc = t``. ``delta`` is consumed (it holds ``y`` afterwards), so the step
    needs no temporary of acc's size. The stored sum stays within about one
    rounding of the true sum whatever the number of chunks."""
    y = delta.sub_(comp)
    comp.copy_(acc)  # the old acc
    acc.add_(y)  # t
    torch.sub(acc, comp, out=comp)  # t − acc
    comp.sub_(y)


class _Feed:
    """The ring of ``prefetch`` slots: a host buffer (pinned on a CUDA
    device) and a device buffer each, grown to the largest chunk that used
    the slot, with the events that order their reuse."""

    def __init__(self, n: int, dtype: torch.dtype, device: torch.device, prefetch: int):
        self.n, self.dtype, self.device = n, dtype, device
        self.np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.cuda = device.type == "cuda"
        self.slots = max(1, int(prefetch))
        self.host: list = [None] * self.slots  # (A, b) host buffers
        self.dev: list = [None] * self.slots  # (A, b) device buffers
        self.copied = [None] * self.slots  # event: the slot's copy landed
        self.used = [None] * self.slots  # event: the compute stream is done with it
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def _grow(self, s: int, rows: int) -> None:
        if self.host[s] is not None and self.host[s][0].shape[0] >= rows:
            return
        shape = (rows, self.n)
        pin = self.cuda
        self.host[s] = (torch.empty(shape, dtype=self.dtype, pin_memory=pin),
                        torch.empty((rows,), dtype=self.dtype, pin_memory=pin))
        if self.cuda:
            # made on the compute stream: the side stream must not write into
            # a block the compute stream may still read, so it waits for all
            # compute work queued so far; the block's free waits for the copies
            self.dev[s] = (torch.empty(shape, dtype=self.dtype, device=self.device),
                           torch.empty((rows,), dtype=self.dtype, device=self.device))
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for t in self.dev[s]:
                t.record_stream(self.stream)
        else:
            self.dev[s] = self.host[s]

    def put(self, i: int, A_i, b_i) -> tuple[torch.Tensor, torch.Tensor]:
        """Cast chunk ``i`` into its slot and start its copy; returns the
        device views the compute stream may read once :meth:`wait` ran."""
        rows = A_i.shape[0]
        s = i % self.slots
        if self.copied[s] is not None:
            self.copied[s].synchronize()  # the slot's last copy has landed
        self._grow(s, rows)
        hA, hb = self.host[s]
        hA.numpy()[:rows] = A_i
        hb.numpy()[:rows] = b_i
        dA, db = self.dev[s]
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if self.used[s] is not None:
                    self.stream.wait_event(self.used[s])
                dA[:rows].copy_(hA[:rows], non_blocking=True)
                db[:rows].copy_(hb[:rows], non_blocking=True)
                self.copied[s] = torch.cuda.Event()
                self.copied[s].record(self.stream)
        return dA[:rows], db[:rows]

    def wait(self, i: int) -> None:
        """The compute stream waits for chunk ``i``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.copied[i % self.slots])

    def done(self, i: int) -> None:
        """Record that the compute stream has queued its last read of chunk
        ``i``'s device buffer."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.used[i % self.slots] = ev


def stream_gram(
    chunks: Iterable[tuple[np.ndarray, np.ndarray]],
    n: int,
    dtype: torch.dtype = torch.float32,
    prefetch: int = 2,
    device=None,
) -> DenseGram:
    """Reduce an iterable of host ``(A_chunk (mᵢ, n), b_chunk (mᵢ,))`` pairs
    to the Gram form on ``device`` (default: the current CUDA device; pass
    ``device="cpu"`` for the CPU) in one streaming pass.

    Up to ``prefetch`` chunks are in the ring at once: while the device
    reduces chunk i, chunks i+1 … i+prefetch−1 are cast on the host and
    copied on a side stream (see the module note). Chunks may have any row
    counts; a slot grows when a larger chunk arrives. The result is the same
    bits for every ``prefetch``."""
    device = target_device(device)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    Q, Qc, dQ = z(n, n), z(n, n), z(n, n)
    c, cc, btb, bc = z(n), z(n), z(), z()
    m = torch.zeros((), dtype=torch.int64, device=device)
    feed = _Feed(n, dtype, device, prefetch)
    queued: list[tuple[int, torch.Tensor, torch.Tensor]] = []

    def reduce(i, A_i, b_i):
        feed.wait(i)
        torch.matmul(A_i.T, A_i, out=dQ)
        _kahan(Q, Qc, dQ)
        _kahan(c, cc, torch.matmul(A_i.T, b_i))
        _kahan(btb, bc, torch.dot(b_i, b_i))
        m.add_(A_i.shape[0])
        feed.done(i)

    for i, (A_i, b_i) in enumerate(chunks):
        if A_i.ndim != 2 or A_i.shape[1] != n:
            raise ValueError(f"chunk has {A_i.shape[-1]} features, expected {n}")
        if np.shape(b_i) != (A_i.shape[0],):
            raise ValueError(f"chunk's b has shape {np.shape(b_i)}, expected "
                             f"({A_i.shape[0]},)")
        if len(queued) == feed.slots:
            reduce(*queued.pop(0))
        queued.append((i, *feed.put(i, A_i, b_i)))
    for item in queued:
        reduce(*item)
    return DenseGram(Q=Q, c=c, btb=btb, m=m)


def chunk_rows(A, b, rows: int) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Row-chunk views over array-likes supporting 2-D slicing: NumPy
    arrays, ``np.memmap`` (out-of-core from disk), h5py datasets, … Views,
    not copies: the host array is never duplicated."""
    m = A.shape[0]
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        yield A[lo:hi], b[lo:hi]


def generator_chunks(
    make_chunk: Callable[[int], tuple[np.ndarray, np.ndarray]], n_chunks: int
) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Chunks produced on demand (seeded generators): the full A never
    exists anywhere, on the device or in host RAM."""
    for i in range(n_chunks):
        yield make_chunk(i)
