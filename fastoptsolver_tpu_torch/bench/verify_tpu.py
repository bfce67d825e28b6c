"""Kernel verification on the card: each CUDA kernel against the torch driver
(port of ``fastoptsolver_tpu/bench/verify_tpu.py``).

The CPU tests hold every kernel's plain twin against the JAX reference, and
chip_smoke holds each kernel against its twin on the card. This module holds
the kernels, launched with ``interpret=False`` on CUDA tensors, against the
*driver* (``batch/fista_gram.py``: ``make_gram_batch`` + ``fista_gram_batch``)
or against float64 NumPy, at the reference's small shapes and tolerances. A
kernel and its twin that agree on the wrong recipe pass the first hold and
fail this one.

The checks keep the reference's names and order (``CHECKS``):

  1. fixed-iteration, FISTA-Δ and adaptive-restart trajectories (burst kernel)
  2. the certified burst loop (flags, gaps, per-instance iters on the
     cadence) and a 30 + 30 resume bit-equal to 60 straight
  3. the adaptive entry (the resident kernel): the burst loop's iters
  4. the Gram build (``gram_pairs`` + ``gram_power``) against float64, at
     n = 5 and at n = 20 / 64 with ragged m (the row masking)
  5. the fused single-launch solve in every mode, its Armijo and its resume
  6. greedy momentum and Armijo in the burst kernel (decisive regime)
  7. wide problems n = 20 / 64 / 96, both paths certified and rechecked in
     float64; the Q-streaming engine at n = 208 and its resume; the
     resident engine at n = 144, its Armijo and resume, and its ceiling
     n = 168
  8. the sharded burst engine on a one-rank mesh (``sharded_mosaic``)
  9. ``f64_certificate``: the dense solve's float64 duality gap
     (``solvers.gram_dense._rel_gap_dense``) on the card against the same
     call on the CPU and against NumPy, at n = 1280 (the reference's
     ``df32_efts`` check of its double-f32 arithmetic; the port computes
     that certificate in float64)

``check`` records ``False`` on an ``AssertionError`` and goes on; any other
exception propagates, except in ``resident_ceiling_n168``, where a build or
launch failure at the window's edge is that check's failure, as in the
reference. Every check also records its readings: each measured deviation
beside its limit.

On the card by default (``run(device=None)`` raises without one); on a CPU
tensor every kernel entry runs its plain twin, which is how the CPU tests
run these checks.

Usage (prints one JSON line, exits 1 if any check fails):
  python -m fastoptsolver_tpu_torch.bench.verify_tpu [--device cpu] [--check NAME ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json

import numpy as np
import torch

from ..batch import fista_gram as driver
from ..batch.fista_gram import BatchFISTAConfig
from ..kernels import fista_vmem, fused_solve, gram_build, resident
from ..problems.base import target_device


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Readings: each hold records what it measured beside its limit, then asserts
# ---------------------------------------------------------------------------


def _reading(out: dict, label: str, value, op: str, limit, note: str | None = None) -> None:
    out[label] = {"value": value, "op": op, "limit": limit}
    if note:
        out[label]["note"] = note


def _le(out: dict, label: str, value, limit, strict: bool = False) -> None:
    value = float(value)
    _reading(out, label, value, "<" if strict else "<=", float(limit))
    assert value < limit if strict else value <= limit, f"{label} {value:.3e} > {limit:.3e}"


def _ge(out: dict, label: str, value, limit, strict: bool = False) -> None:
    value = float(value)
    _reading(out, label, value, ">" if strict else ">=", float(limit))
    assert value > limit if strict else value >= limit, f"{label} {value:.3e} < {limit:.3e}"


def _true(out: dict, label: str, cond) -> None:
    _reading(out, label, bool(cond), "==", True)
    assert bool(cond), label


def _close(out: dict, label: str, got, ref, rtol: float, atol: float) -> None:
    """``np.testing.assert_allclose(got, ref, rtol, atol)`` as a reading: the
    largest ``|got − ref| / (atol + rtol·|ref|)``, which is ≤ 1 where it
    passes, noted with the largest ``|got − ref|``."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    d = np.abs(got - ref)
    _reading(out, f"{label} |d|/(atol + rtol·|ref|)", _ratio(got, ref, rtol, atol), "<=", 1.0,
             f"max|d| {float(d.max()) if d.size else 0.0:.3e}, rtol {rtol:g}, atol {atol:g}")
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=label)


def _ratio(got, ref, rtol: float, atol: float) -> float:
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    return float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max()) if got.size else 0.0


def _equal(out: dict, label: str, got, ref) -> None:
    got, ref = _np(got), _np(ref)
    d = (float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
         if got.shape == ref.shape and got.size else float("inf"))
    _reading(out, f"{label} max|d|", d, "==", 0.0, "bit for bit")
    np.testing.assert_array_equal(got, ref, err_msg=label)


def _within(out: dict, label: str, values, lo: float, hi: float) -> None:
    """Every value strictly inside (lo, hi)."""
    values = _np(values)
    _reading(out, label, [float(values.min()), float(values.max())], "in", [lo, hi])
    assert np.all(values > lo) and np.all(values < hi), (
        f"{label} [{values.min():.3f}, {values.max():.3f}] not in ({lo}, {hi})")


# ---------------------------------------------------------------------------
# Inputs, made once per run and shared by the checks that use them
# ---------------------------------------------------------------------------


def _scenario_batch(n_inst: int, m: int, device):
    from ..problems import generate_boston_like

    As, bs = [], []
    for s in range(n_inst):
        A, b, _ = generate_boston_like(m=m, seed=s, noise_std=1.0, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        As.append(A)
        bs.append(b)
    f32 = lambda x: torch.from_numpy(np.stack(x).astype(np.float32)).to(device)
    return f32(As), f32(bs)


def _f64_gap_obj(A, b, a1, X):
    """Relative duality gap and objective of lasso solutions ``X`` (B, n) on
    the raw ``(A (B, m, n), b (B, m))`` in float64 NumPy, independent of the
    Gram form the solvers certify."""
    A64, b64 = _np(A).astype(np.float64), _np(b).astype(np.float64)
    a64, X64 = _np(a1).astype(np.float64), _np(X).astype(np.float64)
    r = np.einsum("bmn,bn->bm", A64, X64) - b64
    p = 0.5 * np.sum(r * r, 1) + a64 * np.abs(X64).sum(1)
    s = np.max(np.abs(np.einsum("bmn,bm->bn", A64, r)), axis=1)
    scale = np.minimum(1.0, a64 / np.maximum(s, 1e-300))
    u = scale[:, None] * r
    d = -0.5 * np.sum(u * u, 1) - np.sum(u * b64, 1)
    return (p - d) / np.maximum(p, 1.0), p


class Inputs:
    """The reference's shapes on ``device``, each made on first use."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cfg_fixed = BatchFISTAConfig(max_iter=60, check_every=0)
        self.cfg_c = BatchFISTAConfig(max_iter=800, check_every=25, rel_gap_tol=1e-6)
        self.cfg_f1 = BatchFISTAConfig(max_iter=2000, check_every=25, rel_gap_tol=5e-6)
        self.cfg_wide = BatchFISTAConfig(max_iter=2000, check_every=50, rel_gap_tol=5e-6)

    def _t(self, x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    @functools.cached_property
    def scenarios(self):
        """8 standardized scenarios at m = 200: ``(A (8, m, 5), b (8, m))``."""
        return _scenario_batch(n_inst=8, m=200, device=self.device)

    @functools.cached_property
    def gb(self):
        A3, b2 = self.scenarios
        return driver.make_gram_batch(A3, b2, alpha1=0.5, alpha2=0.0)

    @functools.cached_property
    def got_fixed(self):
        return fista_vmem.fista_gram_vmem(self.gb, self.cfg_fixed, b_tile=128,
                                          interpret=False)

    @functools.cached_property
    def gbc(self):
        A3, b2 = self.scenarios
        a1 = 0.1 * torch.amax(torch.abs(torch.einsum("bmi,bm->bi", A3, b2)), dim=1)
        return driver.make_gram_batch(A3, b2, alpha1=a1, alpha2=0.0)

    @functools.cached_property
    def res_c(self):
        return fista_vmem.fista_gram_vmem(self.gbc, self.cfg_c, b_tile=128,
                                          interpret=False)

    @functools.cached_property
    def fm_build(self):
        """(n, m, B) = (5, 120, 384) feature-leading data and its float64
        Gram: ``(A, b, Q64, c64)``."""
        rng = np.random.default_rng(0)
        Afm = rng.normal(size=(5, 120, 384)).astype(np.float32)
        bfm = rng.normal(size=(120, 384)).astype(np.float32)
        A64 = Afm.astype(np.float64)
        Q64 = np.einsum("imb,jmb->ijb", A64, A64)
        c64 = np.einsum("imb,mb->ib", A64, bfm.astype(np.float64))
        return self._t(Afm), self._t(bfm), Q64, c64

    @functools.cached_property
    def gb_f(self):
        Afm, bfm, _, _ = self.fm_build
        return gram_build.make_gram_batch_fused(Afm, bfm, alpha1=0.5, alpha2=0.1,
                                                interpret=False)

    @functools.cached_property
    def fused_data(self):
        """(5, 250, 384): ragged row bricks and a batch that is no multiple
        of the lane tile; ``(A, b, α₁)``."""
        rng = np.random.default_rng(42)
        Aff = self._t(rng.normal(size=(5, 250, 384)))
        bff = self._t(rng.normal(size=(250, 384)))
        a1f = 0.1 * torch.amax(torch.abs(torch.einsum("nmb,mb->nb", Aff, bff)), dim=0)
        return Aff, bff, a1f

    @functools.lru_cache(maxsize=None)
    def wide_problem(self, n: int):
        """The Q-streaming and resident checks' recipe at width ``n``:
        ``(A (256, 2n, n), b, α₁, GramBatch)``."""
        rng = np.random.default_rng(n)
        A = self._t(rng.normal(size=(256, 2 * n, n)) / np.sqrt(n))
        xt = np.zeros((256, n), np.float32)
        xt[:, : n // 8] = rng.normal(size=(256, n // 8))
        b = torch.einsum("bmn,bn->bm", A, self._t(xt))
        a1 = 0.1 * torch.amax(torch.abs(torch.einsum("bmi,bm->bi", A, b)), dim=1)
        return A, b, a1, driver.make_gram_batch(A, b, alpha1=a1, alpha2=0.0)


# ---------------------------------------------------------------------------
# The checks, in the reference's order
# ---------------------------------------------------------------------------


def _trajectory(ctx: Inputs, out: dict, cfg) -> None:
    ref = driver.fista_gram_batch(ctx.gb, cfg)
    got = fista_vmem.fista_gram_vmem(ctx.gb, cfg, b_tile=128, interpret=False)
    _close(out, "x", got.x, ref.x, rtol=2e-4, atol=2e-5)


def fixed_iters(ctx: Inputs, out: dict) -> None:
    """60 fixed Nesterov iterations: the burst kernel against the driver."""
    ref = driver.fista_gram_batch(ctx.gb, ctx.cfg_fixed)
    _close(out, "x", ctx.got_fixed.x, ref.x, rtol=2e-4, atol=2e-5)


def delta_momentum(ctx: Inputs, out: dict) -> None:
    _trajectory(ctx, out, BatchFISTAConfig(max_iter=50, check_every=0, momentum="delta",
                                    delta=3.0))


def adaptive_restart(ctx: Inputs, out: dict) -> None:
    """In-kernel adaptive restart (per-lane t/ps rows)."""
    _trajectory(ctx, out, BatchFISTAConfig(max_iter=60, check_every=0, adaptive_restart=True))


def certified_bursts(ctx: Inputs, out: dict) -> None:
    res = ctx.res_c
    _le(out, "lanes not certified", int((~res.converged).sum()), 0)
    _le(out, "max rel_gap", float(res.rel_gap.max()), 1e-6)
    _le(out, "iters off the 25 cadence", int((res.iters % 25 != 0).sum()), 0)


def kernel_resume(ctx: Inputs, out: dict) -> None:
    """30 iterations, resumed to 60: the straight 60-iteration run's bits."""
    _, mid = fista_vmem.fista_gram_vmem(ctx.gb, BatchFISTAConfig(max_iter=30, check_every=0),
                                        b_tile=128, interpret=False, return_state=True)
    resumed = fista_vmem.fista_gram_vmem(ctx.gb, ctx.cfg_fixed, b_tile=128,
                                         interpret=False, state0=mid)
    _equal(out, "x", resumed.x, ctx.got_fixed.x)


def adaptive_kernel(ctx: Inputs, out: dict) -> None:
    """The adaptive entry (one resident launch): the burst loop's cadence,
    so the same iteration counts, and its x."""
    res_a = fista_vmem.fista_gram_vmem_adaptive(ctx.gbc, ctx.cfg_c, interpret=False)
    _le(out, "lanes not certified", int((~res_a.converged).sum()), 0)
    _equal(out, "iters", res_a.iters, ctx.res_c.iters)
    _close(out, "x", res_a.x, ctx.res_c.x, rtol=2e-4, atol=2e-5)


def fused_gram_build(ctx: Inputs, out: dict) -> None:
    """The build kernels against float64 NumPy, and the driver's einsum build
    too (the arbiter if the two disagree is float64)."""
    Afm, bfm, Q64, c64 = ctx.fm_build
    gb_x = driver.make_gram_batch(Afm.permute(2, 1, 0), bfm.T, alpha1=0.5, alpha2=0.1)
    _close(out, "Q kernel", ctx.gb_f.Q, Q64, rtol=2e-4, atol=1e-4)
    _close(out, "Q driver", gb_x.Q, Q64, rtol=2e-4, atol=1e-4)
    _close(out, "c kernel", ctx.gb_f.c, c64, rtol=2e-4, atol=1e-4)
    _within(out, "L kernel/driver", _np(ctx.gb_f.L) / _np(gb_x.L), 0.9, 1.1)


def fused_gram_build_split4(ctx: Inputs, out: dict) -> None:
    """``split_k=4`` against float64 and against ``split_k=1``. The port's
    ``split_k`` selects nothing (one build kernel serves both reference
    variants), so the two builds are held bit for bit."""
    Afm, bfm, Q64, c64 = ctx.fm_build
    kw = dict(alpha1=0.5, alpha2=0.1, interpret=False)
    gb_s4 = gram_build.make_gram_batch_fused(Afm, bfm, split_k=4, **kw)
    gb_s1 = gram_build.make_gram_batch_fused(Afm, bfm, split_k=1, **kw)
    _close(out, "Q", gb_s4.Q, Q64, rtol=2e-4, atol=1e-4)
    _close(out, "c", gb_s4.c, c64, rtol=2e-4, atol=1e-4)
    _within(out, "L split_k=4/default", _np(gb_s4.L) / _np(ctx.gb_f.L), 0.99, 1.01)
    for field in ("Q", "c", "btb", "L"):
        _equal(out, f"{field} split_k=4 vs 1", getattr(gb_s4, field), getattr(gb_s1, field))


def _build_wide(ctx: Inputs, out: dict, n: int, m: int) -> None:
    """The generic-n build at a ragged m (every row brick's last rows masked)
    against float64, and L against the true λ_max."""
    rng = np.random.default_rng(100 + n)
    Afb = rng.normal(size=(n, m, 256)).astype(np.float32)
    bfb = rng.normal(size=(m, 256)).astype(np.float32)
    gb_w = gram_build.make_gram_batch_fused(ctx._t(Afb), ctx._t(bfb), alpha1=0.5,
                                            alpha2=0.0, interpret=False)
    A64 = Afb.astype(np.float64)
    Q64 = np.einsum("imb,jmb->ijb", A64, A64)
    c64 = np.einsum("imb,mb->ib", A64, bfb.astype(np.float64))
    L64 = np.linalg.eigvalsh(Q64.transpose(2, 0, 1)).max(axis=1)
    _close(out, "Q", gb_w.Q, Q64, rtol=2e-4, atol=2e-3)
    _close(out, "c", gb_w.c, c64, rtol=2e-4, atol=2e-3)
    _within(out, "L/(1.02 λmax)", _np(gb_w.L).astype(np.float64) / (1.02 * L64), 0.85, 1.05)


def fused_build_n20(ctx: Inputs, out: dict) -> None:
    _build_wide(ctx, out, 20, 250)


def fused_build_n64(ctx: Inputs, out: dict) -> None:
    _build_wide(ctx, out, 64, 264)


def fused_single_launch(ctx: Inputs, out: dict) -> None:
    """The single-launch build + solve: certified in fixed (default and
    ``overlap=False``), restart and greedy modes, and in objective with the
    two-kernel path (build kernels + burst kernel)."""
    Aff, bff, a1f = ctx.fused_data
    cfg = ctx.cfg_f1
    run = lambda c, **kw: fused_solve.solve_lasso_fused(Aff, bff, a1f, 0.0, cfg=c,
                                                        interpret=False, **kw)
    res_f1 = run(cfg)
    res_f1p = run(cfg, overlap=False)
    res_f1r = run(dataclasses.replace(cfg, adaptive_restart=True))
    res_f1g = run(dataclasses.replace(cfg, momentum="greedy"))
    gb_f1 = gram_build.make_gram_batch_fused(Aff, bff, a1f, 0.0, interpret=False)
    res_f2 = fista_vmem.fista_gram_vmem(gb_f1, cfg, interpret=False)
    for label, r in (("fixed", res_f1), ("fixed overlap=False", res_f1p),
                     ("restart", res_f1r), ("greedy", res_f1g)):
        _le(out, f"{label}: lanes not certified", int((~r.converged).sum()), 0)
    _close(out, "x default vs overlap=False", res_f1.x, res_f1p.x, rtol=1e-4, atol=1e-5)
    A64, b64, a64 = (_np(v).astype(np.float64) for v in (Aff, bff, a1f))

    def obj(x):
        x = _np(x).astype(np.float64)
        r = np.einsum("nmb,nb->mb", A64, x.T) - b64
        return 0.5 * np.sum(r * r, 0) + a64 * np.abs(x).sum(1)

    o1, o2 = obj(res_f1.x), obj(res_f2.x)
    _le(out, "objective fused vs two-kernel (rel)",
        (np.abs(o1 - o2) / np.maximum(o2, 1.0)).max(), 1e-4)


def greedy_momentum(ctx: Inputs, out: dict) -> None:
    """In-kernel greedy momentum (per-lane τ in the state rows)."""
    _trajectory(ctx, out, BatchFISTAConfig(max_iter=60, check_every=0, momentum="greedy"))


def kernel_armijo(ctx: Inputs, out: dict) -> None:
    """In-kernel Armijo in the decisive regime: with L/4 every accept/reject
    call has margin, so the kernel gives the driver's trajectory and its
    per-lane accepted τ."""
    gb_low = dataclasses.replace(ctx.gb, L=ctx.gb.L / 4.0)
    cfg = BatchFISTAConfig(max_iter=5, check_every=0, backtracking=True)
    ref, rs = driver.fista_gram_batch(gb_low, cfg, return_state=True)
    got, gs = fista_vmem.fista_gram_vmem(gb_low, cfg, b_tile=128, interpret=False,
                                         return_state=True)
    _close(out, "x", got.x, ref.x, rtol=2e-4, atol=2e-4)
    tau0 = 4.0 / _np(ctx.gb.L)
    _le(out, "max driver τ/τ0 (the search fired)", (_np(rs.tau) / tau0).max(), 0.9,
        strict=True)
    _close(out, "τ", gs.tau[0], rs.tau, rtol=1e-5, atol=0.0)


def fused_armijo(ctx: Inputs, out: dict) -> None:
    """Fused single-launch Armijo against the two-kernel path (build kernels
    + burst kernel) on the same lanes. The reference's rtol of 2e-3 covers
    its two compilers' rounding of τ = 1/L; here both are CUDA kernels
    built with ``--fmad=false``, and the reading shows how close they are."""
    Aff, bff, a1f = ctx.fused_data
    cfg = BatchFISTAConfig(max_iter=6, check_every=6, rel_gap_tol=1e-6, backtracking=True,
                    t_init_factor=4.0)
    res = fused_solve.solve_lasso_fused(Aff, bff, a1f, 0.0, cfg=cfg, interpret=False,
                                        b_tile=128)
    gb = gram_build.make_gram_batch_fused(Aff, bff, a1f, 0.0, interpret=False, split_k=1)
    ref = fista_vmem.fista_gram_vmem(gb, cfg, b_tile=128, interpret=False)
    _close(out, "x", res.x, ref.x, rtol=2e-3, atol=2e-5)


def fused_resume(ctx: Inputs, out: dict) -> None:
    """Fused-engine resume: 75 iterations cut and resumed to 200 equal the
    straight certified run bit for bit, iteration counts included."""
    Aff, bff, a1f = ctx.fused_data
    cfg = BatchFISTAConfig(max_iter=200, check_every=25, rel_gap_tol=1e-6)
    run = lambda c, **kw: fused_solve.solve_lasso_fused(Aff, bff, a1f, 0.0, cfg=c,
                                                        interpret=False, **kw)
    straight = run(cfg, overlap=False)
    _, mid = run(dataclasses.replace(cfg, max_iter=75), return_state=True)
    resumed = run(cfg, state0=mid)
    _equal(out, "x", resumed.x, straight.x)
    _equal(out, "iters", resumed.iters, straight.iters)


def _certified_pair(out: dict, A, b, a1, ref, got, label: str) -> None:
    """Both solves certified, both certificates real in float64 (4× the solve
    tolerance: the Gram-form gap the solvers certify and the (A, b) gap
    recomputed here differ by f32 Gram rounding), objectives equal."""
    gap_ref, obj_ref = _f64_gap_obj(A, b, a1, ref.x)
    gap_got, obj_got = _f64_gap_obj(A, b, a1, got.x)
    _le(out, "driver: lanes not certified", int((~ref.converged).sum()), 0)
    _le(out, f"{label}: lanes not certified", int((~got.converged).sum()), 0)
    _le(out, "driver f64 gap", gap_ref.max(), 4 * 5e-6)
    _le(out, f"{label} f64 gap", gap_got.max(), 4 * 5e-6)
    _le(out, "objective (rel)", (np.abs(obj_ref - obj_got) / np.maximum(obj_ref, 1.0)).max(),
        1e-4)


def _wide(ctx: Inputs, out: dict, n: int) -> None:
    """Certified solves at the burst engine's wide widths: both paths
    certify, their certificates survive float64, objectives agree (x is not
    held: two certified solves may differ by O(√(gap/λ_min)) a coordinate on
    these ill-conditioned Grams)."""
    rng = np.random.default_rng(n)
    A = ctx._t(rng.normal(size=(256, 4 * n, n)))
    xt = np.zeros((256, n), np.float32)
    xt[:, : n // 4] = rng.normal(size=(256, n // 4))
    b = torch.einsum("bmn,bn->bm", A, ctx._t(xt))
    a1 = 0.1 * torch.amax(torch.abs(torch.einsum("bmi,bm->bi", A, b)), dim=1)
    gb = driver.make_gram_batch(A, b, alpha1=a1, alpha2=0.0)
    ref = driver.fista_gram_batch(gb, ctx.cfg_wide)
    got = fista_vmem.fista_gram_vmem(gb, ctx.cfg_wide, interpret=False)
    _certified_pair(out, A, b, a1, ref, got, "kernel")


def wide_n20(ctx: Inputs, out: dict) -> None:
    _wide(ctx, out, 20)


def wide_n64(ctx: Inputs, out: dict) -> None:
    _wide(ctx, out, 64)


def wide_n96(ctx: Inputs, out: dict) -> None:
    _wide(ctx, out, 96)


def qstream_wide_n(ctx: Inputs, out: dict) -> None:
    """Past the resident window the router picks the Q-streaming engine;
    held to the wide checks' certified contract at n = 208."""
    A, b, a1, gb = ctx.wide_problem(208)
    _true(out, "plan_gram_solve(208) is qstream",
          fista_vmem.plan_gram_solve(208, ctx.cfg_wide)[0] == "qstream")
    ref = driver.fista_gram_batch(gb, ctx.cfg_wide)
    got = fista_vmem.fista_gram_vmem(gb, ctx.cfg_wide, interpret=False)
    _certified_pair(out, A, b, a1, ref, got, "qstream")


def qstream_resume(ctx: Inputs, out: dict) -> None:
    """40 + 60 fixed iterations on the Q-streaming engine equal 100 straight."""
    gb = ctx.wide_problem(208)[3]
    cfg = BatchFISTAConfig(max_iter=100, check_every=0)
    _, mid = fista_vmem.fista_gram_vmem(gb, BatchFISTAConfig(max_iter=40, check_every=0),
                                        interpret=False, return_state=True)
    straight = fista_vmem.fista_gram_vmem(gb, cfg, interpret=False)
    resumed = fista_vmem.fista_gram_vmem(gb, cfg, interpret=False, state0=mid)
    _equal(out, "x", resumed.x, straight.x)


def resident_window(ctx: Inputs, out: dict) -> None:
    """The resident engine at n = 144, where the router sends certified
    configs: certified, float64 recheck, objective against the driver."""
    A, b, a1, gb = ctx.wide_problem(144)
    _true(out, "plan_gram_solve(144) is resident",
          fista_vmem.plan_gram_solve(144, ctx.cfg_wide)[0] == "resident")
    ref = driver.fista_gram_batch(gb, ctx.cfg_wide)
    got = resident.fista_gram_resident(gb, ctx.cfg_wide, interpret=False)
    gap, obj = _f64_gap_obj(A, b, a1, got.x)
    _, obj_ref = _f64_gap_obj(A, b, a1, ref.x)
    _le(out, "lanes not certified", int((~got.converged).sum()), 0)
    _le(out, "f64 gap", gap.max(), 4 * 5e-6)
    _le(out, "objective (rel)", (np.abs(obj_ref - obj) / np.maximum(obj_ref, 1.0)).max(),
        1e-4)


def resident_armijo_resume(ctx: Inputs, out: dict) -> None:
    """Resident Armijo (decisive regime, L/4) against the driver, and a
    75 + 125 resume bit-equal to 200 straight."""
    gb = ctx.wide_problem(144)[3]
    gb_low = dataclasses.replace(gb, L=gb.L / 4.0)
    cfg_a = BatchFISTAConfig(max_iter=5, check_every=5, backtracking=True)
    ref = driver.fista_gram_batch(gb_low, cfg_a)
    got = resident.fista_gram_resident(gb_low, cfg_a, interpret=False)
    cfg = BatchFISTAConfig(max_iter=200, check_every=25, rel_gap_tol=5e-6)
    straight = resident.fista_gram_resident(gb, cfg, interpret=False)
    _, mid = resident.fista_gram_resident(gb, dataclasses.replace(cfg, max_iter=75),
                                          interpret=False, return_state=True)
    resumed = resident.fista_gram_resident(gb, cfg, interpret=False, state0=mid)
    _equal(out, "resumed x", resumed.x, straight.x)
    _close(out, "Armijo x", got.x, ref.x, rtol=2e-3, atol=2e-4)


def armijo_reorder_spread(ctx: Inputs, n: int = 144, perms: int = 3) -> list[float]:
    """``resident_armijo_resume``'s Armijo run (L/4, 5 iterations) on the
    torch driver, against the same run on the same problem with its features
    permuted (reversed, then seeded permutations): for each, the reading that
    check's Armijo hold takes, |d|/(atol + rtol·|ref|) at rtol 2e-3, atol
    2e-4. Above 1, the recurrence cannot hold that tolerance between two
    engines that sum in other orders: its accept test is decided by the f32
    rounding of ½bᵀb once τ has halved ~15 times (iteration 4-5 here)."""
    gb = ctx.wide_problem(n)[3]
    gb_low = dataclasses.replace(gb, L=gb.L / 4.0)
    cfg = BatchFISTAConfig(max_iter=5, check_every=5, backtracking=True)
    ref = driver.fista_gram_batch(gb_low, cfg).x
    spread = []
    for i in range(perms):
        perm = (torch.arange(n - 1, -1, -1) if i == 0
                else torch.randperm(n, generator=torch.Generator().manual_seed(i)))
        perm = perm.to(gb.Q.device)
        gbp = dataclasses.replace(gb_low, Q=gb_low.Q[perm][:, perm].contiguous(),
                                  c=gb_low.c[perm].contiguous())
        xp = driver.fista_gram_batch(gbp, cfg).x
        x = torch.empty_like(xp)
        x[:, perm] = xp
        spread.append(_ratio(x, ref, rtol=2e-3, atol=2e-4))
    return spread


def resident_ceiling_n168(ctx: Inputs, out: dict) -> None:
    """The resident window's edge, n = 168. The solve runs inside the check:
    a build or launch failure there is this check's failure."""
    A, b, a1, gb = ctx.wide_problem(168)
    _true(out, "plan_gram_solve(168) is resident",
          fista_vmem.plan_gram_solve(168, ctx.cfg_wide)[0] == "resident")
    try:
        res = resident.fista_gram_resident(
            gb, BatchFISTAConfig(max_iter=800, check_every=50, rel_gap_tol=5e-6),
            interpret=False)
        conv = _np(res.converged)
    except Exception as e:  # a build or launch failure is the regression
        raise AssertionError(f"n=168 no longer builds or launches: {str(e)[:200]}") from e
    gap, _ = _f64_gap_obj(A, b, a1, res.x)
    _ge(out, "certified share", conv.mean(), 0.9, strict=True)
    _le(out, "f64 gap on certified lanes", gap[conv].max(), 4 * 5e-6)


def sharded_mosaic(ctx: Inputs, out: dict) -> None:
    """The sharded burst engine on a one-rank mesh (NCCL on the card, gloo
    on the CPU): certified and at the unsharded call's x. A process group
    made here is torn down afterwards."""
    import torch.distributed as dist

    from ..parallel import BATCH_AXIS, make_mesh

    own = not dist.is_initialized()
    try:
        mesh = make_mesh(batch=1, model=1, device_type=ctx.device.type)
        res = fista_vmem.fista_gram_vmem_sharded(ctx.gbc, mesh, ctx.cfg_c, axis=BATCH_AXIS,
                                                 b_tile=128, interpret=False)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    _le(out, "lanes not certified", int((~res.converged).sum()), 0)
    _close(out, "x", res.x, ctx.res_c.x, rtol=2e-3, atol=1e-4)


def _gap_np(Q, c, btb, a1, x):
    """The dense relative duality gap (α₂ = 0) in float64 NumPy, both regimes."""
    QX = Q @ x
    xQx, cx, l1 = x @ QX, c @ x, np.abs(x).sum()
    rr = max(xQx - 2.0 * cx + btb, 0.0)
    u = QX - c
    u_inf = np.abs(u).max()
    f = 0.5 * rr + a1 * l1
    if u_inf > a1:
        s = a1 / u_inf
        gap = max(f + 0.5 * s * s * rr + s * (cx - btb), 0.0)
    else:
        gap = max(x @ u + a1 * l1, 0.0)
    return gap / max(f, 1.0), f


def f64_certificate(ctx: Inputs, out: dict) -> None:
    """The dense solve's float64 certificate (``_rel_gap_dense``) on the
    device, against the same call on the CPU and against NumPy float64, at
    n = 1280 on a stored-f32 Gram triple whose residual is far below bᵀb (the
    cancellation the reference's double-f32 arithmetic exists for), in both
    regimes (α₁ just under and just over ‖Qx − c‖∞). The limit is float64's
    rounding bound on the gap's sums, 4·n·ε·(|x|ᵀ|Q||x| + 2|c|ᵀ|x| + bᵀb +
    α₁‖x‖₁)/max(f, 1); the same formula in float32 misses by more."""
    from ..solvers.gram_dense import _rel_gap_dense

    n, m = 1280, 2560
    rng = np.random.default_rng(7)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    b = A @ (3.0 * rng.normal(size=n)) + 1e-3 * rng.normal(size=m)
    Q32, c32 = (A.T @ A).astype(np.float32), (A.T @ b).astype(np.float32)
    btb32 = np.float32(b @ b)
    Q, c, btb = Q32.astype(np.float64), c32.astype(np.float64), float(btb32)
    # an iterate near the optimum: least squares, then proximal steps
    a1 = 1e-3 * np.abs(c).max()
    step = 1.0 / np.linalg.norm(Q)  # ‖Q‖_F ≥ λ_max
    x = np.linalg.solve(Q, c)
    for _ in range(20):
        v = x - step * (Q @ x - c)
        x = np.sign(v) * np.maximum(np.abs(v) - step * a1, 0.0)
    x32 = x.astype(np.float32)
    x = x32.astype(np.float64)
    u_inf = np.abs(Q @ x - c).max()
    on_dev = lambda v, dev: torch.from_numpy(np.asarray(v)).to(dev)
    for branch, a1b in (("general", 0.99 * u_inf), ("saturated", 1.01 * u_inf)):
        want, f = _gap_np(Q, c, btb, a1b, x)
        scale = (np.abs(x) @ np.abs(Q) @ np.abs(x) + 2 * np.abs(c) @ np.abs(x) + btb
                 + a1b * np.abs(x).sum()) / max(f, 1.0)
        tol = 4 * n * np.finfo(np.float64).eps * scale
        got = {}
        for where in (ctx.device, torch.device("cpu")):
            got[where.type] = float(_rel_gap_dense(
                on_dev(Q32, where), on_dev(c32, where), torch.tensor(btb32, device=where),
                a1b, 0.0, on_dev(x, where)))
        _le(out, f"{branch}: |device − numpy|", abs(got[ctx.device.type] - want), tol)
        _le(out, f"{branch}: |device − cpu|", abs(got[ctx.device.type] - got["cpu"]), tol)
        want32 = _gap_np(Q32, c32, btb32, np.float32(a1b), x32)[0]
        _ge(out, f"{branch}: |float32 formula − numpy| (the control misses)",
            abs(float(want32) - want), tol, strict=True)


CHECKS = [
    fixed_iters, delta_momentum, adaptive_restart, certified_bursts, kernel_resume,
    adaptive_kernel, fused_gram_build, fused_gram_build_split4, fused_build_n20,
    fused_build_n64, fused_single_launch, greedy_momentum, kernel_armijo, fused_armijo,
    fused_resume, wide_n20, wide_n64, wide_n96, qstream_wide_n, qstream_resume,
    resident_window, resident_armijo_resume, resident_ceiling_n168, sharded_mosaic,
    f64_certificate,
]
CHECK_NAMES = [fn.__name__ for fn in CHECKS]


def holds(r: dict) -> bool:
    """Whether a reading (``{"value", "op", "limit"}``) is within its limit."""
    v, op, lim = r["value"], r["op"], r["limit"]
    return {"<=": lambda: v <= lim, "<": lambda: v < lim, ">=": lambda: v >= lim,
            ">": lambda: v > lim, "==": lambda: v == lim,
            "in": lambda: lim[0] < v[0] and v[1] < lim[1]}[op]()


def run(device=None, names=None) -> dict:
    """Run the checks (all, or those named) on ``device`` (default: the
    card, raising without one) and return the report: the reference's
    fields, ``detail`` holding each check's verdict and the device's name,
    and each check's readings (label → [measured, limit])."""
    device = target_device(device)
    unknown = set(names or ()) - set(CHECK_NAMES)
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)} (known: {CHECK_NAMES})")
    ctx = Inputs(device)
    checks: dict[str, bool] = {}
    readings: dict[str, dict] = {}
    for fn in CHECKS:
        name = fn.__name__
        if names and name not in names:
            continue
        out = readings[name] = {}
        try:
            fn(ctx, out)
            checks[name] = True
        except AssertionError as e:  # record, keep going — report all failures
            checks[name] = False
            print(f"# FAIL {name}: {e}")
    on_cuda = device.type == "cuda"
    return {
        "metric": ("gpu_kernel_verification_cuda_vs_torch_driver" if on_cuda
                   else "cpu_twin_verification_vs_torch_driver"),
        "value": sum(checks.values()),
        "unit": f"checks_passed_of_{len(checks)}",
        "ok": all(checks.values()),
        "detail": {**checks, "device": (torch.cuda.get_device_name(device) if on_cuda
                                        else "cpu")},
        "readings": readings,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the checks run (default: the card; raises without one)")
    ap.add_argument("--check", nargs="*", choices=CHECK_NAMES, default=None,
                    help="run only these checks")
    args = ap.parse_args(argv)
    out = run(None if args.device == "cuda" else args.device, args.check)
    print(json.dumps(out))
    raise SystemExit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
