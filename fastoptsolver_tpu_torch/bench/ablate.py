"""Headline-bench A/B harness (port of ``fastoptsolver_tpu/bench/ablate.py``):
pipeline variants of the bench configuration, timed in interleaved trials in
one process.

  python -m fastoptsolver_tpu_torch.bench.ablate --mode burst --check-every 25
  python -m fastoptsolver_tpu_torch.bench.ablate --mode adaptive --sort gap1
  python -m fastoptsolver_tpu_torch.bench.ablate --mode routed,fused1 --restart

Modes (a comma list interleaves them; ``--pl-iters`` takes a comma list of
power-iteration depths, interleaved too):

- ``routed``    — the public one-call surface ``solve_lasso_batch`` (one
                  fused launch at the bench shape on a card);
- ``fused1``/``fused1-plain`` — ``solve_lasso_fused`` with ``overlap=None``
                  and ``False``: one launch of the fused kernel. ``overlap``
                  selects nothing in the port (one kernel serves both of the
                  reference's variants), so the two modes run the same launch;
- ``burst``/``greedy``/``delta`` — the Gram build kernels, then the burst
                  engine (``fista_gram_vmem``) in that momentum mode;
- ``adaptive``  — the build, then the adaptive entry
                  (``fista_gram_vmem_adaptive``, the resident kernel): each
                  group of lanes exits at its own convergence;
- ``build-only``— the build kernels alone;
- ``driver``    — the build, then the torch driver ``fista_gram_batch``.

Sorting (``--sort``), adaptive mode only: instances are ordered by a
difficulty proxy before the solve, so each group's lanes converge together:
``gap1`` (the relative gap after one ``check_every``-step fixed run, one
more burst launch), ``L``, ``alpha``, ``gen`` (the noise level sorted at
generation, :func:`_build_problems_sorted`), ``none``. The proxy and the
permutation are inside the timed path; ``converged``/``iters`` are
un-permuted for the record.

Each trial times ``reps`` back-to-back solves: CUDA events on a card (the
host clock on the CPU, where every engine runs its plain twin). A record
gives the best trial's ms a solve beside every trial's (``trial_ms``), so
outliers show. The reference's TPU tiling knobs (``build_tile``,
``split_k``) have no counterpart and no field.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

MODES = ("burst", "adaptive", "build-only", "greedy", "delta", "routed",
         "fused1", "fused1-plain", "driver")


def _build(batch: int, m: int, device, sort_gen: bool = False):
    from .headline import build_problems

    gen = torch.Generator(device=device).manual_seed(0)
    return (_build_problems_sorted if sort_gen else build_problems)(gen, batch, m)


def _build_problems_sorted(generator: torch.Generator, batch: int, m: int):
    """``headline.build_problems`` with the per-instance noise level sorted
    before generation: instances of like difficulty share lane groups, so
    the adaptive kernel's per-group exit bites with no permutation at all.
    The marginals are unchanged (independent draws)."""
    from .headline import build_problems

    return build_problems(generator, batch, m, sort_noise=True)


def _gap_after_one_burst(gb, *, chunk: int, interpret: bool = False):
    """Difficulty proxy: each lane's relative gap after one fixed run of
    ``chunk`` steps (``check_every=0``: one launch, then one gap)."""
    from ..batch.fista_gram import BatchFISTAConfig
    from ..kernels.fista_vmem import fista_gram_vmem

    cfg = BatchFISTAConfig(max_iter=chunk, check_every=0)
    return fista_gram_vmem(gb, cfg, interpret=interpret).rel_gap


def _permute(gb, order: torch.Tensor):
    """The GramBatch with its lanes (the last axis) in ``order``."""
    from ..batch.fista_gram import GramBatch

    pick = lambda v: v.index_select(-1, order)
    return GramBatch(Q=pick(gb.Q), c=pick(gb.c), btb=pick(gb.btb),
                     alpha1=pick(gb.alpha1), alpha2=pick(gb.alpha2), L=pick(gb.L))


def _timer(device):
    """``time(fn) -> (seconds, result)`` of one call: CUDA events on a card,
    the host clock on the CPU."""
    if device.type == "cuda":
        def time_cuda(fn):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3, out
        return time_cuda

    def time_host(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    return time_host


def main(argv=None) -> list[dict]:
    """Parse ``argv``, run the interleaved trials, print one JSON record per
    (mode, power depth) and return the records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="burst",
                    help=f"one of {'|'.join(MODES)}, or a comma list to "
                         "interleave modes within one process")
    ap.add_argument("--sort", default="none",
                    choices=["none", "gap1", "L", "alpha", "gen"])
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--b-tile", type=int, default=None)
    ap.add_argument("--pl-iters", type=str, default="96",
                    help="power-iteration depth; a comma list interleaves "
                         "the depths within one process")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--restart", action="store_true",
                    help="nesterov + in-kernel adaptive restart")
    ap.add_argument("--backtracking", action="store_true",
                    help="the reference's Armijo line search")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs the twins")
    args = ap.parse_args(argv)

    from ..batch import solve_lasso_batch
    from ..batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from ..kernels import (
        fista_gram_vmem,
        fista_gram_vmem_adaptive,
        make_gram_batch_fused,
        solve_lasso_fused,
    )
    from ..problems.base import target_device

    modes = args.mode.split(",")
    bad = set(modes) - set(MODES)
    if bad:
        raise SystemExit(f"unknown mode(s) {sorted(bad)}; want subset of {sorted(MODES)}")
    device = target_device(args.device)
    A, b, alpha1 = _build(args.batch, args.m, device, sort_gen=args.sort == "gen")

    def make_cfg(mode):
        kw = {}
        if mode == "delta":
            kw = dict(momentum="delta", delta=10.0)
        elif mode == "greedy":
            kw = dict(momentum="greedy")
        if args.restart:
            kw["adaptive_restart"] = True
        if args.backtracking:
            kw["backtracking"] = True
        return BatchFISTAConfig(max_iter=args.max_iter, check_every=args.check_every,
                                rel_gap_tol=args.tol, **kw)

    def make_solve(mode, pl_iters):
        cfg = make_cfg(mode)

        def solve():
            if mode in ("fused1", "fused1-plain"):
                res = solve_lasso_fused(A, b, alpha1, 0.0, cfg=cfg, pl_iters=pl_iters,
                                        overlap=None if mode == "fused1" else False)
                return res.converged, res.iters
            if mode == "routed":
                # the public surface: the power depth is the router's default
                res = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
                return res.converged, res.iters
            gb = make_gram_batch_fused(A, b, alpha1, 0.0, pl_iters=pl_iters)
            if mode == "build-only":
                return gb.Q, None
            if mode == "driver":
                res = fista_gram_batch(gb, cfg)
                return res.converged, res.iters
            if mode == "adaptive":
                if args.sort not in ("none", "gen"):  # gen sorts at generation
                    if args.sort == "gap1":
                        key = _gap_after_one_burst(gb, chunk=args.check_every)
                    elif args.sort == "L":
                        key = gb.L
                    else:
                        key = gb.alpha1
                    order = torch.argsort(key)
                    res = fista_gram_vmem_adaptive(_permute(gb, order), cfg,
                                                   b_tile=args.b_tile)
                    inv = torch.argsort(order)  # un-permute for the record
                    return res.converged[inv], res.iters[inv]
                res = fista_gram_vmem_adaptive(gb, cfg, b_tile=args.b_tile)
                return res.converged, res.iters
            res = fista_gram_vmem(gb, cfg, b_tile=args.b_tile)
            return res.converged, res.iters
        return solve

    pl_list = [int(v) for v in args.pl_iters.split(",")]
    keys = [(mode, pl) for mode in modes for pl in pl_list]
    solvers = {k: make_solve(*k) for k in keys}
    for s in solvers.values():  # warm every config first
        s()
    def reps(solve):
        for _ in range(args.reps):
            out = solve()
        return out

    timer = _timer(device)
    results = {k: [] for k in keys}
    finals = {}
    for _ in range(args.trials):
        for k, s in solvers.items():  # interleaved A/B trials
            secs, (conv, iters) = timer(lambda: reps(s))
            results[k].append(secs / args.reps)
            finals[k] = (args.batch if iters is None else int(conv.sum()), iters)

    records = []
    for k in keys:
        mode, pl = k
        dt = min(results[k])
        n_conv, iters = finals[k]
        rec = {
            "mode": mode,
            "sort": args.sort,
            "check_every": args.check_every,
            "pl_iters": pl,
            "batch": args.batch,
            "converged": n_conv,
            "ms": dt * 1e3,
            "trial_ms": [t * 1e3 for t in results[k]],
            "inst_per_s_M": n_conv / dt / 1e6,
        }
        if mode != "build-only" and iters is not None:
            it = iters.cpu().numpy()
            rec["iters_median"] = int(np.median(it))
            rec["iters_mean"] = float(it.mean())
            rec["iters_max"] = int(it.max())
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
