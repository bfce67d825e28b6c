"""Cells whose caller hands ``solve_lasso_batch`` one batch of lasso problems
a call and waits for the certified solutions.

The timed call is the program's public routed surface,
``fastoptsolver_tpu_torch.batch.solve_lasso_batch(A, b, α₁, 0.0, cfg=…,
feature_major=True)``. The batch is the configuration's recipe made on the
device from the run's seed, and the same batch is sent on every call of the
run: the caller is a service that refits the same problems, and a fixed
batch keeps every call's work equal within a run. Another seed sends other
problems of the same sizes, so a run's work varies with its seed as a
deployment's does with its data.
"""
from __future__ import annotations

import torch

from .. import spec
from ..checks import lasso as check

ENTRY = ("fastoptsolver_tpu_torch.batch", "solve_lasso_batch")
# On a CPU tensor the entry would take the torch driver, another engine with
# another f32 floor than the card's; this sends it to the plain twins of the
# card's own kernels, whose arithmetic the cells' limits were read on.
TWIN = {"interpret": True}
LIMITS = ("gap_max", "gap_median", "subopt_max", "flags_off")
EXACT = ("flags_off",)


def solver(config: dict):
    """The program's solver settings for ``config["solver"]``."""
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig

    return BatchFISTAConfig(**config["solver"])


def lanes(config: dict, traffic: dict) -> int:
    """Lanes a call: the traffic's count, or the configuration's published
    batch where the traffic says ``"published"``."""
    return config["published_lanes"] if traffic["lanes"] == "published" else int(traffic["lanes"])


class Session:
    """One cell's data, its calls and what they returned.

    ``lanes_override`` replaces the traffic's lanes a call (the CPU tests run
    the harness at a size a test can hold)."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, lanes_override=None):
        config, traffic = cell.config, cell.traffic
        self.seed = seed
        self.limits = cell.limits
        self.solve = spec.entry(ENTRY)
        self.cfg = solver(config)
        self.lanes = lanes_override or lanes(config, traffic)
        build = spec.recipe(config)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.A, self.b, self.alpha1 = build(gen, self.lanes, m=config["m"], n=config["n"],
                                            **config["recipe_params"], **traffic["recipe_params"])
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self.kept: list[check.Answer] = []

    def call(self):
        """The timed call."""
        return self.solve(self.A, self.b, self.alpha1, 0.0, cfg=self.cfg, feature_major=True)

    def account(self, res) -> None:
        """Add the call's certified and failed lanes on the device (no sync)."""
        failed = res.failed if res.failed is not None else torch.zeros_like(res.converged)
        self.counts += torch.stack((res.converged, failed)).sum(dim=1)

    def totals(self) -> dict:
        certified, failed = self.counts.tolist()
        return {"certified": certified, "failed": failed}

    def keep(self, res) -> None:
        self.kept.append(check.Answer(res.x, res.converged, res.rel_gap, res.iters))

    def work(self, res) -> dict:
        """What the per-layer readers count: the shapes and every lane's
        iterations as the call returned them."""
        n, m, B = self.A.shape
        return {"n": n, "m": m, "B": B, "check_every": self.cfg.check_every,
                "iters": res.iters.to("cpu", torch.int64)}

    def readings(self) -> dict:
        """The comparison's numbers over the kept calls."""
        return check.readings(self.A, self.b, self.alpha1, self.kept,
                              tol=self.cfg.rel_gap_tol, seed=self.seed)

    def judge(self, numbers: dict):
        """``(correct, {name: {"value", "limit"}})`` against the cell's limits."""
        return check.judge(numbers, self.limits)


# The faults a one-card cell of this driver can have, each planted where the
# entry's result is produced: a solve that returns its state unchanged, half
# of the batch left out, one answer altered (its x, or its flag). The
# exchange between cards does not exist on one card.

def _unchanged(solve):
    def broken(*args, **kw):
        res = solve(*args, **kw)
        return res._replace(x=torch.zeros_like(res.x), converged=torch.zeros_like(res.converged),
                            rel_gap=torch.full_like(res.rel_gap, float("inf")))
    return broken


def _half_left_out(solve):
    def broken(A, b, a1, a2, **kw):
        h = A.shape[-1] // 2
        part = solve(A[..., :h].contiguous(), b[..., :h].contiguous(), a1[:h], a2, **kw)
        return pad_half(part, A.shape[-1])
    return broken


def pad_half(part, B: int):
    """``part``, the result of the first lanes alone, padded to ``B`` lanes
    as nothing came back for the rest."""
    pad = lambda v, fill: torch.cat([v, torch.full((B - v.shape[0], *v.shape[1:]), fill,
                                                   dtype=v.dtype, device=v.device)])
    return part._replace(x=pad(part.x, 0.0), iters=pad(part.iters, 0),
                         rel_gap=pad(part.rel_gap, float("inf")),
                         converged=pad(part.converged, False), failed=pad(part.failed, False))


def _x_altered(solve):
    def broken(*args, **kw):
        res = solve(*args, **kw)
        x = res.x.clone()
        x[3] *= 1.01
        return res._replace(x=x)
    return broken


def _flag_flipped(solve):
    def broken(*args, **kw):
        res = solve(*args, **kw)
        converged = res.converged.clone()
        converged[3] = ~converged[3]
        return res._replace(converged=converged)
    return broken


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "x_altered": _x_altered, "flag_flipped": _flag_flipped}
