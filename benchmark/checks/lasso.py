"""The comparison that decides ``correct`` for batched lasso cells.

It reads what the timed calls returned (``x``, ``converged``, ``rel_gap``
and ``iters`` of every lane) and judges it against the plain reference
(``benchmark/reference/lasso.py``) on the benchmark's own ``A``, ``b`` and
α₁, once the window has closed:

- ``gap_max`` — the largest float64 relative duality gap at the returned x,
  over every lane of every kept call: a lane left out, never moved or
  altered reads far above the f32 floor;
- ``gap_median`` — the median lane's gap (of the worst kept call): the
  f32 floor the whole batch reaches, which a lower precision cannot;
- ``subopt_max`` — the largest ``(f(x) − f*)/max(f*, 1)`` over sampled
  lanes, f* the reference's float64 optimum: an independent check of the
  gap's own arithmetic;
- ``flags_off`` — lanes whose ``converged`` disagrees with their own
  ``rel_gap ≤ tol`` and a finite x: the answer must say what it is.

The sample is drawn from the seed, with the lanes that ran the most
iterations added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..reference import lasso

SAMPLE = 2048  # lanes drawn from the seed for the optimum
HARDEST = 64  # and the lanes that ran the most iterations
REF_GAP = 1e-9  # the reference optimum's own float64 gap must be below this


class Answer(NamedTuple):
    x: torch.Tensor  # (B, n)
    converged: torch.Tensor  # (B,) bool
    rel_gap: torch.Tensor  # (B,)
    iters: torch.Tensor  # (B,)


def _same(a: Answer, b: Answer) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def sample_lanes(B: int, iters: torch.Tensor, seed: int) -> torch.Tensor:
    """The lanes held against the optimum: SAMPLE drawn from ``seed`` and the
    HARDEST with the most iterations, sorted."""
    drawn = torch.randperm(B, generator=torch.Generator().manual_seed(seed))[:SAMPLE]
    hardest = torch.topk(iters.to("cpu", torch.int64), min(HARDEST, B)).indices
    return torch.unique(torch.cat([drawn, hardest]))


def readings(A, b, alpha1, answers: list[Answer], *, tol: float, seed: int) -> dict:
    """The numbers compared, over ``answers`` (identical answers count
    once), and ``ref_gap_max``, the reference optimum's own certificate."""
    unique: list[Answer] = []
    for ans in answers:
        if not any(_same(ans, u) for u in unique):
            unique.append(ans)
    out = {"gap_max": 0.0, "gap_median": 0.0, "subopt_max": 0.0, "flags_off": 0}
    lanes = sample_lanes(A.shape[2], answers[-1].iters, seed).to(A.device)
    _, f_opt, gap_opt = lasso.optimum(A, b, alpha1, lanes)
    if not float(gap_opt.max()) <= REF_GAP:
        raise RuntimeError(f"the reference's optimum reads a gap of {float(gap_opt.max()):.3e}, "
                           f"above {REF_GAP:g}: it cannot judge the program")
    A_s, b_s, a_s = A[:, :, lanes], b[:, lanes], alpha1[lanes]
    for ans in unique:
        gap, _ = lasso.rel_gap(A, b, alpha1, ans.x)
        _, f = lasso.rel_gap(A_s, b_s, a_s, ans.x[lanes])
        subopt = (f - f_opt) / f_opt.clamp_min(1.0)
        said = (ans.rel_gap <= tol) & torch.isfinite(ans.x).all(dim=1)
        out["gap_max"] = max(out["gap_max"], float(gap.max()))
        out["gap_median"] = max(out["gap_median"], float(gap.median()))
        out["subopt_max"] = max(out["subopt_max"],
                                float(torch.nan_to_num(subopt, nan=float("inf")).max()))
        out["flags_off"] = max(out["flags_off"], int((ans.converged != said).sum()))
    out["ref_gap_max"] = float(gap_opt.max())
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for every limit the cell has."""
    held = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in held.values()), held
