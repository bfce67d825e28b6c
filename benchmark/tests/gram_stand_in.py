"""A driver that no cell uses, which times another entry than
``solve_lasso_batch``: the contract of ``spec.py`` met in new files alone.

The timed call is ``fastoptsolver_tpu_torch.batch.solve_gram_batch(gb,
cfg=…)`` on a Gram batch that the program's own build
(``kernels.gram_build.make_gram_batch_fused``: ``gram_pairs`` and
``gram_power`` on a card, their twin on a CPU tensor) makes in set-up from
the configuration's recipe, outside the timed call. It is judged by the
lasso check on the recipe's own A, b and α₁, which the reference turns into
its own Gram.
"""
from __future__ import annotations

import dataclasses

from benchmark import spec
from benchmark.drivers import lasso_batch

ENTRY = ("fastoptsolver_tpu_torch.batch", "solve_gram_batch")
TWIN = {"interpret": True}
LIMITS, EXACT = lasso_batch.LIMITS, lasso_batch.EXACT
lanes, solver = lasso_batch.lanes, lasso_batch.solver


class Session(lasso_batch.Session):
    """``lasso_batch.Session``'s batch, accounting and check, with the Gram
    built once in set-up and the solve on it timed."""

    def __init__(self, cell, seed, device, lanes_override=None):
        from fastoptsolver_tpu_torch.kernels.gram_build import make_gram_batch_fused

        super().__init__(cell, seed, device, lanes_override)
        self.solve = spec.entry(ENTRY)
        self.gb = make_gram_batch_fused(self.A, self.b, self.alpha1, 0.0)

    def call(self):
        return self.solve(self.gb, cfg=self.cfg)


def _half_left_out(solve):
    def broken(gb, **kw):
        B, h = gb.batch, gb.batch // 2
        part = solve(type(gb)(**{f.name: getattr(gb, f.name)[..., :h].contiguous()
                                 for f in dataclasses.fields(gb)}), **kw)
        return lasso_batch.pad_half(part, B)
    return broken


FAULTS = dict(lasso_batch.FAULTS, half_left_out=_half_left_out)
