"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 11 12 ...
        [--control-seeds 21 22 23] [--faults] [--out FILE]

In one process on the card, for each seed of ``--seeds``: the cell's batch,
one call of the timed path at the cell's own size, and the comparison's
numbers (``benchmark/checks/lasso.py``) on what it returned; with
``--faults``, the same numbers on that answer with a fault planted in it
(nothing moved; half of the batch left out; one lane's x 1% off; one
lane's flag flipped). For each seed of ``--control-seeds``: the control,
the reference in the program's place one precision below float32
(``reference.lasso.control``), at the cell's own size, judged alike. One
JSON line a reading, to standard output and to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from benchmark import spec
from benchmark.checks import lasso as check
from benchmark.reference import lasso


def faults(ans: check.Answer) -> dict:
    """The answer with each fault a lasso cell can have planted in it."""
    B = ans.x.shape[0]
    inf = torch.full_like(ans.rel_gap, float("inf"))
    off = torch.zeros_like(ans.converged)
    half = torch.arange(B, device=ans.x.device) >= B // 2
    lane = int(ans.x.abs().amax(dim=1).argmax())
    x_lane = ans.x.clone()
    x_lane[lane] *= 1.01
    flipped = ans.converged.clone()
    flipped[lane] = ~flipped[lane]
    return {
        "unchanged": check.Answer(torch.zeros_like(ans.x), off, inf, ans.iters),
        "half_left_out": check.Answer(torch.where(half[:, None], 0.0, ans.x),
                                      ans.converged & ~half,
                                      torch.where(half, inf, ans.rel_gap), ans.iters),
        "one_x_altered": check.Answer(x_lane, ans.converged, ans.rel_gap, ans.iters),
        "one_flag_flipped": check.Answer(ans.x, flipped, ans.rel_gap, ans.iters),
    }


def take(cell, seeds, control_seeds, with_faults: bool, device, emit) -> None:
    """Emit the readings of ``cell``: the program's on ``seeds`` (and its
    faults), the control's on ``control_seeds``."""
    drv = spec.driver(cell.config)
    for seed in seeds:
        s = drv.Session(cell, seed, device)
        t = time.perf_counter()
        res = s.call()
        _sync(device)
        call_s = time.perf_counter() - t
        s.keep(res)
        t = time.perf_counter()
        emit({"cell": cell.name, "seed": seed, "kind": "program", "call_s": call_s,
              "certified": int(res.converged.sum()), "lanes": s.lanes,
              "iters_median": float(res.iters.float().median()),
              "numbers": s.readings(), "check_s": time.perf_counter() - t})
        if with_faults:
            for name, ans in faults(s.kept[0]).items():
                s.kept = [ans]
                emit({"cell": cell.name, "seed": seed, "kind": f"fault:{name}",
                      "numbers": s.readings()})
        del s, res
    for seed in control_seeds:
        s = drv.Session(cell, seed, device)
        t = time.perf_counter()
        x, conv, gap, iters = lasso.control(s.A, s.b, s.alpha1, tol=s.cfg.rel_gap_tol,
                                            max_iter=s.cfg.max_iter,
                                            check_every=s.cfg.check_every)
        _sync(device)
        s.kept = [check.Answer(x, conv, gap, iters)]
        emit({"cell": cell.name, "seed": seed, "kind": "control:tf32",
              "control_s": time.perf_counter() - t, "certified": int(conv.sum()),
              "lanes": s.lanes, "numbers": s.readings()})
        del s


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card; no CUDA device is visible")
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(rec):
            text = json.dumps(rec)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()

        take(spec.cell(args.workload), args.seeds, args.control_seeds, args.faults,
             torch.device("cuda", 0), emit)


if __name__ == "__main__":
    main()
