"""Multi-device scaling benchmark, instance-parallel and model-parallel
(port of ``fastoptsolver_tpu/bench/scaling.py``).

Measures work a second of (a) ``dp``: the torch driver on a GramBatch
sharded over the ``batch`` axis (``parallel.shard_gram_batch``; each rank
solves its lanes, one all-reduced stop test a block), ``batch × iters``
instance-iterations, and (b) ``model``: FISTA on a row-sharded
``DistributedLeastSquares`` (one all-reduce of the gradient an iteration),
``iters`` solver iterations; and the efficiency against linear scaling,
``W(n) / (n · W(1))``.

Each device count runs in a fresh set of ranks (one process each, spawned
with a timeout, joined to a group on a free local port); ``run_scaling``
runs several modes in turn in each set. Where there are
fewer devices than ranks (the CPU, or several ranks sharing one card) the
numbers check the sharded path's correctness and overhead, not a physical
speedup: the ranks share one device, so expect efficiency near 1/n. The
report says which regime it ran in, and each point the seconds its set of
ranks took from start to exit (``set_s``, every mode of the set) and rank
0's from the start of its mode to the warm run (``ready_s``: the imports
and the group for the first mode, the data). On CUDA each
rank takes its own card over NCCL when there are enough cards; otherwise
the ranks share card 0 over gloo (NCCL refuses two ranks on one card).

CLI:  python -m fastoptsolver_tpu_torch.bench.scaling --devices 1 2 4 [--mode dp model]
      [--device cpu]   (one JSON report a line, a line a mode)
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_CHILD_FLAG = "--scaling-child"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _layout(device: str, world: int):
    """(backend, the rank's device index or None, ranks share a device)."""
    import torch

    if device == "cpu":
        return "gloo", None, world > 1
    if torch.cuda.device_count() >= world:
        return "nccl", True, False
    return "gloo", False, world > 1


def _child(modes, rank: int, world: int, port: int, device: str, batch: int,
           m: int, iters: int) -> None:
    import datetime

    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist

    backend, own_card, shared = _layout(device, world)
    dev = torch.device("cpu")
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        dev = torch.device("cuda", rank if own_card else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120),
                            device_id=dev if backend == "nccl" else None)
    for mode in modes:
        _measure(mode, rank, world, dev, device, backend, shared, batch, m, iters, t_start)
        t_start = time.perf_counter()
    dist.destroy_process_group()


def _measure(mode: str, rank: int, world: int, dev, device: str, backend: str,
             shared: bool, batch: int, m: int, iters: int, t_start: float) -> None:
    """One mode's timed run on this rank; rank 0 prints its point."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..batch import make_gram_batch
    from ..batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from ..parallel import BATCH_AXIS, make_mesh, shard_gram_batch
    from ..parallel.problem import DistributedLeastSquares
    from ..solvers import FISTAConfig, fista

    rng = np.random.default_rng(0)
    if mode == "dp":
        mesh = make_mesh(batch=world, model=1, device_type=device)
        A = torch.as_tensor(rng.normal(size=(batch, m, 5)), dtype=torch.float32, device=dev)
        b = torch.as_tensor(rng.normal(size=(batch, m)), dtype=torch.float32, device=dev)
        gb = shard_gram_batch(make_gram_batch(A, b, alpha1=0.5, alpha2=0.0, power_iters=20),
                              mesh, BATCH_AXIS)
        del A, b
        cfg = BatchFISTAConfig(max_iter=iters, check_every=0)
        run = lambda: fista_gram_batch(gb, cfg).x.to_local()
        work = batch * iters  # instance-iterations
    else:  # one big row-sharded problem
        mesh = make_mesh(batch=1, model=world, device_type=device)
        rows = m * 64
        A = rng.normal(size=(rows, 256)).astype(np.float32)
        bb = rng.normal(size=rows).astype(np.float32)
        prob = DistributedLeastSquares.create(torch.as_tensor(A, device=dev),
                                              torch.as_tensor(bb, device=dev), mesh,
                                              "lasso", 0.5, 0.0)
        cfg = FISTAConfig(max_iter=iters)
        L = torch.tensor(float(rows), dtype=torch.float32, device=dev)
        run = lambda: fista(prob, cfg, L=L).x
        work = iters  # solver iterations

    ready_s = time.perf_counter() - t_start
    float(run().sum())  # warm: allocations, the kernels' first launches
    dist.barrier()
    t0 = time.perf_counter()
    out = run()
    float(out.sum())  # a value fetch: the work has finished
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)  # the slowest rank's
    if rank == 0:
        kind = torch.cuda.get_device_name(dev) if device == "cuda" else "cpu"
        print(json.dumps({"mode": mode, "devices": world, "seconds": float(dt[0]),
                          "work_per_s": work / float(dt[0]), "device_kind": kind,
                          "platform": "gpu" if device == "cuda" else "cpu",
                          "backend": backend, "shared_device": shared,
                          "ready_s": ready_s}), flush=True)


def spawn_ranks(argvs, timeout: float, env: dict | None = None, cwd: str | None = None):
    """Start one process a rank, ``argvs[r]`` its command line, and wait for
    all of them under one deadline, killing every one on expiry
    (``TimeoutError``, with the output of the first that had not finished).
    Returns each rank's (return code, output), stdout and stderr together."""
    procs = [subprocess.Popen(a, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in argvs]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        late = len(outs)
        for p in procs:
            p.kill()
        for p in procs[late:]:
            outs.append(p.communicate()[0])
        raise TimeoutError(f"{len(procs)} ranks did not finish in {timeout} s; rank "
                           f"{late}'s output ends: {outs[late][-2000:]}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def run_scaling(device_counts, modes=("dp", "model"), batch=4096, m=200, iters=200,
                device="cuda", timeout: float = 300.0) -> dict:
    """One fresh set of ranks per device count, each running ``modes`` in
    turn; a report per mode."""
    points = {mode: [] for mode in modes}
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for n in device_counts:
        t0 = time.perf_counter()
        payload = {"modes": list(modes), "device": device, "batch": batch, "m": m,
                   "iters": iters, "world": n, "port": free_port()}
        argvs = [[sys.executable, "-m", "fastoptsolver_tpu_torch.bench.scaling",
                  _CHILD_FLAG, json.dumps(dict(payload, rank=r))] for r in range(n)]
        ranks = spawn_ranks(argvs, timeout, env=env, cwd=_ROOT)
        bad = [(r, rc, out[-2000:]) for r, (rc, out) in enumerate(ranks) if rc != 0]
        if bad:
            raise RuntimeError(f"scaling rank failed (rank, rc, output): {bad[0]}")
        set_s = time.perf_counter() - t0
        for ln in ranks[0][1].splitlines():
            if ln.startswith("{"):
                rec = json.loads(ln)
                points[rec["mode"]].append(dict(rec, set_s=set_s))
    return {mode: _report(mode, pts, device) for mode, pts in points.items()}


def _report(mode: str, results: list, device: str) -> dict:
    base = results[0]
    for r in results:
        r["efficiency_vs_linear"] = round(
            r["work_per_s"] / (base["work_per_s"] * r["devices"] / base["devices"]), 3)
    shared = any(r["shared_device"] for r in results)
    if device == "cpu":
        note = ("CPU ranks share one host's cores: expect efficiency ~1/n; run on "
                "one card a rank for physical scaling")
    elif shared:
        note = ("ranks share one GPU over gloo (fewer cards than ranks): expect "
                "efficiency ~1/n; run on one card a rank for physical scaling")
    else:
        note = "one card a rank over NCCL"
    return {"mode": mode, "simulated_devices": shared, "note": note, "points": results}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--mode", choices=["dp", "model"], nargs="+", default=["dp"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    reports = run_scaling(args.devices, args.mode, args.batch, args.m, args.iters,
                        args.device, args.timeout)
    for mode in args.mode:
        print(json.dumps(reports[mode]))


if __name__ == "__main__":
    if sys.argv[1:2] == [_CHILD_FLAG]:  # a rank, started by run_scaling
        c = json.loads(sys.argv[2])
        _child(c["modes"], c["rank"], c["world"], c["port"], c["device"], c["batch"],
               c["m"], c["iters"])
    else:
        main()
