"""Gloo ranks on the CPU for the port's multi-device tests.

``spawn(program, world)`` starts ``world`` processes of this file, joins
them into one gloo process group on a free local port, runs ``program`` (a
function below) on every rank and returns each rank's readings, a dict of
NumPy arrays and numbers; every spawn has a timeout and kills its ranks on
expiry. The ranks import torch and the port, never JAX: the test files hold
the readings against the JAX package in their own process, on the same
inputs, which the ``*_data`` functions make from a seed with NumPy.

    python tests/torch_dist_ranks.py PROGRAM RANK WORLD PORT OUTDIR
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(program: str, world: int = 4, timeout: float = 240.0, env: dict | None = None):
    """Every rank's readings of ``program``, in rank order."""
    from fastoptsolver_tpu_torch.bench.scaling import free_port, spawn_ranks

    port = free_port()
    full_env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    with tempfile.TemporaryDirectory() as out:
        argvs = [[sys.executable, os.path.abspath(__file__), program, str(r), str(world),
                  str(port), out] for r in range(world)]
        for r, (rc, log) in enumerate(spawn_ranks(argvs, timeout, env=full_env, cwd=ROOT)):
            if rc != 0:
                raise RuntimeError(f"{program} rank {r} exited {rc}:\n{log[-4000:]}")
        readings = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                readings.append(pickle.load(f))
    return readings


# ---- inputs, shared by the ranks and the JAX side ----

def matvec_data():
    rng = np.random.default_rng(0)
    m, n = 64, 16
    return (rng.normal(size=(m, n)), rng.normal(size=n), rng.normal(size=m),
            rng.normal(size=m))


def boston_data(seed: int, m: int = 256):
    from fastoptsolver_tpu_torch.problems import generate_boston_like

    A, b, _ = generate_boston_like(m=m, seed=seed, noise_std=1.0, rho1=0.5, rho2=0.7)
    return (A - A.mean(0)) / A.std(0), b


def col_data():
    rng = np.random.default_rng(1)
    m, n = 64, 16
    A = rng.normal(size=(m, n))
    return A, A @ rng.normal(size=n) + 0.1 * rng.normal(size=m)


def admm_data(m: int, n: int):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(m, n))
    x = np.zeros(n)
    x[:3] = rng.normal(size=3) * 3.0
    return A, A @ x + 0.5 * rng.normal(size=m)


def gram_batch_data(n_inst: int = 16, m: int = 100):
    As, bs = [], []
    for s in range(n_inst):
        A, b = boston_data(s, m)
        As.append(A)
        bs.append(b)
    A, b = np.stack(As), np.stack(bs)
    L = np.linalg.eigvalsh(np.einsum("bmi,bmj->bij", A, A))[:, -1]
    return A, b, L


def routed_data(seed: int = 0, B: int = 500, m: int = 150, n: int = 5):
    """``tests/test_routed_mesh.py``'s recipe in NumPy (feature-major)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B)).astype(np.float32)
    xt = np.zeros((n, B), np.float32)
    xt[: max(2, n // 8)] = rng.normal(size=(max(2, n // 8), B))
    if n > 8:
        A /= np.float32(np.sqrt(n))
    b = np.einsum("nmb,nb->mb", A, xt).astype(np.float32)
    a1 = (0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(0)).astype(np.float32)
    return A, b, a1


# Armijo runs stop at 8 iterations: past ~10 the accept/reject sits on the
# last bits in either package. The step-norm stop fires well before 3000.
ARMIJO = dict(max_iter=8, backtracking=True)
STOP = dict(max_iter=3000, tol=1e-7)


# ---- programs ----

def _np(t):
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def parallel(rank: int, world: int) -> dict:
    """``parallel/*``: mesh, matvecs, DistributedLeastSquares under fista and
    lbfgs, consensus_admm, shard_gram_batch under the driver."""
    import torch

    from fastoptsolver_tpu_torch.batch import make_gram_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from fastoptsolver_tpu_torch.parallel import (
        DistributedLeastSquares, consensus_admm, make_mesh, shard_gram_batch)
    from fastoptsolver_tpu_torch.parallel import matvec as mv
    from fastoptsolver_tpu_torch.problems import LeastSquares
    from fastoptsolver_tpu_torch.solvers import FISTAConfig, fista
    from fastoptsolver_tpu_torch.solvers.admm import ADMMConfig
    from fastoptsolver_tpu_torch.solvers.lbfgs import LBFGSConfig, lbfgs

    armijo, stop = FISTAConfig(**ARMIJO), FISTAConfig(**STOP)
    out = {}
    mesh = make_mesh(batch=1, model=world, device_type="cpu")
    out["mesh_shape"] = tuple(mesh.shape)
    out["mesh_names"] = tuple(mesh.mesh_dim_names)
    out["mesh_model2"] = tuple(make_mesh(model=2, device_type="cpu").shape)
    out["mesh_default"] = tuple(make_mesh(device_type="cpu").shape)
    try:
        make_mesh(batch=3, model=3, device_type="cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)

    A, x, y, b = (torch.as_tensor(v) for v in matvec_data())
    out["row_matvec"] = _np(mv.row_sharded_matvec(mesh, A, x))
    out["row_rmatvec"] = _np(mv.row_sharded_rmatvec(mesh, A, y))
    out["row_normal_grad"] = _np(mv.row_sharded_normal_grad(mesh, A, b, x))
    val, grad = mv.row_sharded_value_and_grad(mesh, A, b, x)
    out["row_value"], out["row_grad"] = _np(val), _np(grad)
    out["col_matvec"] = _np(mv.col_sharded_matvec(mesh, A, x))
    out["col_rmatvec"] = _np(mv.col_sharded_rmatvec(mesh, A, b))
    out["col_normal_grad"] = _np(mv.col_sharded_normal_grad(mesh, A, b, x))

    f64 = torch.float64
    A, b = boston_data(0)
    L = float(np.linalg.eigvalsh(A.T @ A)[-1])
    dist_row = DistributedLeastSquares.create(A, b, mesh, "lasso", 0.5, 0.0, dtype=f64)
    local = LeastSquares.create(A, b, "lasso", 0.5, 0.0, dtype=f64, device="cpu")
    out["fista_row_x"] = _np(fista(dist_row, FISTAConfig(max_iter=100), L=L).x)
    out["fista_row_L"] = _np(fista(dist_row, FISTAConfig(max_iter=1)).L)
    out["fista_local_L"] = _np(fista(local, FISTAConfig(max_iter=1)).L)
    r = fista(dist_row, armijo, L=L)
    out["fista_row_bt"] = (_np(r.x), int(r.n_iters))
    r = fista(dist_row, stop, L=L)
    out["fista_row_stop"] = (_np(r.x), int(r.n_iters))

    A, b = col_data()
    L = float(np.linalg.eigvalsh(A.T @ A)[-1]) + 0.5
    dist_col = DistributedLeastSquares.create(A, b, mesh, "elasticnet", 0.3, 0.5,
                                              layout="col", dtype=f64)
    out["fista_col_x"] = _np(fista(dist_col, FISTAConfig(max_iter=150), L=L).x)
    out["fista_col_L"] = _np(fista(dist_col, FISTAConfig(max_iter=1)).L)
    local = LeastSquares.create(A, b, "elasticnet", 0.3, 0.5, dtype=f64, device="cpu")
    out["fista_col_local_L"] = _np(fista(local, FISTAConfig(max_iter=1)).L)
    r = fista(dist_col, armijo, L=L)
    out["fista_col_bt"] = (_np(r.x), int(r.n_iters))
    r = fista(dist_col, stop, L=L)
    out["fista_col_stop"] = (_np(r.x), int(r.n_iters))
    out["x0_col_type"] = type(dist_col.x0()).__name__

    A, b = boston_data(2)
    dist_ridge = DistributedLeastSquares.create(A, b, mesh, "ridge", 0.0, 1.0, dtype=f64)
    out["lbfgs_row_x"] = _np(lbfgs(dist_ridge, LBFGSConfig(tol=1e-10)).x)

    cfg = ADMMConfig(max_iter=4000, abstol=1e-9, reltol=1e-8)
    for name, (m, n), reg, a1, a2 in (("admm", (240, 12), "lasso", 2.0, 0.0),
                                      ("admm_pad", (203, 10), "elasticnet", 1.0, 0.5)):
        A, b = admm_data(m, n)
        res = consensus_admm(A, b, mesh, reg, alpha1=a1, alpha2=a2, config=cfg,
                             dtype=f64)
        out[name] = {k: _np(v) for k, v in res._asdict().items()}

    A, b, L = gram_batch_data()
    gb = make_gram_batch(torch.as_tensor(A), torch.as_tensor(b), 0.5, 0.0,
                         L=torch.as_tensor(L))
    bmesh = make_mesh(batch=world, device_type="cpu")
    for ce in (0, 25):
        cfg = BatchFISTAConfig(max_iter=300, check_every=ce, rel_gap_tol=1e-9)
        res = fista_gram_batch(shard_gram_batch(gb, bmesh), cfg)
        plain = fista_gram_batch(gb, cfg)
        out[f"driver{ce}"] = {"x": _np(res.x), "n_iters_total": int(res.n_iters_total),
                              "iters": _np(res.iters), "converged": _np(res.converged),
                              "plain_x": _np(plain.x),
                              "plain_n_iters_total": int(plain.n_iters_total)}
    return out


def multihost(rank: int, world: int) -> dict:
    """``parallel/multihost.py`` on 2 hosts × 2 ranks (``LOCAL_WORLD_SIZE=2``)
    and ``problems.merge_grams``."""
    import torch
    import torch.distributed as dist

    from fastoptsolver_tpu_torch.batch import make_gram_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import BatchFISTAConfig, fista_gram_batch
    from fastoptsolver_tpu_torch.parallel import multihost as mh
    from fastoptsolver_tpu_torch.problems import chunk_rows, merge_grams, stream_gram

    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    mh.initialize()  # a repeat call: nothing
    out["repeat_initialize_world"] = dist.get_world_size()
    mesh = mh.make_host_chip_mesh(device_type="cpu")
    out["mesh_shape"], out["mesh_names"] = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    host = mesh.get_local_rank("host")
    out["host"] = host
    for hc in ((4, 1), (1, 4)):
        try:
            mh.make_host_chip_mesh(*hc, device_type="cpu")
            out[f"error_{hc}"] = None
        except ValueError as e:
            out[f"error_{hc}"] = str(e)

    # each host's rows, made from the host's seed (its ranks pass the same block)
    blk = np.random.default_rng(100 + host).normal(size=(6, 3))
    g = mh.from_process_local(blk, mesh, mh.host_sharded(mesh))
    out["from_local_full"] = _np(g)
    out["allgather_dtensor"] = mh.allgather(g)
    out["allgather_local"] = mh.allgather(torch.full((2, 3), float(rank)))

    # each host's own instances in Gram form, solved over the host axis
    A, b, L = gram_batch_data(n_inst=8, m=60)
    lo = 4 * host
    local_gb = make_gram_batch(torch.as_tensor(A[lo:lo + 4]), torch.as_tensor(b[lo:lo + 4]),
                               0.5, 0.0, L=torch.as_tensor(L[lo:lo + 4]))
    sharded = mh.gram_batch_from_local(local_gb, mesh)
    cfg = BatchFISTAConfig(max_iter=300, check_every=25, rel_gap_tol=1e-9)
    res = fista_gram_batch(sharded, cfg)
    out["gram_x"] = _np(res.x)
    out["gram_n_iters_total"] = int(res.n_iters_total)

    # merge_grams: each rank streams its own rows
    rng = np.random.default_rng(7)
    A_all = rng.normal(size=(4 * 300, 24)).astype(np.float32)
    b_all = rng.normal(size=4 * 300).astype(np.float32)
    rows = slice(300 * rank, 300 * (rank + 1))
    part = stream_gram(chunk_rows(A_all[rows], b_all[rows], rows=128), n=24,
                       dtype=torch.float32, device="cpu")
    for name, axis in (("merged", ("host", "chip")), ("merged_host", "host"),
                       ("merged_chip", "chip")):
        mg = merge_grams(part, mesh, axis)
        out[name] = {k: _np(getattr(mg, k)) for k in ("Q", "c", "btb", "m")}
    return out


def routed_mesh(rank: int, world: int) -> dict:
    """``solve_lasso_batch(mesh=)``, ``fista_gram_vmem_sharded`` and
    ``solve_pipeline_sharded`` on the CPU twins over 4 ranks, each beside
    the port's unsharded call made on the same rank."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import (
        BatchFISTAConfig, fista_gram_batch, init_batch_state, make_gram_batch)
    from fastoptsolver_tpu_torch.kernels import (
        ResidentSolveState, fista_gram_vmem, fista_gram_vmem_sharded, solve_lasso_fused,
        solve_pipeline_sharded)
    from fastoptsolver_tpu_torch.parallel import make_mesh

    out = {}
    mesh = make_mesh(batch=world, device_type="cpu")
    fm = dict(feature_major=True)
    T = lambda *vs: [torch.as_tensor(v) for v in vs]

    def keep(res):
        return {k: _np(getattr(res, k)) for k in ("x", "iters", "rel_gap", "converged",
                                                  "failed")} | {
            "n_iters_total": int(res.n_iters_total)}

    # the padding path: B = 500 is no multiple of 128 · 4
    A, b, a1 = T(*routed_data())
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=5e-6)
    out["pad_mesh"] = keep(solve_lasso_batch(A, b, a1, cfg=cfg, interpret=True, mesh=mesh,
                                             **fm))
    out["pad_plain"] = keep(solve_lasso_batch(A, b, a1, cfg=cfg, interpret=True, **fm))
    # the same lanes as DTensors sharded on the instance axis (B = 512)
    from fastoptsolver_tpu_torch.parallel.mesh import place, sharding

    A5, b5, a15 = T(*routed_data(seed=5, B=512))
    lay = lambda t: place(t, mesh, sharding(mesh, "batch", t.dim() - 1))
    out["dtensor_mesh"] = keep(solve_lasso_batch(lay(A5), lay(b5), lay(a15), cfg=cfg,
                                                 interpret=True, mesh=mesh, **fm))
    out["dtensor_plain"] = keep(solve_lasso_batch(A5, b5, a15, cfg=cfg, interpret=True, **fm))

    # backend="xla" on every rank
    A1, b1, a11 = T(*routed_data(seed=1, B=256))
    cfg8 = BatchFISTAConfig(max_iter=800, check_every=25, rel_gap_tol=5e-6)
    out["xla_mesh"] = keep(solve_lasso_batch(A1, b1, a11, cfg=cfg8, mesh=mesh,
                                             backend="xla", **fm))
    out["xla_plain"] = keep(solve_lasso_batch(A1, b1, a11, cfg=cfg8, backend="xla", **fm))

    # refusals
    refusals = {}

    def refuse(name, fn):
        try:
            fn()
            refusals[name] = None
        except Exception as e:  # the test reads the type and the message
            refusals[name] = (type(e).__name__, str(e))

    gb1 = make_gram_batch(A1.permute(2, 1, 0), b1.T, a11, 0.0)
    refuse("kernel_on_cpu", lambda: solve_lasso_batch(A1, b1, a11, cfg=cfg8, mesh=mesh,
                                                      backend="kernel", **fm))
    refuse("batch_state", lambda: solve_lasso_batch(A1, b1, a11, cfg=cfg8, mesh=mesh,
                                                    interpret=True,
                                                    state0=init_batch_state(gb1), **fm))
    refuse("xla_state", lambda: solve_lasso_batch(A1, b1, a11, cfg=cfg8, mesh=mesh,
                                                  backend="xla", return_state=True, **fm))
    rng = np.random.default_rng(14)
    A2 = torch.as_tensor(rng.normal(size=(200, 64, 256)) / 14.0, dtype=torch.float32)
    b2 = torch.as_tensor(rng.normal(size=(64, 256)), dtype=torch.float32)
    refuse("scalar_k", lambda: solve_lasso_batch(A2, b2, 0.3, cfg=cfg8, mesh=mesh,
                                                 interpret=True, return_state=True, **fm))
    # a checkpoint cut under 32-lane tiles whose tiles diverged: the mesh's
    # 128-lane tiles straddle them
    A9, b9, a19 = T(*routed_data(seed=9, B=1024, m=96))
    hard = (torch.arange(1024) >= 32) & (torch.arange(1024) < 64)
    a19 = torch.where(hard, a19, 10.0 * a19)
    cut = BatchFISTAConfig(max_iter=150, check_every=25, rel_gap_tol=1e-6)
    _, mid32 = solve_lasso_fused(A9, b9, a19, 0.0, cfg=cut, interpret=True,
                                 return_state=True, b_tile=32)
    out["cut_k_values"] = sorted(set(mid32.k.tolist()))
    refuse("k_not_uniform", lambda: solve_lasso_batch(
        A9, b9, a19, cfg=dataclasses.replace(cut, max_iter=300), mesh=mesh,
        interpret=True, state0=mid32, **fm))
    zeros = lambda *s: torch.zeros(s)
    wrong = ResidentSolveState(X=zeros(5, 1024), Y=zeros(5, 1024), t=zeros(1, 1024),
                               ps=zeros(1, 1024), tau=zeros(1, 1024),
                               k=torch.zeros(1024, dtype=torch.int32),
                               done=torch.zeros(1024, dtype=torch.bool),
                               iters=torch.zeros(1024, dtype=torch.int32), gap=zeros(1024))
    refuse("wrong_state", lambda: solve_lasso_batch(A9, b9, a19, cfg=cut, mesh=mesh,
                                                    interpret=True, state0=wrong, **fm))
    # a DTensor also sharded over the other axis holds part of each lane's A
    from torch.distributed.tensor import Shard

    mesh22 = make_mesh(batch=2, model=2, device_type="cpu")
    A5_split = place(A5, mesh22, [Shard(2), Shard(1)])
    on22 = lambda t: place(t, mesh22, sharding(mesh22, "batch", t.dim() - 1))
    refuse("dtensor_other_axis", lambda: solve_lasso_batch(
        A5_split, on22(b5), on22(a15), cfg=cfg, interpret=True, mesh=mesh22, **fm))
    out["refusals"] = refusals

    # 100 + 900 resume over the mesh, fused (n = 5) and resident (n = 144)
    for name, (seed, B, m, n) in (("fused", (5, 512, 100, 5)),
                                  ("resident", (13, 256, 200, 144))):
        Ar, br, a1r = T(*routed_data(seed=seed, B=B, m=m, n=n))
        full = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=5e-6)
        half = dataclasses.replace(full, max_iter=100)
        straight = solve_lasso_batch(Ar, br, a1r, cfg=full, interpret=True, mesh=mesh, **fm)
        _, mid = solve_lasso_batch(Ar, br, a1r, cfg=half, interpret=True, mesh=mesh,
                                   return_state=True, **fm)
        resumed = solve_lasso_batch(Ar, br, a1r, cfg=full, interpret=True, mesh=mesh,
                                    state0=mid, **fm)
        out[f"resume_{name}"] = {"state": type(mid).__name__, "straight": keep(straight),
                                 "resumed": keep(resumed)}
        if name == "fused":  # the mesh checkpoint resumes on one device too
            out["resume_fused"]["single"] = keep(solve_lasso_batch(
                Ar, br, a1r, cfg=full, interpret=True, state0=mid, **fm))

    # Armijo and instance-major
    A2, b2, a12 = T(*routed_data(seed=2, B=256))
    arm = BatchFISTAConfig(max_iter=100, check_every=25, rel_gap_tol=1e-4,
                           backtracking=True)
    out["armijo_mesh"] = keep(solve_lasso_batch(A2, b2, a12, cfg=arm, interpret=True,
                                                mesh=mesh, **fm))
    out["armijo_plain"] = keep(solve_lasso_batch(A2, b2, a12, cfg=arm, interpret=True, **fm))
    out["im_mesh"] = keep(solve_lasso_batch(A2.permute(2, 1, 0), b2.T, a12, cfg=cfg8,
                                            interpret=True, mesh=mesh))
    out["im_plain"] = keep(solve_lasso_batch(A2, b2, a12, cfg=cfg8, interpret=True, **fm))

    # the burst engine over the mesh: no early exit across ranks
    Ag, bg, _ = gram_batch_data(n_inst=16, m=200)
    a1g = 0.1 * np.abs(np.einsum("bmi,bm->bi", Ag, bg)).max(axis=1)
    gb = make_gram_batch(*T(Ag.astype(np.float32), bg.astype(np.float32),
                            a1g.astype(np.float32)), 0.0)
    vcfg = BatchFISTAConfig(max_iter=400, check_every=50, rel_gap_tol=1e-6)
    out["vmem_sharded"] = keep(fista_gram_vmem_sharded(gb, mesh, vcfg, interpret=True))
    out["vmem_single"] = keep(fista_gram_vmem(gb, vcfg, interpret=True))

    # the hand-wired pipeline: fused (fixed) and build + adaptive (restart)
    gb0 = make_gram_batch(A.permute(2, 1, 0), b.T, a1, 0.0)
    for mode, kw in (("fixed", {}), ("restart", dict(adaptive_restart=True))):
        pcfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=5e-6, **kw)
        out[f"pipeline_{mode}"] = keep(solve_pipeline_sharded(
            A, b, a1, 0.0, mesh, pcfg, b_tile_build=128, b_tile_solve=128,
            interpret=True))
        out[f"driver_{mode}"] = keep(fista_gram_batch(gb0, pcfg))
    return out


def main():
    import datetime

    import torch
    import torch.distributed as dist

    program, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // (2 * world)))
    if program == "multihost":  # joins through the port's own bootstrap
        os.environ.update(FASTOPT_COORDINATOR=f"localhost:{port}",
                          FASTOPT_NUM_PROCESSES=str(world), FASTOPT_PROCESS_ID=str(rank))
        from fastoptsolver_tpu_torch.parallel.multihost import initialize

        initialize(backend="gloo", timeout=datetime.timedelta(seconds=120))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
    readings = globals()[program](rank, world)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(readings, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
