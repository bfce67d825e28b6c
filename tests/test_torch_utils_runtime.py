"""The port's checkpoints, profiling and host runtime (``utils/*``,
``runtime/*``) held against the JAX package's, on the CPU.

Checkpoints are the reference's ``.npz`` format, read and written by both
packages: a JAX file restores in the port leaf for leaf (bit-equal to the
in-memory carry of ``convert``) and resumes in the port bit-exactly as that
carry does, and within the cross-engine tolerance of the reference's own
resumed run (x to rtol 1e-5/atol 1e-6, ``converged`` identical); a port
file restores in JAX and resumes there as JAX's own state does (float64, x
to 1e-12); the port's own states (fused, burst, resident) resume from a
file bit-exactly; the states both packages share list their fields in the
same order. The host runtime's native generator is bit-equal to the
reference runtime's, and its paths are held to float64 NumPy (rtol 1e-5,
as the reference's tests; standardisation to 1e-3/1e-4 of float32 inputs).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import runtime as jrt
from fastoptsolver_tpu import utils as jutils
from fastoptsolver_tpu.batch import fista_gram as JF
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.kernels import fista_vmem as jvmem
from fastoptsolver_tpu.kernels import solve_lasso_fused as jax_fused
from fastoptsolver_tpu.problems import LeastSquares as JLS
from fastoptsolver_tpu.solvers import FISTAConfig as JFISTAConfig
from fastoptsolver_tpu.solvers import fista as jfista
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch import runtime as trt
from fastoptsolver_tpu_torch import utils as tutils
from fastoptsolver_tpu_torch.batch import fista_gram as TF
from fastoptsolver_tpu_torch.batch import solve_lasso_batch
from fastoptsolver_tpu_torch.kernels import fista_vmem as tvmem
from fastoptsolver_tpu_torch.kernels import fused_solve
from fastoptsolver_tpu_torch.problems import DenseGram, LeastSquares
from fastoptsolver_tpu_torch.solvers import FISTAConfig, fista

torch.set_num_threads(1)


def _problem(n, m, B, seed, rho=0.2):
    """Feature-leading f32 lasso instances, AR(1) features of correlation
    ``rho`` (the cross-engine recipe of tests/test_torch_fused_solve.py)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):
        A[k] = rho * A[k - 1] + np.sqrt(1 - rho * rho) * A[k]
    xt = np.zeros((n, B))
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = np.einsum("nmb,nb->mb", A, xt) + 2.0 * rng.normal(size=(m, B))
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(A), f32(b), f32(a1)


def _boston_batch(B=6, m=150, seed=0):
    """Batch-major (B, m, 5) float64 instances, standardized."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, 5)) * [0.5, 0.5, 10.0, 10.0, 1.0] + [6, 0.2, 300, 60, 4]
    A = (A - A.mean(1, keepdims=True)) / A.std(1, keepdims=True)
    b = A @ np.array([5.0, 0.0, -0.02, -0.05, 1.5]) + rng.normal(size=(B, m))
    return A, b


def _trees():
    """One of each state the port checkpoints, with a None field and an
    int leaf among them."""
    A, b = _boston_batch()
    gb = TF.make_gram_batch(torch.from_numpy(A), torch.from_numpy(b), 0.5, 0.0)
    _, st = TF.fista_gram_batch(gb, TF.BatchFISTAConfig(max_iter=20, check_every=0),
                                return_state=True)
    p = LeastSquares.create(A[0], b[0], "lasso", 0.5, 0.0, dtype=torch.float64,
                            device="cpu")
    res = fista(p, FISTAConfig(max_iter=10), L=torch.tensor(100.0, dtype=torch.float64))
    dg = DenseGram(Q=gb.Q[:, :, 0].float(), c=gb.c[:, 0].float(), btb=gb.btb[0].float(),
                   m=torch.tensor(150))
    return {"GramBatch": gb, "BatchState": st, "SolveResult": res, "DenseGram": dg,
            "LeastSquares": p}


@pytest.mark.parametrize("name", ["GramBatch", "BatchState", "SolveResult", "DenseGram",
                                  "LeastSquares"])
def test_port_save_restore_roundtrip(name, tmp_path):
    tree = _trees()[name]
    path = tutils.save_pytree(str(tmp_path / "ckpt"), tree)
    assert path.endswith(".npz") and os.listdir(tmp_path) == ["ckpt.npz"]
    zeros = torch.utils._pytree.tree_map(
        lambda v: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v, tree)
    back = tutils.restore_pytree(path, zeros)
    assert type(back) is type(tree)
    for a, b in zip(torch.utils._pytree.tree_leaves(tree),
                    torch.utils._pytree.tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    if name == "BatchState":
        assert back.k == 20 and isinstance(back.k, int)
    if name == "SolveResult":
        assert back.history is None


def test_restore_refuses_mismatches(tmp_path):
    gb = _trees()["GramBatch"]
    path = tutils.save_pytree(str(tmp_path / "gb"), gb)
    with pytest.raises(ValueError, match="leaves"):
        tutils.restore_pytree(path, (gb.Q, gb.c))
    with pytest.raises(ValueError, match="shape"):
        tutils.restore_pytree(path, dataclasses.replace(gb, Q=gb.Q[:, :, :2]))
    assert sorted(os.listdir(tmp_path)) == ["gb.npz"]  # no .tmp left behind


def test_jax_fused_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's fused engine cut at 75 iterations, saved by its
    save_pytree, restored by the port into the port's own FusedSolveState:
    leaf for leaf the state convert carries, the resume bit-equal to the
    resume from that carry and held to the reference's resumed run; and the
    port's own 75-iteration state through a file resumes bit-exactly to the
    port's straight run."""
    A, b, a1 = _problem(5, 250, 300, seed=17)
    full = JaxConfig(max_iter=2000, check_every=25, rel_gap_tol=5e-6)
    half = dataclasses.replace(full, max_iter=75)
    args = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), 0.0)
    _, mid_j = jax_fused(*args, cfg=half, b_tile=128, interpret=True, return_state=True)
    res_j = jax_fused(*args, cfg=full, b_tile=128, interpret=True, state0=mid_j)
    path = jutils.save_pytree(str(tmp_path / "jax_fused"), mid_j)

    At, bt, a1t = (torch.from_numpy(v) for v in (A, b, a1))
    run = lambda cfg, **kw: fused_solve.solve_lasso_fused(
        At, bt, a1t, 0.0, cfg=convert.config_from_jax(cfg), b_tile=128, **kw)
    straight = run(full)
    _, mid_t = run(half, return_state=True)
    restored = tutils.restore_pytree(path, mid_t)
    carried = convert.fused_state_from_numpy(*(np.asarray(v) for v in mid_j))
    for f in fused_solve.FusedSolveState._fields:
        assert torch.equal(getattr(restored, f), getattr(carried, f)), f
    resumed = run(full, state0=restored)
    assert torch.equal(resumed.x, run(full, state0=carried).x)
    np.testing.assert_allclose(resumed.x.numpy(), np.asarray(res_j.x), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(resumed.converged.numpy(), np.asarray(res_j.converged))

    own = tutils.restore_pytree(tutils.save_pytree(str(tmp_path / "port_fused"), mid_t),
                                mid_t)
    again = run(full, state0=own)
    assert torch.equal(again.x, straight.x) and torch.equal(again.iters, straight.iters)


def test_jax_vmem_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's burst engine cut at 40 iterations, through its file,
    restored into the port's VmemSolveState: leaf for leaf convert's carry,
    resumed bit-exactly as the carry is, and to 100 iterations within the
    reference's straight run's tolerance; the port's own 40-iteration state
    through a file resumes bit-exactly to the port's straight run."""
    A, b = _boston_batch(B=40, m=80)
    gbj = JF.make_gram_batch(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32), 0.5, 0.0)
    fields = ("Q", "c", "btb", "alpha1", "alpha2", "L")
    gbt = convert.gram_batch_from_numpy(*(np.asarray(getattr(gbj, f)) for f in fields))
    cfg100, cfg40 = (JaxConfig(max_iter=k, check_every=0) for k in (100, 40))
    straight_j = jvmem.fista_gram_vmem(gbj, cfg100, b_tile=128, interpret=True)
    _, mid_j = jvmem.fista_gram_vmem(gbj, cfg40, b_tile=128, interpret=True,
                                     return_state=True)
    path = jutils.save_pytree(str(tmp_path / "jax_vmem"), mid_j)
    _, mid_t = tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg40), return_state=True)
    restored = tutils.restore_pytree(path, mid_t)
    carried = convert.vmem_state_from_numpy(*(np.asarray(v) for v in mid_j))
    for f in tvmem.VmemSolveState._fields:
        assert torch.equal(getattr(restored, f), getattr(carried, f)), f
    resume = lambda st: tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg100), state0=st)
    res = resume(restored)
    assert torch.equal(res.x, resume(carried).x) and int(res.n_iters_total) == 100
    np.testing.assert_allclose(res.x.numpy(), np.asarray(straight_j.x), rtol=2e-4, atol=2e-5)
    own = tutils.restore_pytree(tutils.save_pytree(str(tmp_path / "port_vmem"), mid_t), mid_t)
    straight_t = tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg100))
    assert torch.equal(resume(own).x, straight_t.x)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's driver state after 40 float64 iterations, saved by the
    port, restores in the reference (its BatchState, k an array there) leaf
    for leaf, and resumes there as the reference's own 40-iteration state
    does (x to 1e-12: the two states differ by summation order only); the
    port's GramBatch restores in the reference bit for bit."""
    A, b = _boston_batch()
    gbj = JF.make_gram_batch(jnp.asarray(A), jnp.asarray(b), 0.5, 0.0, dtype=jnp.float64)
    fields = ("Q", "c", "btb", "alpha1", "alpha2", "L")
    gbt = convert.gram_batch_from_numpy(*(np.asarray(getattr(gbj, f)) for f in fields))
    _, mid_t = TF.fista_gram_batch(gbt, TF.BatchFISTAConfig(max_iter=40, check_every=0),
                                   return_state=True)
    path = tutils.save_pytree(str(tmp_path / "port_state"), mid_t)
    restored = jutils.restore_pytree(path, JF.init_batch_state(gbj))
    for f in mid_t._fields:
        np.testing.assert_array_equal(np.asarray(getattr(restored, f)),
                                      np.asarray(getattr(mid_t, f)), err_msg=f)
    cfg = JaxConfig(max_iter=100, check_every=0)
    _, mid_j = JF.fista_gram_batch(gbj, dataclasses.replace(cfg, max_iter=40),
                                   return_state=True)
    resumed = JF.fista_gram_batch(gbj, cfg, state0=restored)
    own = JF.fista_gram_batch(gbj, cfg, state0=mid_j)
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(own.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(resumed.iters), np.asarray(own.iters))
    path_gb = tutils.save_pytree(str(tmp_path / "port_gb"), gbt)
    back = jutils.restore_pytree(path_gb, gbj)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(gbj, f)))


def test_solver_stats_timed_and_trace(tmp_path):
    """solver_stats equals the reference's on the same float64 Armijo fista
    solve; timed's stats; trace writes a Chrome trace."""
    A, b = _boston_batch(B=1, m=100)
    A, b = A[0], b[0]
    cfg = dict(max_iter=8, backtracking=True)  # past ~10 Armijo sits on the last bits
    pj = JLS.create(A, b, "lasso", 0.5, 0.0, dtype=jnp.float64)
    sj = jutils.solver_stats(jfista(pj, JFISTAConfig(**cfg), L=jnp.asarray(1.0)))
    pt = LeastSquares.create(A, b, "lasso", 0.5, 0.0, dtype=torch.float64, device="cpu")
    res, stats = tutils.timed(lambda: fista(pt, FISTAConfig(**cfg),
                                            L=torch.tensor(1.0, dtype=torch.float64)),
                              repeats=2)
    assert set(stats) == {"mean_s", "min_s", "max_s", "repeats"} and stats["repeats"] == 2
    assert 0 < stats["min_s"] <= stats["mean_s"] <= stats["max_s"]
    assert tutils.solver_stats(res) == sj and sj["n_iters"] == 8
    assert sj["ls_iters_total"] > 0 and sj["ls_num_calls"] == 8  # it backtracked
    with tutils.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert len(prof.key_averages()) > 0


def test_port_builds_its_own_host_library():
    lib = trt.ensure_built()
    assert lib is not None and trt.native_available() and lib.fastopt_version() == 1
    path = trt.host._lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "fastoptsolver_tpu_torch"


def test_generate_is_bit_equal_to_the_reference_runtime():
    assert jrt.native_available() and trt.native_available()
    noise = np.linspace(0.1, 5.0, 8).astype(np.float32)
    for kw in (dict(seed=7, batch=64, m=500, noise_std=1.0), dict(seed=1, batch=8, m=300,
                                                                noise_std=noise, rho1=0.5)):
        Aj, bj = jrt.generate_scenarios_host(**kw)
        At, bt = trt.generate_scenarios_host(**kw)
        assert np.array_equal(At, Aj) and np.array_equal(bt, bj)


def test_standardize_and_gram_match_numpy():
    A, b = trt.generate_scenarios_host(seed=5, batch=6, m=400)
    A64 = A.astype(np.float64)
    ref = (A64 - A64.mean(axis=1, keepdims=True)) / A64.std(axis=1, keepdims=True)
    As = trt.standardize_host(A.copy())
    np.testing.assert_allclose(As, ref, rtol=1e-3, atol=1e-4)
    Q, c, btb = trt.gram_batch_host(As, b)
    A64, b64 = As.astype(np.float64), b.astype(np.float64)
    np.testing.assert_allclose(Q, np.einsum("bmi,bmj->bij", A64, A64), rtol=1e-5)
    np.testing.assert_allclose(c, np.einsum("bmi,bm->bi", A64, b64), rtol=1e-4)
    np.testing.assert_allclose(btb, np.einsum("bm,bm->b", b64, b64), rtol=1e-5)
    np.testing.assert_array_equal(Q, np.swapaxes(Q, 1, 2))


def test_scenario_loader_yields_the_reference_batches():
    kw = dict(seed=0, batch=16, m=200, n_batches=3, standardize=True, gram=True)
    got = list(trt.ScenarioLoader(**kw))
    want = list(jrt.ScenarioLoader(**kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == 5 and all(np.array_equal(x, y) for x, y in zip(g, w))
    assert not np.array_equal(got[0][0], got[1][0])


def test_scenario_loader_feeds_solve_lasso_batch():
    """Three loader batches through the routed surface on the CPU (the
    torch driver there): every lane certified."""
    cfg = TF.BatchFISTAConfig(max_iter=1000, check_every=20, rel_gap_tol=1e-5)
    for A, b in trt.ScenarioLoader(seed=11, batch=12, m=300, n_batches=3):
        At, bt = torch.from_numpy(A), torch.from_numpy(b)
        a1 = 0.1 * torch.einsum("bmi,bm->bi", At, bt).abs().amax(1)
        res = solve_lasso_batch(At, bt, a1, 0.0, cfg=cfg)
        assert bool(res.converged.all())


def _field_names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


SHARED = ["kernels.FusedSolveState", "kernels.VmemSolveState", "kernels.ResidentSolveState",
          "batch.fista_gram.BatchState", "batch.fista_gram.GramBatch",
          "problems.DenseGram", "solvers.common.SolveResult", "solvers.common.Metrics"]


@pytest.mark.parametrize("name", SHARED)
def test_shared_states_list_their_leaves_in_the_reference_order(name):
    """Every state both packages checkpoint has the reference's fields in
    the reference's order, so its leaves are keyed alike in a file."""
    import importlib

    mod, cls = name.rsplit(".", 1)
    ref = getattr(importlib.import_module(f"fastoptsolver_tpu.{mod}"), cls)
    port = getattr(importlib.import_module(f"fastoptsolver_tpu_torch.{mod}"), cls)
    assert _field_names(port) == _field_names(ref)


def test_jax_dense_gram_file_restores_in_the_port(tmp_path):
    """A DenseGram streamed and saved by the reference restores in the
    port bit for bit (m as the port's int64), and the port's streamed Gram
    of the same chunks agrees with it to f32 summation order."""
    from fastoptsolver_tpu.problems import streaming as JS
    from fastoptsolver_tpu_torch.problems import streaming as TS

    rng = np.random.default_rng(9)
    A = rng.normal(size=(1500, 7)).astype(np.float32)
    b = rng.normal(size=1500).astype(np.float32)
    gj = JS.stream_gram(JS.chunk_rows(A, b, 400), n=7)
    path = jutils.save_pytree(str(tmp_path / "dense"), gj)
    gt = TS.stream_gram(TS.chunk_rows(A, b, 400), n=7, device="cpu")
    back = tutils.restore_pytree(path, gt)
    assert isinstance(back, DenseGram) and back.m.dtype == torch.int64
    for f in ("Q", "c", "btb", "m"):
        assert np.array_equal(getattr(back, f).numpy(), np.asarray(getattr(gj, f))), f
    np.testing.assert_allclose(gt.Q.numpy(), back.Q.numpy(), rtol=1e-5, atol=1e-4)


def test_resident_state_through_a_file_resumes_bit_exactly(tmp_path):
    """The resident engine's 40-iteration ResidentSolveState (per-lane k)
    through save_pytree/restore_pytree, resumed to 100 iterations: bit-equal
    to the straight run (the twin on the CPU; tolerance 1e-12 keeps every
    group running)."""
    from fastoptsolver_tpu_torch.kernels import resident

    A, b = _boston_batch(B=40, m=80)
    gb = TF.make_gram_batch(torch.from_numpy(A).float(), torch.from_numpy(b).float(), 0.5, 0.0)
    full = TF.BatchFISTAConfig(max_iter=100, check_every=20, rel_gap_tol=1e-12)
    straight = resident.fista_gram_resident(gb, full)
    _, mid = resident.fista_gram_resident(gb, dataclasses.replace(full, max_iter=40),
                                          return_state=True)
    assert isinstance(mid, resident.ResidentSolveState) and bool((mid.k == 40).all())
    path = tutils.save_pytree(str(tmp_path / "resident"), mid)
    back = tutils.restore_pytree(path, type(mid)(*(torch.zeros_like(v) for v in mid)))
    resumed = resident.fista_gram_resident(gb, full, state0=back)
    assert torch.equal(resumed.x, straight.x) and torch.equal(resumed.iters, straight.iters)
