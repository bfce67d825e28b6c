"""The port's multi-device layer (``fastoptsolver_tpu_torch.parallel``) on four
gloo ranks on the CPU, held against the JAX package on four of the
conftest's virtual devices at the same mesh shape.

One module-scoped spawn (``tests/torch_dist_ranks.py``, program
``parallel``) runs every case on the ranks; each check below is its own
test on those readings. Tolerances are ``tests/test_sharding.py``'s and
``tests/test_admm.py``'s."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dist_ranks as ranks

WORLD = 4


@pytest.fixture(scope="module")
def readings():
    return ranks.spawn("parallel", WORLD)


@pytest.fixture(scope="module")
def out(readings):
    return readings[0]


def _jax_mesh():
    from fastoptsolver_tpu.parallel import make_mesh

    return make_mesh(batch=1, model=WORLD, devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("key, want", [
    ("mesh_shape", (1, 4)),
    ("mesh_names", ("batch", "model")),
    ("mesh_model2", (2, 2)),
    ("mesh_default", (4, 1)),
    ("mesh_error", "mesh 3x3 != 4 devices"),
    ("x0_col_type", "DTensor"),
])
def test_mesh_layout(out, key, want):
    assert out[key] == want


def test_exports_the_reference_all():
    import fastoptsolver_tpu.parallel as ref
    import fastoptsolver_tpu_torch.parallel as port

    assert port.__all__ == ref.__all__
    assert all(hasattr(port, name) for name in port.__all__)


@functools.lru_cache(maxsize=None)
def _jax_matvecs():
    from fastoptsolver_tpu.parallel import matvec as mv

    mesh = _jax_mesh()
    A, x, y, b = (jnp.asarray(v) for v in ranks.matvec_data())
    val, grad = mv.row_sharded_value_and_grad(mesh, A, b, x)
    return {
        "row_matvec": mv.row_sharded_matvec(mesh, A, x),
        "row_rmatvec": mv.row_sharded_rmatvec(mesh, A, y),
        "row_normal_grad": mv.row_sharded_normal_grad(mesh, A, b, x),
        "row_value": val, "row_grad": grad,
        "col_matvec": mv.col_sharded_matvec(mesh, A, x),
        "col_rmatvec": mv.col_sharded_rmatvec(mesh, A, b),
        "col_normal_grad": mv.col_sharded_normal_grad(mesh, A, b, x),
    }


@pytest.mark.parametrize("name", ["row_matvec", "row_rmatvec", "row_normal_grad",
                                  "row_value", "row_grad", "col_matvec", "col_rmatvec",
                                  "col_normal_grad"])
def test_matvec_against_jax(out, name):
    want = np.asarray(_jax_matvecs()[name])
    np.testing.assert_allclose(out[name], want, rtol=1e-12, atol=1e-12)


def _jax_dist(layout):
    from fastoptsolver_tpu.parallel import DistributedLeastSquares

    if layout == "row":
        A, b = ranks.boston_data(0)
        args, L = ("lasso", 0.5, 0.0), np.linalg.eigvalsh(A.T @ A)[-1]
    else:
        A, b = ranks.col_data()
        args, L = ("elasticnet", 0.3, 0.5), np.linalg.eigvalsh(A.T @ A)[-1] + 0.5
    prob = DistributedLeastSquares.create(A, b, _jax_mesh(), *args, layout=layout,
                                          dtype=jnp.float64)
    return prob, jnp.asarray(L)


@pytest.mark.parametrize("layout, iters, rtol, atol", [("row", 100, 1e-9, 1e-11),
                                                       ("col", 150, 1e-8, 1e-10)])
def test_fista_against_jax(out, layout, iters, rtol, atol):
    from fastoptsolver_tpu.solvers import FISTAConfig, fista

    prob, L = _jax_dist(layout)
    want = fista(prob, FISTAConfig(max_iter=iters), L=L).x
    np.testing.assert_allclose(out[f"fista_{layout}_x"], np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("case", ["bt", "stop"])
def test_fista_armijo_and_stop_against_jax(out, layout, case):
    """Backtracking (an acceptance read each trial) and the step-norm stop:
    every rank takes the reference's decisions."""
    from fastoptsolver_tpu.solvers import FISTAConfig, fista

    prob, L = _jax_dist(layout)
    cfg = FISTAConfig(**(ranks.ARMIJO if case == "bt" else ranks.STOP))
    want = fista(prob, cfg, L=L)
    x, n_iters = out[f"fista_{layout}_{case}"]
    assert n_iters == int(want.n_iters)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("layout", ["row", "col"])
def test_distributed_lipschitz_matches_single_device(out, layout):
    """The power iteration starts from the same vector on every rank (its
    slice in the column layout): λ as the single-device problem's."""
    local = out["fista_local_L"] if layout == "row" else out["fista_col_local_L"]
    np.testing.assert_allclose(out[f"fista_{layout}_L"], local, rtol=1e-9)


def test_lbfgs_row_against_jax(out):
    from fastoptsolver_tpu.parallel import DistributedLeastSquares
    from fastoptsolver_tpu.solvers.lbfgs import LBFGSConfig, lbfgs

    A, b = ranks.boston_data(2)
    prob = DistributedLeastSquares.create(A, b, _jax_mesh(), "ridge", 0.0, 1.0,
                                          dtype=jnp.float64)
    want = lbfgs(prob, LBFGSConfig(tol=1e-10)).x
    np.testing.assert_allclose(out["lbfgs_row_x"], np.asarray(want), rtol=1e-8, atol=1e-10)


ADMM_CASES = {"admm": ((240, 12), "lasso", 2.0, 0.0),
              "admm_pad": ((203, 10), "elasticnet", 1.0, 0.5)}


@functools.lru_cache(maxsize=None)
def _jax_admm(name):
    from fastoptsolver_tpu.parallel import consensus_admm
    from fastoptsolver_tpu.solvers.admm import ADMMConfig

    (m, n), reg, a1, a2 = ADMM_CASES[name]
    A, b = ranks.admm_data(m, n)
    return consensus_admm(A, b, _jax_mesh(), reg, alpha1=a1, alpha2=a2,
                          config=ADMMConfig(max_iter=4000, abstol=1e-9, reltol=1e-8),
                          dtype=jnp.float64)


@pytest.mark.parametrize("name", list(ADMM_CASES))
@pytest.mark.parametrize("field", ["x", "x_smooth", "u", "n_iters", "rho", "converged"])
def test_consensus_admm_against_jax(out, name, field):
    got, want = out[name][field], np.asarray(getattr(_jax_admm(name), field))
    assert np.shape(got) == want.shape
    if field in ("n_iters", "rho", "converged"):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)


def test_consensus_admm_reaches_the_optimum(out):
    """Against CD's certified optimum, as ``tests/test_admm.py`` holds the
    reference (x_smooth stacked (4, n): one row a rank)."""
    from fastoptsolver_tpu.problems import LeastSquares
    from fastoptsolver_tpu.solvers import CDConfig, certified_optimum

    A, b = ranks.admm_data(240, 12)
    p = LeastSquares.create(A, b, "lasso", alpha1=2.0, dtype=jnp.float64)
    x_star, f_star = certified_optimum(p.to_gram(), CDConfig(max_sweeps=20000, tol=1e-14))
    res = out["admm"]
    assert res["converged"] and res["x_smooth"].shape == (WORLD, 12)
    np.testing.assert_allclose(float(p.objective(jnp.asarray(res["x"]))), float(f_star),
                               rtol=1e-8)
    np.testing.assert_allclose(res["x"], np.asarray(x_star), atol=1e-5)


@pytest.mark.parametrize("check_every", [0, 25])
def test_shard_gram_batch_driver_against_jax(out, check_every):
    """The driver on a GramBatch sharded over the batch axis: x as JAX's
    unsharded driver's and the same number of lockstep iterations (the stop
    test reduced over the ranks)."""
    from fastoptsolver_tpu.batch import make_gram_batch, fista_gram_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, L = ranks.gram_batch_data()
    gb = make_gram_batch(jnp.asarray(A), jnp.asarray(b), alpha1=0.5, alpha2=0.0,
                         dtype=jnp.float64, estimate_l=False)
    gb = dataclasses.replace(gb, L=jnp.asarray(L))
    want = fista_gram_batch(gb, BatchFISTAConfig(max_iter=300, check_every=check_every,
                                                 rel_gap_tol=1e-9))
    got = out[f"driver{check_every}"]
    assert got["n_iters_total"] == int(want.n_iters_total) == got["plain_n_iters_total"]
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got["x"], got["plain_x"])


@pytest.mark.parametrize("key", ["fista_row_x", "fista_col_x", "lbfgs_row_x", "admm",
                                 "driver25"])
def test_every_rank_holds_the_same_result(readings, key):
    first = readings[0][key]
    for r in readings[1:]:
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(r[key][k], first[k])
        else:
            np.testing.assert_array_equal(r[key], first)


@pytest.fixture(scope="module")
def scaling_reports():
    """Both modes of ``bench.scaling`` from one fresh set of CPU ranks per count."""
    from fastoptsolver_tpu_torch.bench.scaling import run_scaling

    return run_scaling([1, 2], ("dp", "model"), batch=256, m=40, iters=20, device="cpu",
                     timeout=120)


@pytest.mark.parametrize("mode", ["dp", "model"])
def test_bench_scaling_report(scaling_reports, mode):
    """``bench.scaling`` on CPU ranks: one fresh set of ranks per count, the
    reference's keys, the shared-device regime named."""
    rep = scaling_reports[mode]
    assert rep["mode"] == mode and rep["simulated_devices"] is True
    assert "share" in rep["note"]
    assert [p["devices"] for p in rep["points"]] == [1, 2]
    for p in rep["points"]:
        assert {"devices", "seconds", "work_per_s", "device_kind", "platform",
                "efficiency_vs_linear"} <= set(p)
        assert p["platform"] == "cpu" and p["seconds"] > 0 and p["work_per_s"] > 0
    assert rep["points"][0]["efficiency_vs_linear"] == 1.0
    other = scaling_reports["model" if mode == "dp" else "dp"]
    assert [p["set_s"] for p in rep["points"]] == [p["set_s"] for p in other["points"]]
