"""``solve_lasso_batch(mesh=)``, ``kernels.fista_gram_vmem_sharded`` and
``kernels.solve_pipeline_sharded`` of the port on four gloo ranks on the CPU
twins (``interpret=True``), held against the port's own unsharded calls
made on the same ranks and, for the padding path, against the JAX package's
unsharded routed call (``tests/test_routed_mesh.py``'s cases).

One module-scoped spawn (``tests/torch_dist_ranks.py``, program
``routed_mesh``) serves every check below."""
from __future__ import annotations

import numpy as np
import pytest

import torch_dist_ranks as ranks


@pytest.fixture(scope="module")
def readings():
    return ranks.spawn("routed_mesh", 4)


@pytest.fixture(scope="module")
def out(readings):
    return readings[0]


@pytest.mark.parametrize("field", ["x", "iters", "rel_gap", "converged", "failed"])
@pytest.mark.parametrize("case", ["pad", "dtensor", "armijo", "im"])
def test_mesh_is_the_unsharded_call_bit_for_bit(out, case, field):
    """Lanes are independent and each rank's 128-lane tiles are the unsharded
    call's (B = 500 pads 12 lanes onto the last rank, which certify at once;
    the DTensor input is the same lanes already sharded; Armijo and the
    instance-major layout route the same way)."""
    np.testing.assert_array_equal(out[f"{case}_mesh"][field], out[f"{case}_plain"][field])
    assert out[f"{case}_mesh"]["converged"].all() or case == "armijo"


def test_padding_path_against_jax(out):
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import solve_lasso_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, a1 = (jnp.asarray(v) for v in ranks.routed_data())
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=5e-6)
    ref = solve_lasso_batch(A, b, a1, cfg=cfg, feature_major=True, interpret=True)
    np.testing.assert_allclose(out["pad_mesh"]["x"], np.asarray(ref.x), rtol=1e-5, atol=1e-6)
    assert bool(np.asarray(ref.converged).all()) and out["pad_mesh"]["converged"].all()


def test_xla_backend_on_every_rank(out):
    """``backend="xla"``: the torch driver on each rank's lanes (its power
    iteration starts from each rank's own draw, so x agrees to the
    certification level, not the bit)."""
    assert out["xla_mesh"]["converged"].all()
    np.testing.assert_allclose(out["xla_mesh"]["x"], out["xla_plain"]["x"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name, exc, match", [
    ("kernel_on_cpu", "ValueError", "backend='kernel'"),
    ("batch_state", "NotImplementedError", "carries FusedSolveState; got BatchState"),
    ("xla_state", "NotImplementedError", "it cannot honor backend='xla'"),
    ("scalar_k", "NotImplementedError", "scalar-k engine"),
    ("k_not_uniform", "ValueError", "not uniform within lane tile"),
    ("wrong_state", "NotImplementedError", "carries FusedSolveState; got ResidentSolveState"),
    ("dtensor_other_axis", "ValueError", "replicated over its other axes"),
])
def test_refusals(out, name, exc, match):
    got = out["refusals"][name]
    assert got is not None, f"{name} did not raise"
    assert got[0] == exc and match in got[1], got


def test_refused_checkpoint_had_diverged_tiles(out):
    assert len(out["cut_k_values"]) > 1


@pytest.mark.parametrize("engine, state", [("fused", "FusedSolveState"),
                                           ("resident", "ResidentSolveState")])
@pytest.mark.parametrize("field", ["x", "iters", "rel_gap", "converged"])
def test_mesh_resume_is_bit_exact(out, engine, state, field):
    """100 + 900 iterations over the mesh equal 1000 straight over it."""
    r = out[f"resume_{engine}"]
    assert r["state"] == state and r["straight"]["converged"].all()
    np.testing.assert_array_equal(r["resumed"][field], r["straight"][field])


def test_mesh_checkpoint_resumes_on_one_device(out):
    r = out["resume_fused"]
    np.testing.assert_array_equal(r["single"]["x"], r["straight"]["x"])


def test_fista_gram_vmem_sharded(out):
    """Every rank runs the full static burst schedule: ``n_iters_total`` is
    ``n_bursts · chunk`` and x agrees with the early-exit single-device run
    at the certification level (``tests/test_kernels.py``'s hold)."""
    sh, single = out["vmem_sharded"], out["vmem_single"]
    assert sh["n_iters_total"] == 400 > single["n_iters_total"]
    assert sh["converged"].all() and (sh["rel_gap"] <= 1e-6).all()
    np.testing.assert_array_equal(sh["converged"], single["converged"])
    np.testing.assert_allclose(sh["x"], single["x"], rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["fixed", "restart"])
def test_solve_pipeline_sharded_against_the_driver(out, mode):
    """The fused kernel per rank (fixed) and the build kernels with the
    adaptive entry (restart), against the torch driver on the whole batch."""
    res = out[f"pipeline_{mode}"]
    assert res["converged"].all()
    np.testing.assert_allclose(res["x"], out[f"driver_{mode}"]["x"], atol=3e-4)


@pytest.mark.parametrize("key", ["pad_mesh", "xla_mesh", "vmem_sharded", "pipeline_restart"])
def test_every_rank_holds_the_same_result(readings, key):
    for r in readings[1:]:
        for field, v in readings[0][key].items():
            np.testing.assert_array_equal(r[key][field], v)
