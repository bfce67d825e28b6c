"""The port's multi-host layer (``parallel/multihost.py``) and
``problems.merge_grams`` on four gloo ranks on the CPU, laid out as 2 hosts
× 2 ranks (``LOCAL_WORLD_SIZE=2``), the ranks joined through the port's own
``initialize`` from the ``FASTOPT_*`` variables.

One module-scoped spawn (``tests/torch_dist_ranks.py``, program
``multihost``) serves every check below; the Gram solve is held against the
JAX package's driver on the concatenated batch, the merge against float64
sums of every rank's rows."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch_dist_ranks as ranks


@pytest.fixture(scope="module")
def readings():
    return ranks.spawn("multihost", 4, env={"LOCAL_WORLD_SIZE": "2"})


@pytest.mark.parametrize("rank", range(4))
def test_initialize_joins_and_repeats_as_nothing(readings, rank):
    r = readings[rank]
    assert (r["world"], r["rank"], r["repeat_initialize_world"]) == (4, rank, 4)


def test_initialize_leaves_a_standalone_process_alone(monkeypatch):
    import torch.distributed as dist

    from fastoptsolver_tpu_torch.parallel import multihost

    for var in ("FASTOPT_COORDINATOR", "FASTOPT_NUM_PROCESSES", "FASTOPT_PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="are all needed"):
        multihost.initialize(coordinator_address="localhost:1")


@pytest.mark.parametrize("rank", range(4))
def test_host_chip_mesh(readings, rank):
    r = readings[rank]
    assert r["mesh_shape"] == (2, 2) and r["mesh_names"] == ("host", "chip")
    assert r["host"] == rank // 2  # host-major, as torchrun numbers ranks


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_host_chip_mesh_refuses_another_topology(readings, shape):
    assert readings[0][f"error_{shape}"] == (
        f"requested {shape[0]}x{shape[1]} mesh but topology is 2 hosts x 2 ranks")


def _host_rows():
    return np.concatenate([np.random.default_rng(100 + h).normal(size=(6, 3))
                           for h in range(2)])


@pytest.mark.parametrize("key", ["from_local_full", "allgather_dtensor"])
def test_from_process_local_and_allgather(readings, key):
    for r in readings:
        np.testing.assert_array_equal(r[key], _host_rows())


def test_allgather_of_rank_local_tensors(readings):
    want = np.repeat(np.arange(4.0), 2)[:, None] * np.ones((1, 3))
    for r in readings:
        np.testing.assert_array_equal(r["allgather_local"], want)


def test_gram_batch_from_local_against_jax(readings):
    """Each host's own instances in Gram form, solved over the host axis by
    the torch driver, against the JAX driver on the concatenated batch."""
    import jax.numpy as jnp

    from fastoptsolver_tpu.batch import fista_gram_batch, make_gram_batch
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig

    A, b, L = ranks.gram_batch_data(n_inst=8, m=60)
    gb = make_gram_batch(jnp.asarray(A), jnp.asarray(b), alpha1=0.5, alpha2=0.0,
                         dtype=jnp.float64, estimate_l=False)
    want = fista_gram_batch(dataclasses.replace(gb, L=jnp.asarray(L)),
                            BatchFISTAConfig(max_iter=300, check_every=25, rel_gap_tol=1e-9))
    for r in readings:
        assert r["gram_n_iters_total"] == int(want.n_iters_total)
        np.testing.assert_allclose(r["gram_x"], np.asarray(want.x), rtol=1e-10, atol=1e-12)


def _rows(ranks_):
    rng = np.random.default_rng(7)
    A = rng.normal(size=(1200, 24)).astype(np.float32).astype(np.float64)
    b = rng.normal(size=1200).astype(np.float32).astype(np.float64)
    idx = np.concatenate([np.arange(300 * r, 300 * (r + 1)) for r in ranks_])
    return A[idx], b[idx]


@pytest.mark.parametrize("name, groups", [
    ("merged", [(0, 1, 2, 3)] * 4),
    ("merged_host", [(0, 2), (1, 3), (0, 2), (1, 3)]),
    ("merged_chip", [(0, 1), (0, 1), (2, 3), (2, 3)]),
])
@pytest.mark.parametrize("field", ["Q", "c", "btb", "m"])
def test_merge_grams(readings, name, groups, field):
    """One SUM all-reduce over the axis (or both axes): every rank of a group
    holds the same bits, within f32 rounding of float64 sums over the
    group's rows, and the group's row count."""
    for rank, r in enumerate(readings):
        got = r[name][field]
        A, b = _rows(groups[rank])
        want = {"Q": A.T @ A, "c": A.T @ b, "btb": b @ b, "m": len(b)}[field]
        if field == "m":
            assert int(got) == want
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
        np.testing.assert_array_equal(got, readings[groups[rank][0]][name][field])


def test_merge_grams_in_a_one_rank_world_returns_local():
    import torch

    from fastoptsolver_tpu_torch.problems import DenseGram, merge_grams

    g = DenseGram(Q=torch.eye(2), c=torch.ones(2), btb=torch.tensor(1.0),
                  m=torch.tensor(3))
    assert merge_grams(g, mesh=None) is g
