"""The Gram build's plain twin (``fastoptsolver_tpu_torch.kernels.gram_build``)
held against ``fastoptsolver_tpu.kernels.make_gram_batch_fused(...,
interpret=True)``, plus its window and host rule.

Tolerances: Q, c and bᵀb to 1e-5 of each lane's largest entry (the two sum
the m rows in other f32 orders); L to 1e-4 relative (both start the power
iteration at v0 = c, run the same number of steps and apply the same 1.02
factor, so only that rounding separates them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.kernels import gram_build as jgram
from fastoptsolver_tpu.kernels import make_gram_batch_fused as jax_build
from fastoptsolver_tpu_torch.batch.fista_gram import make_gram_batch
from fastoptsolver_tpu_torch.kernels import gram_build as tgram
from fastoptsolver_tpu_torch.kernels import resident
from fastoptsolver_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

# (n, m, B): the n <= 7 power depth (32), the first n past the fused kernel's
# envelope, and a ragged 200-lane batch (not a whole 128-lane tile)
SHAPES = [(5, 120, 384), (9, 33, 128), (20, 70, 200)]


def _problem(n, m, B, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B)).astype(np.float32)
    b = (np.einsum("nmb,nb->mb", A, rng.normal(size=(n, B)))
         + rng.normal(size=(m, B))).astype(np.float32)
    a1 = (0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)).astype(np.float32)
    return A, b, a1


@pytest.fixture(scope="module")
def built():
    """Both packages' GramBatch for every shape (α₂ = 0.3), computed once."""
    out = {}
    for i, shape in enumerate(SHAPES):
        A, b, a1 = _problem(*shape, seed=i)
        gj = jax_build(jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), 0.3,
                       interpret=True)
        gt = tgram.make_gram_batch_fused(torch.from_numpy(A), torch.from_numpy(b),
                                         torch.from_numpy(a1), 0.3, interpret=True)
        out[shape] = (gj, gt)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax_gram_build(built, shape):
    gj, gt = built[shape]
    n, _, B = shape
    Qj, cj, btbj = (np.asarray(v, np.float64) for v in (gj.Q, gj.c, gj.btb))
    assert gt.Q.shape == (n, n, B) and gt.c.shape == (n, B) and gt.btb.shape == (B,)
    scale = np.maximum(np.abs(Qj).max(axis=(0, 1)), btbj)  # per lane
    assert np.all(np.abs(gt.Q.numpy() - Qj) <= 1e-5 * scale)
    assert np.all(np.abs(gt.c.numpy() - cj) <= 1e-5 * scale)
    assert np.all(np.abs(gt.btb.numpy() - btbj) <= 1e-5 * scale)
    np.testing.assert_allclose(gt.L.numpy(), np.asarray(gj.L), rtol=1e-4)
    np.testing.assert_array_equal(gt.alpha2.numpy(), np.asarray(gj.alpha2))
    np.testing.assert_array_equal(gt.alpha1.numpy(), np.asarray(gj.alpha1))
    assert torch.equal(gt.Q, gt.Q.transpose(0, 1))  # both triangles, symmetric


def test_host_rule_and_power_depth():
    """L = where(λ > 0, 1.02·λ, 1) + α₂: a lane with b = 0 has c = 0, λ = 0
    and gets 1 + α₂; the power depth is 32 steps at n <= 7, else 96."""
    A, b, a1 = _problem(5, 40, 64, seed=3)
    b[:, 7] = 0.0
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    gb = tgram.make_gram_batch_fused(At, bt, 0.1, 0.25)
    assert float(gb.L[7]) == pytest.approx(1.25)
    _, _, _, lam = tgram.gram_build_reference(At, bt, 32)
    want = torch.where(lam > 0, 1.02 * lam, torch.ones_like(lam)) + 0.25
    assert torch.equal(gb.L, want)
    A9, b9, _ = _problem(9, 30, 16, seed=4)
    g96 = tgram.make_gram_batch_fused(torch.from_numpy(A9), torch.from_numpy(b9), 0.1, 0.0)
    lam96 = tgram.gram_build_reference(torch.from_numpy(A9), torch.from_numpy(b9), 96)[3]
    assert torch.equal(g96.L, 1.02 * lam96)
    # the CPU route never launches the kernels
    assert counters()["launches.gram_pairs"] == counters()["launches.gram_power"] == 0


def test_window_and_guards():
    for n in (1, 20, 96, 104, tgram.MAX_N):
        assert tgram._auto_tiles(n, 70) == (32, 70)
    # with power steps the window stays where 8 lanes' triangles filled
    # 227 KB, though gram_power's block now holds lanes past it; gram_pairs
    # alone takes the resident engine's window
    assert tgram.MAX_N == 118
    assert tgram.PAIRS_MAX_N == resident.MAX_N == 168
    for n in range(1, tgram.POWER_MAX_N + 1):
        assert 0 < tgram._power_smem_bytes(n) <= tgram.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="torch precompute"):
        tgram._auto_tiles(tgram.MAX_N + 1, 70)
    A = torch.ones((5, 16, 32))
    with pytest.raises(ValueError, match="split_k"):
        tgram.make_gram_batch_fused(A, torch.ones((16, 32)), 0.1, 0.0, split_k=0)
    with pytest.raises(ValueError, match="torch precompute"):
        tgram.make_gram_batch_fused(torch.ones((130, 4, 8)), torch.ones((4, 8)), 0.1, 0.0)
    with pytest.raises(ValueError, match="CUDA"):  # the CUDA wrapper refuses a CPU tensor
        tgram._launch(A, torch.ones((16, 32)), 32)
    assert tgram.LANE_TILE == 32
    # the reference's window is narrower (its VMEM budget ends at n = 80 for
    # m = 200): the port's covers it and the burst window past it
    for n in (5, 64, 80):
        jgram._auto_tiles(n, 200)
        tgram._auto_tiles(n, 200)
    with pytest.raises(ValueError):
        jgram._auto_tiles(96, 200)
    assert tgram._auto_tiles(96, 200) == (32, 200)


@pytest.mark.parametrize("m", [1, 70, 238])
def test_windows_by_estimate(m):
    """The window follows whether the build estimates L: gram_pairs alone
    (pl_iters = 0) takes n <= 168 and raises at 169; with power steps (the
    default depth or any other) the build takes n <= 118 and raises at 119,
    as it did. Each message names its own window."""
    assert tgram._auto_tiles(168, m, 0) == (32, m)
    with pytest.raises(ValueError, match=r"pl_iters=0\): n=169 is past its window "
                                         r"\(n <= 168\)\. Use the torch precompute"):
        tgram._auto_tiles(169, m, 0)
    for pl_iters in (None, 1, 96):
        assert tgram._auto_tiles(118, m, pl_iters) == (32, m)
        with pytest.raises(ValueError, match=r"fused Gram build: n=119 is past its "
                                             r"window \(n <= 118\)\. Use the torch precompute"):
            tgram._auto_tiles(119, m, pl_iters)


def _routed_inputs(n, B=8, seed=11):
    """(B, m, n) instances, m = 2n, and α₁ = 0.1‖Aᵀb‖∞ a lane."""
    A, b, a1 = _problem(n, 2 * n, B, seed)
    return (torch.from_numpy(A.transpose(2, 1, 0).copy()), torch.from_numpy(b.T.copy()),
            torch.from_numpy(a1))


def _spy_builds(monkeypatch):
    """Record each build the router takes: the fused build's twin with its
    power depth, and the torch precompute."""
    from fastoptsolver_tpu_torch.batch import api

    calls = []
    twin, precompute = tgram.gram_build_reference, api.make_gram_batch
    monkeypatch.setattr(tgram, "gram_build_reference",
                        lambda A, b, pl_iters: calls.append(("twin", pl_iters))
                        or twin(A, b, pl_iters))
    monkeypatch.setattr(api, "make_gram_batch",
                        lambda *a, **k: calls.append(("precompute",)) or precompute(*a, **k))
    return api, calls


@pytest.mark.parametrize("n", [128, 168])
def test_resident_route_builds_with_the_pairs_twin(monkeypatch, n):
    """Without an estimate of L (the resident route) the router builds the
    whole resident window with the fused build's pairs (its twin on the CPU),
    not the einsum precompute: the L = 1 sentinel, a Q that is exactly
    symmetric, and Q, c and bᵀb at the einsum's within this file's f32
    tolerance."""
    api, calls = _spy_builds(monkeypatch)
    A, b, a1 = _routed_inputs(n)
    gb = api._build_gram_routed(A, b, a1, 0.0, False, None, True, use_kernel=True,
                                estimate_l=False)
    assert calls == [("twin", 0)]
    want = make_gram_batch(A, b, a1, 0.0, estimate_l=False)
    assert bool((gb.L == 1.0).all())
    assert torch.equal(gb.Q, gb.Q.transpose(0, 1))
    scale = torch.maximum(want.Q.abs().amax(dim=(0, 1)), want.btb)  # per lane
    for got, ref in ((gb.Q, want.Q), (gb.c, want.c), (gb.btb, want.btb)):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("n", [119, 128])
def test_estimating_route_keeps_the_precompute_past_118(monkeypatch, n):
    """With the estimate (the burst and Q-streaming routes) the window stays
    at 118: past it the router takes the torch precompute, power loop and
    all."""
    api, calls = _spy_builds(monkeypatch)
    A, b, a1 = _routed_inputs(n)
    gb = api._build_gram_routed(A, b, a1, 0.0, False, None, True, use_kernel=True)
    assert calls == [("precompute",)]
    assert not bool((gb.L == 1.0).all())


def test_power_group_lanes():
    """gram_power's lanes a CTA on the resident layout: 1024 threads
    (round_up(n, 32) a lane) and 227 KB (two round_up(n, 4) vectors and the
    triangle a lane) bound it, 32 at most; its shared bytes are the group's."""
    widths = (1, 5, 31, 32, 33, 64, 96, 113, 118, 128)
    assert [tgram.power_group_lanes(n) for n in widths] == [32, 32, 32, 32, 16, 16, 10, 8, 8, 6]
    assert tgram._power_smem_bytes(96) == 10 * (2 * 96 + 96 * 97 // 2) * 4
    assert tgram._power_smem_bytes(118) == 8 * (2 * 120 + 118 * 119 // 2) * 4
    for n in (0, tgram.POWER_MAX_N + 1):
        with pytest.raises(ValueError, match="gram_power"):
            tgram.power_group_lanes(n)


def test_pairs_ring_fits_two_ctas():
    """gram_pairs' ring: at least three 32 KB stages (copies of two ahead in
    flight while one is summed), and two CTAs' rings within the shared memory
    a Hopper block may opt into, so 2 CTAs of 256 threads share an SM."""
    assert tgram.PAIRS_STAGES >= 3
    assert tgram._pairs_smem_bytes() == tgram.PAIRS_STAGES * 32 * 1024
    assert 2 * tgram._pairs_smem_bytes() <= tgram.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", [(9, 33, 301), (20, 7, 203), (64, 128, 256),
                                   (15, 40, 64), (31, 9, 37)])
def test_pairs_l2_bytes_count_the_kernels_copies(shape):
    """``_pairs_work``'s L2 bytes equal the copies of csrc/gram_build.cu's
    gram_pairs that read something: per block pair (I ≤ K) and lane tile, the
    32 staged features of blocks I and K, for every row of every 8-row stage,
    a copy reading only lanes < B of features < n + 1 and rows < m."""
    n, m, B = shape
    na, nb = n + 1, -(-(n + 1) // 16)
    lanes = sum(min(32, B - t) for t in range(0, B, 32))
    rows = sum(1 for r in range(-(-m // 8) * 8) if r < m)
    feats = sum(1 for i in range(nb) for k in range(i, nb) for f in range(32)
                if (i * 16 + f if f < 16 else k * 16 + f - 16) < na)
    assert tgram._pairs_work(n, m, B)["l2_bytes"] == 4 * lanes * rows * feats


def test_pairs_work_at_the_wide_shape():
    """The wide-n cell's counts: 6.05 GB of device traffic, 9.9e10 flops of
    distinct pair sums, and 32.3 GB copied from L2 (each of the 7 feature
    blocks staged 8 times a lane tile: 8 × 97 features × 192 rows × 128 B ×
    1692 lane tiles)."""
    w = tgram._pairs_work(96, 192, 54144)
    assert w["l2_bytes"] == 8 * 97 * 192 * 128 * 1692
    assert w["bytes"] == 4 * 54144 * (96 * 192 + 192 + 96 * 96 + 96 + 1)
    assert w["flops"] == 54144 * 192 * 97 * 98
