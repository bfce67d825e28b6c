"""The resident engine's plain twin (``fastoptsolver_tpu_torch.kernels.resident``)
held against ``fastoptsolver_tpu.kernels.fista_gram_resident(...,
interpret=True)`` on one JAX ``GramBatch`` carried across by ``convert``, at
n ∈ {12, 112} and B = 130 (a ragged second tile), and the adaptive entry
``fista_gram_vmem_adaptive`` against the reference's adaptive kernel at
n = 20.

The twin runs at the reference's grouping, ``b_tile = 128`` (certified lanes
iterate until their group exits, so x depends on the grouping). Tolerances:
x to rtol 1e-5/atol 1e-5 on these well-conditioned inputs (AR(1) features,
ρ = 0.2; the fused engine's cross-package difference was 6.3e-6),
``converged`` identical, ``iters`` within one ``check_every``. Armijo runs in
the decisive regime of tests/test_kernel_armijo.py (noise-free b, L
understated 4×, 5 iterations), where every accept/reject has margin. Resume
in the port is bit-exact: 40 + 60 iterations equal 100 straight ones.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
from fastoptsolver_tpu.kernels import fista_gram_resident as jax_resident
from fastoptsolver_tpu.kernels import fista_vmem as jvmem
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch.kernels import fista_vmem as tvmem
from fastoptsolver_tpu_torch.kernels import resident
from fastoptsolver_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

B = 130
# name: (config fields, α₂); certified at rel_gap_tol 1e-5 (at 1e-6 the f32
# gap of a converged lane rounds about the tolerance, a coin flip between
# engines)
MODES = {
    "nesterov": (dict(), 0.0),
    "delta_ridge": (dict(momentum="delta"), 0.3),
    "restart": (dict(adaptive_restart=True), 0.0),
    "greedy": (dict(momentum="greedy"), 0.0),
}
CERT = dict(max_iter=300, check_every=25, rel_gap_tol=1e-5)


def _gram_fields(n, a2=0.0, seed=0, decisive=False):
    """Q, c, bᵀb in float64 rounded to float32, L = λ_max + α₂ from an
    eigensolver (understated 4× when ``decisive``). Regular inputs: AR(1)
    features (ρ = 0.2), a quarter of the features active, noise 2; decisive
    inputs: i.i.d. features, noise-free b, α₁ = 0.5."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 40
    A = rng.normal(size=(B, m, n))
    xt = np.zeros((B, n))
    if decisive:
        xt[:, :2] = rng.normal(size=(B, 2))
        b = np.einsum("bmn,bn->bm", A, xt)
        a1 = np.full(B, 0.5)
    else:
        for k in range(1, n):
            A[..., k] = 0.2 * A[..., k - 1] + np.sqrt(1 - 0.04) * A[..., k]
        xt[:, :max(n // 4, 1)] = rng.normal(size=(B, max(n // 4, 1)))
        b = np.einsum("bmn,bn->bm", A, xt) + 2.0 * rng.normal(size=(B, m))
        a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    Q = np.einsum("bmi,bmj->ijb", A, A)
    lam = np.linalg.eigvalsh(np.moveaxis(Q, -1, 0))[:, -1]
    f32 = lambda x: np.asarray(x, np.float32)
    return (f32(Q), f32(np.einsum("bmi,bm->ib", A, b)), f32((b * b).sum(1)), f32(a1),
            f32(np.full(B, a2)), f32(lam / (4.0 if decisive else 1.0) + a2))


def _pair(fields):
    return (JaxGramBatch(*(jnp.asarray(v) for v in fields)),
            convert.gram_batch_from_numpy(*fields))


@pytest.fixture(scope="module")
def grams():
    """(JAX, port) GramBatches per (n, α₂), and the decisive ones."""
    out = {}
    for n in (12, 112):
        for a2 in (0.0, 0.3):
            out[n, a2] = _pair(_gram_fields(n, a2, seed=n))
        out[n, "decisive"] = _pair(_gram_fields(n, seed=n + 1, decisive=True))
    return out


def _both(gbj, gbt, cfg_kw, est, **kw):
    cfg = JaxConfig(**cfg_kw)
    rj, sj = jax_resident(gbj, cfg, interpret=True, est_l_iters=est, return_state=True)
    rt, st = resident.fista_gram_resident_reference(
        gbt, convert.config_from_jax(cfg), est_l_iters=est, return_state=True,
        b_tile=128, **kw)
    return rj, sj, rt, st, cfg


@pytest.fixture(scope="module")
def certified(grams):
    """Every mode at both widths, with and without the in-kernel L."""
    return {(n, name, est): _both(*grams[n, a2], {**CERT, **kw}, est)
            for n in (12, 112) for name, (kw, a2) in MODES.items()
            for est in (None, 96)}


def _assert_matches(rj, rt, check_every, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    d_iters = np.abs(rt.iters.numpy().astype(np.int64) - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= check_every
    assert not rt.failed.any()


@pytest.mark.parametrize("est", [None, 96], ids=["external_L", "est_l_96"])
@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("n", [12, 112])
def test_resident_twin_matches_jax(certified, n, name, est):
    rj, sj, rt, st, cfg = certified[n, name, est]
    _assert_matches(rj, rt, cfg.check_every)
    assert rt.converged.all() and float(rt.rel_gap.max()) <= cfg.rel_gap_tol
    # per-lane k: each 128-lane group stops at its own burst boundary (a
    # burst apart where one lane's gap rounds about the tolerance, as iters)
    d_k = np.abs(st.k.numpy().astype(np.int64) - np.asarray(sj.k, np.int64))
    assert d_k.max() <= cfg.check_every
    assert len(set(st.k[:128].tolist())) == 1
    assert st.k.dtype == torch.int32 and st.done.dtype == torch.bool
    if name == "greedy":
        # the per-lane τ the safeguards shrink: on at most one lane a
        # borderline shrink decision (τ·0.96) goes the other way, with no
        # effect on x at the tolerance
        r = np.abs(st.t.numpy() / np.asarray(sj.t) - 1.0)
        assert (r > 1e-5).sum() <= 1


@pytest.mark.parametrize("kw", [dict(), dict(adaptive_restart=True)],
                         ids=["nesterov", "restart"])
@pytest.mark.parametrize("n", [12, 112])
def test_resident_armijo_decisive_matches_jax(grams, n, kw):
    gbj, gbt = grams[n, "decisive"]
    rj, sj, rt, st, cfg = _both(gbj, gbt, dict(max_iter=5, check_every=5,
                                               backtracking=True, **kw), None)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4, atol=1e-5)
    # the search fired: τ₀ = 4/L was refused on every lane
    assert bool((st.tau[0] < 0.9 / gbt.L).all())
    # the accepted τ, but on at most one lane whose step fell below 1e-6,
    # where the packages' rounding decides the last trial round
    r = np.abs(st.tau.numpy() / np.asarray(sj.tau) - 1.0)
    assert (r > 1e-6).sum() <= 1


def test_est_l_ignores_the_grams_l(grams):
    """With ``est_l_iters`` the engine estimates L from the Gram it holds:
    a sentinel L = 1 gives the same solve as the true L."""
    _, gbt = grams[112, 0.0]
    cfg = convert.config_from_jax(JaxConfig(**CERT))
    want = resident.fista_gram_resident_reference(gbt, cfg, est_l_iters=96)
    sentinel = dataclasses.replace(gbt, L=torch.ones_like(gbt.L))
    got = resident.fista_gram_resident_reference(sentinel, cfg, est_l_iters=96)
    assert torch.equal(got.x, want.x)


@pytest.mark.parametrize("kw", [dict(), dict(adaptive_restart=True),
                                dict(momentum="greedy"), dict(backtracking=True)],
                         ids=["nesterov", "restart", "greedy", "armijo"])
def test_resident_resume_is_bit_exact(grams, kw):
    """40 + 60 iterations through a ResidentSolveState equal 100 straight
    ones, bit for bit, at the kernel's grouping (the tolerance 1e-12 keeps
    every group running)."""
    _, gbt = grams[112, "decisive" if kw.get("backtracking") else 0.0]
    full = resident.BatchFISTAConfig(max_iter=100, check_every=20,
                                     rel_gap_tol=1e-12, **kw)
    straight, s100 = resident.fista_gram_resident(gbt, full, est_l_iters=96,
                                                  return_state=True)
    _, mid = resident.fista_gram_resident(
        gbt, dataclasses.replace(full, max_iter=40), est_l_iters=96,
        return_state=True)
    assert isinstance(mid, resident.ResidentSolveState)
    assert mid.k.shape == (B,) and bool((mid.k == 40).all())
    resumed, s = resident.fista_gram_resident(gbt, full, est_l_iters=96,
                                              state0=mid, return_state=True)
    assert torch.equal(resumed.x, straight.x)
    for f in ("Y", "t", "ps", "tau", "k", "done", "iters", "gap"):
        assert torch.equal(getattr(s, f), getattr(s100, f)), f


def test_certified_resume_keeps_the_record(grams):
    """A certified run cut at 50 iterations and resumed certifies the same
    lanes at the same burst boundaries as the straight run, groups that
    stopped early included."""
    _, gbt = grams[112, 0.0]
    cfg = resident.BatchFISTAConfig(**CERT)
    straight = resident.fista_gram_resident(gbt, cfg)
    _, mid = resident.fista_gram_resident(
        gbt, dataclasses.replace(cfg, max_iter=50), return_state=True)
    resumed = resident.fista_gram_resident(gbt, cfg, state0=mid)
    assert torch.equal(resumed.x, straight.x)
    assert torch.equal(resumed.iters, straight.iters)
    assert torch.equal(resumed.converged, straight.converged)


def test_regrouped_state_is_refused(grams):
    """``assert_tile_k_uniform``: a state whose groups stopped at different
    iterations resumes only under its own grouping."""
    _, gbt = grams[12, 0.0]
    cfg = resident.BatchFISTAConfig(**CERT)
    _, st = resident.fista_gram_resident_reference(gbt, cfg, b_tile=64,
                                                   return_state=True)
    assert st.k[0] != st.k[-1]  # the last group stopped apart
    with pytest.raises(ValueError, match="not uniform within lane tile"):
        resident.fista_gram_resident_reference(gbt, cfg, state0=st, b_tile=96)
    resident.fista_gram_resident_reference(gbt, cfg, state0=st, b_tile=64)


def test_jax_checkpoint_resumes_in_the_port(grams):
    """A JAX ResidentSolveState carried by ``resident_state_from_numpy`` and
    resumed on the port's twin (at the reference's grouping) matches the
    reference's own continued run."""
    gbj, gbt = grams[112, 0.0]
    half, full = JaxConfig(**{**CERT, "max_iter": 50}), JaxConfig(**CERT)
    _, mid = jax_resident(gbj, half, interpret=True, return_state=True)
    want = jax_resident(gbj, full, interpret=True, state0=mid)
    state = convert.resident_state_from_numpy(*(np.asarray(v) for v in mid))
    assert state.k.dtype == torch.int32 and state.done.dtype == torch.bool
    assert state.X.shape == (112, B) and state.t.shape == (1, B)
    # raw kernel outputs carry the reference's padding (n_pad rows, 256
    # lanes): n and B strip it
    padded = [np.pad(np.asarray(v), ((0, 0),) * (np.ndim(v) - 1) + ((0, 126),))
              for v in mid]
    padded[:2] = [np.pad(v, ((0, 8), (0, 0))) for v in padded[:2]]
    stripped = convert.resident_state_from_numpy(*padded, n=112, B=B)
    for f in state._fields:
        assert torch.equal(getattr(stripped, f), getattr(state, f)), f
    got = resident.fista_gram_resident_reference(
        gbt, convert.config_from_jax(full), state0=state, b_tile=128)
    _assert_matches(want, got, full.check_every)


def test_resident_guards():
    z = lambda *s: torch.zeros(s)
    gb = resident.GramBatch(Q=z(170, 170, 2), c=z(170, 2), btb=z(2), alpha1=z(2),
                            alpha2=z(2), L=torch.ones(2))
    with pytest.raises(ValueError, match="window"):
        resident.fista_gram_resident(gb)
    with pytest.raises(ValueError, match="check_every > 0"):
        resident.fista_gram_resident(gb, resident.BatchFISTAConfig(check_every=0))
    from fastoptsolver_tpu.kernels.resident import auto_b_tile_resident as jax_bt

    for n_pad in range(8, 200, 8):
        try:
            ref = jax_bt(n_pad)
        except ValueError:
            with pytest.raises(ValueError):
                resident.auto_b_tile_resident(n_pad)
        else:
            assert resident.auto_b_tile_resident(n_pad) == ref
    assert [resident.group_lanes(n) for n in (12, 96, 112, 128, 168)] == [32, 10, 8, 6, 3]
    assert counters()["launches.resident"] == 0


def test_twin_reads_the_upper_triangle(grams):
    """The twin reads each Gram's upper triangle, as the kernel holds it: on
    a Gram that is not bit-symmetric it gives, bit for bit, the solve of the
    Gram mirrored from its upper triangle; on a symmetric Gram the mirror is
    the Gram itself. On a CPU tensor the grouping is group_lanes."""
    _, gbt = grams[12, 0.0]
    g = torch.Generator().manual_seed(0)
    Q = gbt.Q * (1.0 + 1e-3 * torch.rand(gbt.Q.shape, generator=g))
    assert not torch.equal(Q, Q.transpose(0, 1))
    mirrored = resident.upper_symmetric(Q)
    n = Q.shape[0]
    for i in range(n):
        for k in range(n):
            assert torch.equal(mirrored[k, i], Q[min(k, i), max(k, i)])
    cfg = resident.BatchFISTAConfig(**CERT)
    got = resident.fista_gram_resident(dataclasses.replace(gbt, Q=Q), cfg, est_l_iters=96)
    want = resident.fista_gram_resident(dataclasses.replace(gbt, Q=mirrored), cfg,
                                        est_l_iters=96)
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
    sym = 0.5 * (gbt.Q + gbt.Q.transpose(0, 1))
    assert torch.equal(resident.upper_symmetric(sym), sym)
    assert resident.kernel_group(112, torch.device("cpu")) == resident.group_lanes(112)


@pytest.mark.parametrize("kw", [dict(adaptive_restart=True), dict(momentum="greedy")],
                         ids=["restart", "greedy"])
def test_adaptive_entry_matches_jax(kw):
    """``fista_gram_vmem_adaptive`` runs the resident machinery against the
    Gram's own L; at the reference's grouping (auto_b_tile lanes, capped at
    the padded batch: one 256-lane tile here) it matches the reference's
    adaptive kernel."""
    gbj, gbt = _pair(_gram_fields(20, seed=3))
    cfg = JaxConfig(**CERT, **kw)
    rj = jvmem.fista_gram_vmem_adaptive(gbj, cfg, interpret=True)
    rt = tvmem.fista_gram_vmem_adaptive(gbt, convert.config_from_jax(cfg), b_tile=256)
    _assert_matches(rj, rt, cfg.check_every)
    assert rt.converged.all()
    with pytest.raises(NotImplementedError):
        tvmem.fista_gram_vmem_adaptive(gbt, tvmem.BatchFISTAConfig(backtracking=True))
    with pytest.raises(ValueError, match="check_every"):
        tvmem.fista_gram_vmem_adaptive(gbt, tvmem.BatchFISTAConfig(check_every=0))
    wide = _pair(_gram_fields(112, seed=1))[1]
    with pytest.raises(ValueError, match="window"):
        tvmem.fista_gram_vmem_adaptive(wide, tvmem.BatchFISTAConfig())


def test_group_lanes_pinned_to_the_packed_layout():
    """The matvec's 16-byte aligned vectors (``round_up(n, 4)`` floats each)
    move no grouping: for every n = 1..168, ``group_lanes`` equals the rule
    on the layout of (n,) vectors it replaced, so x, which depends on the
    grouping, does not move."""
    def packed(n):
        nt = -(-n // 32) * 32
        lane = (n * (n + 1) // 2 + 2 * n + nt // 32 * resident.N_SUMS) * 4
        return min(32, 1024 // nt, 232448 // lane)

    window = range(1, resident.MAX_N + 1)
    assert [resident.group_lanes(n) for n in window] == [packed(n) for n in window]
    assert [resident.group_lanes(n) for n in (96, 112, 118, 128, 168)] == [10, 8, 7, 6, 3]


def _select_walk(n, i):
    """The triangle words the matvec read for feature i with a select every
    term: from (0, i), advancing n-1-k while k < i, then 1."""
    p, words = i, []
    for k in range(n):
        words.append(p)
        p += n - 1 - k if k < i else 1
    return words


def _segment_walk(n, i):
    """The words of ``csrc/tri_matvec.cuh``'s walk for feature i: base_k + i
    below the warp's diagonal block (base_k shared by the warp), the select
    inside it, base_i + k past it."""
    d0 = i & ~31
    d1 = min(d0 + 32, n)
    words, off = [], 0
    for k in range(d0):
        words.append(off + i)
        off += n - 1 - k
    p = off + i
    for k in range(d0, d1):
        words.append(p)
        p += n - 1 - k if k < i else 1
    base_i = i * (n - 1) - i * (i - 1) // 2
    return words + [base_i + k for k in range(d1, n)]


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 96, 113, 128, 150, 168])
def test_segment_walk_reads_the_select_walks_words(n):
    """The kernel's warp-uniform walk reads, term for term, the words of the
    select-every-term walk, and each is pair (min(k, i), max(k, i)) of the
    row-major upper triangle the twin mirrors (``upper_symmetric``): the
    same products in the same order, so the same sums."""
    index = {rc: w for w, rc in enumerate((r, c) for r in range(n) for c in range(r, n))}
    for i in range(n):
        words = _segment_walk(n, i)
        assert words == _select_walk(n, i)
        assert words == [index[min(k, i), max(k, i)] for k in range(n)]
