"""The Q-streaming engine's plain twin (``fastoptsolver_tpu_torch.kernels.qstream``)
held against ``fastoptsolver_tpu.kernels.qstream.qstream_burst(...,
interpret=True)`` at n ∈ {120, 200}, B = 130 (a ragged lane tile on the JAX
side, which pads to its 256-lane tile), and the certified solve through
``fista_gram_vmem`` against the reference's on the same Gram.

Tolerances: one burst from a non-trivial state, every output to rtol
2e-4/atol 2e-5 (the JAX package's own kernel-vs-driver tolerance,
tests/test_kernels.py:57-59); certified runs ``converged`` identical,
``iters`` within one ``check_every``, x to rtol 2e-4/atol 2e-5. Resume in the
port is bit-exact.

The routed call at the ``wide256`` benchmark cell's widths (n = 256, m = 512)
on 8 lanes, the torch Gram precompute then the twin, is held against the
benchmark's plain float64 reference by the cell's own limits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
from fastoptsolver_tpu.kernels import fista_vmem as jvmem
from fastoptsolver_tpu.kernels import qstream as jqstream
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch.kernels import fista_vmem as tvmem
from fastoptsolver_tpu_torch.kernels import qstream
from fastoptsolver_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

B = 130
STEPS = 10
# name: (config fields, α₂)
MODES = {
    "nesterov": (dict(), 0.0),
    "delta_ridge": (dict(momentum="delta"), 0.3),
    "restart": (dict(adaptive_restart=True), 0.0),
    "greedy": (dict(momentum="greedy"), 0.0),
}


def _gram_fields(n, a2, seed):
    """The reference's wide-n test recipe (tests/test_qstream.py:_wide_problem)
    in numpy: A ~ N(0, 1/n), an n/8-sparse noise-free signal, α₁ =
    0.1·‖Aᵀb‖∞; Q, c, bᵀb in float64 rounded to float32, L = λ_max + α₂."""
    rng = np.random.default_rng(seed)
    m = 300
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    xt = np.zeros((B, n))
    xt[:, : n // 8] = rng.normal(size=(B, n // 8))
    b = np.einsum("bmn,bn->bm", A, xt)
    a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    Q = np.einsum("bmi,bmj->ijb", A, A)
    lam = np.linalg.eigvalsh(np.moveaxis(Q, -1, 0))[:, -1]
    f32 = lambda x: np.asarray(x, np.float32)
    return (f32(Q), f32(np.einsum("bmi,bm->ib", A, b)), f32((b * b).sum(1)), f32(a1),
            f32(np.full(B, a2)), f32(lam + a2))


@pytest.fixture(scope="module")
def grams():
    return {(n, a2): _gram_fields(n, a2, seed=n) for n in (120, 200) for a2 in (0.0, 0.3)}


def _burst_inputs(fields, cfg):
    """The per-lane rows of one burst (fista_vmem's rules) and a non-trivial
    state, made with numpy."""
    Q, c, btb, a1, a2, L = fields
    n = c.shape[0]
    greedy = cfg.momentum == "greedy"
    tau = ((cfg.greedy_xi if greedy else cfg.t_init_factor) / L)[None, :]
    rng = np.random.default_rng(7)
    X = (0.1 * rng.normal(size=(n, B))).astype(np.float32)
    Y = (X + 0.01 * rng.normal(size=(n, B))).astype(np.float32)
    rows = dict(tau=tau, thr=tau * a1[None, :], a2=a2[None, :], a1=a1[None, :],
                btb=btb[None, :], taumin=(1.0 / L)[None, :],
                t=tau if greedy else np.full_like(tau, 1.7), ps=np.full_like(tau, 0.05))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in rows.items()}, X, Y


def _static(cfg):
    return dict(restart_threshold=cfg.restart_threshold if cfg.adaptive_restart else None,
                greedy=(cfg.greedy_S, cfg.greedy_shrink) if cfg.momentum == "greedy" else None)


@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("n", [120, 200])
def test_qstream_burst_matches_jax(grams, n, name):
    kw, a2 = MODES[name]
    fields = grams[n, a2]
    cfg = JaxConfig(max_iter=100, check_every=STEPS, **kw)
    rows, X, Y = _burst_inputs(fields, cfg)
    betas, _ = tvmem.momentum_betas(0, 20, 1.0, cfg)
    n_pad = (n + 7) // 8 * 8
    b_tile, g = jqstream.auto_tiles_qstream(n_pad)
    pB = -B % b_tile
    pad2 = lambda v, rows_to=None, fill=0.0: jnp.asarray(np.pad(
        v, ((0, (rows_to or v.shape[0]) - v.shape[0]), (0, pB)), constant_values=fill))
    Qp = jnp.asarray(np.pad(fields[0], ((0, n_pad - n), (0, n_pad - n), (0, pB))))
    jrow = {k: pad2(v, fill=1.0 if k in ("tau", "taumin", "t") else 0.0)
            for k, v in rows.items()}
    out_j = jqstream.qstream_burst(
        jnp.asarray(betas.numpy()), jnp.asarray([STEPS], jnp.int32), Qp,
        pad2(fields[1], n_pad), jrow["tau"], jrow["thr"], jrow["a2"], jrow["a1"],
        jrow["btb"], pad2(X, n_pad), pad2(Y, n_pad), jrow["t"], jrow["ps"],
        jrow["taumin"], jrow["tau"], n_pad=n_pad, b_tile=b_tile, g_planes=g,
        n_steps=STEPS, interpret=True, with_gap=True, **_static(cfg))
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    out_t = qstream.qstream_burst(
        betas, STEPS, torch.from_numpy(fields[0]), torch.from_numpy(fields[1]),
        t["tau"], t["thr"], t["a2"], t["a1"], t["btb"], torch.from_numpy(X),
        torch.from_numpy(Y), t["t"], t["ps"], t["taumin"], t["tau"],
        n_steps=STEPS, with_gap=True, **_static(cfg))
    for label, got, want in zip(("X", "Y", "t", "ps", "tau", "gap"), out_t, out_j):
        want = np.asarray(want)[: got.shape[0], :B]
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5,
                                   err_msg=label)


@pytest.fixture(scope="module")
def certified(grams):
    """The certified solve through fista_gram_vmem on both sides: the
    Q-streaming engine at n = 200, and at n = 120 (inside the resident
    window) the fixed-iteration run that the plan sends to it too."""
    out = {}
    for n, cfg_kw in ((200, dict(max_iter=600, check_every=25, rel_gap_tol=5e-6)),
                      (120, dict(max_iter=60, check_every=0))):
        fields = grams[n, 0.0]
        gbj = JaxGramBatch(*(jnp.asarray(v) for v in fields))
        gbt = convert.gram_batch_from_numpy(*fields)
        for name in ("nesterov", "restart", "greedy"):
            cfg = JaxConfig(**cfg_kw, **MODES[name][0])
            assert jvmem.plan_gram_solve(n, cfg)[0] == "qstream"
            out[n, name] = (jvmem.fista_gram_vmem(gbj, cfg, interpret=True),
                            tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg),
                                                  interpret=True), cfg)
    return out


@pytest.mark.parametrize("name", ["nesterov", "restart", "greedy"])
@pytest.mark.parametrize("n", [120, 200])
def test_qstream_solve_matches_jax(certified, n, name):
    rj, rt, cfg = certified[n, name]
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=2e-4, atol=2e-5)
    if cfg.check_every <= 0:
        # a fixed run certifies afterwards, at 1e-6, where the f32 gap of
        # these lanes is rounding noise (test_torch_fista_vmem's fixed runs)
        np.testing.assert_allclose(rt.rel_gap.numpy(), np.asarray(rj.rel_gap),
                                   rtol=1e-2, atol=1e-5)
    else:
        np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
        d_iters = np.abs(rt.iters.numpy().astype(np.int64) - np.asarray(rj.iters, np.int64))
        assert d_iters.max() <= cfg.check_every
        assert rt.converged.all()
    assert int(rt.n_iters_total) == int(rj.n_iters_total)


@pytest.mark.parametrize("n, kw", [(200, dict()), (200, dict(adaptive_restart=True)),
                                   (120, dict(momentum="greedy"))],
                         ids=["200-nesterov", "200-restart", "120-greedy"])
def test_qstream_resume_is_bit_exact(grams, n, kw):
    """40 + 60 iterations through a VmemSolveState equal 100 straight ones."""
    gbt = convert.gram_batch_from_numpy(*grams[n, 0.0])
    full = tvmem.BatchFISTAConfig(max_iter=100, check_every=0, **kw)
    straight, s100 = tvmem.fista_gram_vmem(gbt, full, return_state=True)
    _, mid = tvmem.fista_gram_vmem(gbt, dataclasses.replace(full, max_iter=40),
                                   return_state=True)
    assert isinstance(mid, tvmem.VmemSolveState) and int(mid.k) == 40
    resumed, s = tvmem.fista_gram_vmem(gbt, full, state0=mid, return_state=True)
    assert torch.equal(resumed.x, straight.x)
    for f in ("Y", "t", "ps", "tau", "done", "iters", "gap"):
        assert torch.equal(getattr(s, f), getattr(s100, f)), f


def test_vmem_state_pins_qstream_in_the_resident_window(grams, monkeypatch):
    """At n = 120 a certified config plans the resident engine, but a
    VmemSolveState resumes on the Q-streaming engine that produced it, as in
    the reference (fista_vmem.py:644-649)."""
    gbt = convert.gram_batch_from_numpy(*grams[120, 0.0])
    cfg = tvmem.BatchFISTAConfig(max_iter=100, check_every=25)
    assert tvmem.plan_gram_solve(120, cfg)[0] == "resident"
    _, mid = tvmem.fista_gram_vmem(gbt, tvmem.BatchFISTAConfig(max_iter=50, check_every=0),
                                   return_state=True)
    calls = []
    twin = qstream._qstream_burst_reference
    monkeypatch.setattr(qstream, "_qstream_burst_reference",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    _, fin = tvmem.fista_gram_vmem(gbt, cfg, state0=mid, return_state=True)
    assert isinstance(fin, tvmem.VmemSolveState) and len(calls) == 2  # 2 bursts


def test_qstream_refuses_armijo(grams):
    gbt = convert.gram_batch_from_numpy(*grams[200, 0.0])
    with pytest.raises(NotImplementedError, match="torch driver"):
        tvmem.fista_gram_vmem(gbt, tvmem.BatchFISTAConfig(backtracking=True))
    row = torch.ones((1, B))
    with pytest.raises(NotImplementedError, match="data-dependent"):
        qstream.qstream_burst(torch.zeros(10), 0, gbt.Q, gbt.c, row, row, row, row,
                              row, gbt.c, gbt.c, row, row, None, row, n_steps=5,
                              armijo=(1e-2, 0.5, 20))
    with pytest.raises(ValueError, match="CUDA"):
        qstream._launch_qstream(torch.zeros(10), 0, gbt.Q, gbt.c, row, row, row, row,
                                row, gbt.c, gbt.c, row, row, None, row, n_steps=5)
    assert counters()["launches.qstream"] == 0


def test_tiles_agree_with_jax():
    for n_pad in list(range(8, 1025, 8)) + [1032, 2048]:
        try:
            want = jqstream.auto_tiles_qstream(n_pad)
        except ValueError:
            with pytest.raises(ValueError, match="window"):
                qstream.auto_tiles_qstream(n_pad)
        else:
            assert qstream.auto_tiles_qstream(n_pad) == want, n_pad


@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("n", [120, 256, 600])
def test_relayout_puts_each_entry_in_its_slab(n, C):
    """Qt[l, f // F, k, f % F] = Q[k, f, l], zeros where r·F + j ≥ n: each
    CTA's slab of the cluster kernel is one contiguous block."""
    Bs = 3
    Q = torch.from_numpy(np.random.default_rng(n + C).normal(size=(n, n, Bs)).astype(np.float32))
    Qt = qstream.relayout(Q, C)
    F = qstream.slab_features(n, C)
    assert F % 4 == 0 and F >= -(-n // C) and Qt.shape == (Bs, C, n, F) and Qt.is_contiguous()
    f = np.arange(n)
    got = Qt.numpy()[:, f // F, :, f % F]  # (n_f, B, n_k): advanced indices lead
    np.testing.assert_array_equal(got, Q.numpy().transpose(1, 2, 0))
    flat = Qt.numpy().transpose(1, 3, 0, 2).reshape(C * F, Bs, n)
    assert not flat[n:].any()


def test_slab_features():
    assert [qstream.slab_features(n, C) for n, C in
            ((1, 1), (120, 2), (200, 4), (256, 4), (256, 8), (660, 8), (661, 8))] == \
        [4, 60, 52, 64, 32, 84, 84]


def test_cpu_solve_runs_the_twin_on_q_unchanged(grams, certified, monkeypatch):
    """On a CPU tensor the engine keeps Q as it is (no re-layout): every
    burst gets the Gram's own (n, n, B) Q, and the result is the one held
    against the JAX reference in test_qstream_solve_matches_jax."""
    gbt = convert.gram_batch_from_numpy(*grams[120, 0.0])
    assert qstream.make_burst(gbt.Q) is qstream.qstream_burst
    seen = []
    twin = qstream._qstream_burst_reference
    monkeypatch.setattr(qstream, "_qstream_burst_reference",
                        lambda *a, **k: seen.append(a[2]) or twin(*a, **k))
    rj, _, cfg = certified[120, "nesterov"]
    rt = tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg))
    assert seen and all(q.shape == (120, 120, B) and torch.equal(q, gbt.Q) for q in seen)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=2e-4, atol=2e-5)


def test_routed_call_at_wide256_widths_holds_to_the_plain_reference(monkeypatch):
    """``solve_lasso_batch(..., interpret=True, feature_major=True)`` on 8
    lanes of the cell's recipe at its published widths takes the torch
    precompute (its power loop) and the Q-streaming twin; every certified
    lane's float64 gap at the returned x is within the cell's ``gap_max``
    and its ``(f(x) − f*)/max(f*, 1)`` within ``subopt_max``, f* the
    reference's float64 optimum."""
    from benchmark import spec
    from benchmark.reference import lasso
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch

    cell = spec.cell("wide256.bench")
    cfg = cell.config
    A, b, a1 = spec.recipe(cfg)(torch.Generator().manual_seed(2**31 + 21), 8, m=cfg["m"],
                                n=cfg["n"], **cfg["recipe_params"],
                                **cell.traffic["recipe_params"])
    assert A.shape == (256, 512, 8)
    bursts = []
    twin = qstream._qstream_burst_reference
    monkeypatch.setattr(qstream, "_qstream_burst_reference",
                        lambda *a, **k: bursts.append(1) or twin(*a, **k))
    steps = counters()["power_steps"]
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=BatchFISTAConfig(**cfg["solver"]),
                            feature_major=True, interpret=True)
    assert bursts and counters()["power_steps"] > steps
    conv = res.converged
    assert int(conv.sum()) >= 4, res.rel_gap
    gap, f = lasso.rel_gap(A, b, a1, res.x)
    assert float(gap[conv].max()) <= cell.limits["gap_max"]
    _, f_opt, gap_opt = lasso.optimum(A, b, a1, torch.arange(8))
    assert float(gap_opt.max()) <= 1e-9
    subopt = (f - f_opt) / f_opt.clamp_min(1.0)
    assert float(subopt[conv].max()) <= cell.limits["subopt_max"]
