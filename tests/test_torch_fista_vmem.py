"""The burst engine's plain twin (``fastoptsolver_tpu_torch.kernels.fista_vmem``)
held against ``fastoptsolver_tpu.kernels.fista_gram_vmem(..., interpret=True)``
on one JAX ``GramBatch`` carried across by ``convert`` (n = 20, B = 256).

Tolerances: fixed runs (``check_every=0``) x to rtol 2e-4/atol 2e-5, the JAX
package's own kernel-vs-driver tolerance (tests/test_kernels.py:57-59);
Armijo in the decisive regime of tests/test_kernel_armijo.py (its noise-free
recipe, L understated 4×, 5 iterations, so every accept/reject has margin)
x to rtol 1e-4/atol 1e-5 and the accepted τ to 1e-6; certified runs
``converged`` identical and ``iters`` within one ``check_every``. Resume in the port is bit-exact: 40 + 60
iterations equal 100 straight ones. The slab tests run the solve's kernel
route on the CPU: Q answers ``is_cuda`` and a recording stand-in in place of
``_launch_burst`` runs the twin.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import burst_grouping
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
from fastoptsolver_tpu.kernels import fista_vmem as jvmem
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch.batch import GramBatch
from fastoptsolver_tpu_torch.kernels import fista_vmem as tvmem
from fastoptsolver_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

N, B, M = 20, 256, 60
GB_FIELDS = ("Q", "c", "btb", "alpha1", "alpha2", "L")

# name: (config fields, Gram, max_iter). Armijo runs 5 iterations of the
# decisive regime: later, borderline accepts make the recurrence chaotic in
# either package (tests/test_kernel_armijo.py::
# test_armijo_chaos_is_intrinsic_not_kernel_error)
FIXED = {
    "nesterov": (dict(), "lasso", 100),
    "delta_ridge": (dict(momentum="delta"), "ridge", 100),
    "restart": (dict(adaptive_restart=True), "lasso", 100),
    "greedy": (dict(momentum="greedy"), "lasso", 100),
    "armijo": (dict(backtracking=True), "decisive", 5),
    "armijo_restart": (dict(backtracking=True, adaptive_restart=True), "decisive", 5),
}
# name: (config fields, Gram)
CERTIFIED = {
    "nesterov": (dict(), "lasso"),
    "delta_ridge": (dict(momentum="delta"), "ridge"),
    "restart": (dict(adaptive_restart=True), "lasso"),
    "greedy": (dict(momentum="greedy"), "lasso"),
    "armijo": (dict(backtracking=True), "lasso"),
}


def _inputs():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, M, N))
    for k in range(1, N):  # AR(1) features, ρ = 0.3
        A[..., k] = 0.3 * A[..., k - 1] + np.sqrt(1 - 0.09) * A[..., k]
    xt = np.zeros((B, N))
    xt[:, :4] = rng.normal(size=(B, 4))
    b = np.einsum("bmn,bn->bm", A, xt) + 2.0 * rng.normal(size=(B, M))
    a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    return A.astype(np.float32), b.astype(np.float32), a1.astype(np.float32)


def _decisive_inputs():
    """tests/test_kernel_armijo.py:_problem at n = 20: noise-free b, α₁ = 0.5."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, 150, N)).astype(np.float32)
    xt = np.zeros((B, N), np.float32)
    xt[:, :2] = rng.normal(size=(B, 2))
    return A, np.einsum("bmn,bn->bm", A, xt).astype(np.float32), 0.5


def _gram(A, b, a1, a2, l_div=1.0):
    """A JAX GramBatch made in numpy (no JAX compile): Q, c, bᵀb in float64
    rounded to float32, L = λ_max(Q)/l_div + α₂ from an eigensolver."""
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    Q = np.einsum("bmi,bmj->ijb", A64, A64)
    lam = np.linalg.eigvalsh(np.moveaxis(Q, -1, 0))[:, -1]
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    return JaxGramBatch(Q=f32(Q), c=f32(np.einsum("bmi,bm->ib", A64, b64)),
                        btb=f32((b64 * b64).sum(1)), alpha1=f32(np.broadcast_to(a1, (B,))),
                        alpha2=f32(np.full(B, a2)), L=f32(lam / l_div + a2))


@pytest.fixture(scope="module")
def grams():
    """JAX GramBatches with port copies: "lasso" (α₂ = 0), "ridge" (α₂ =
    0.3) and "decisive" (L understated 4×)."""
    A, b, a1 = _inputs()
    js = {"lasso": _gram(A, b, a1, 0.0), "ridge": _gram(A, b, a1, 0.3),
          "decisive": _gram(*_decisive_inputs(), 0.0, l_div=4.0)}
    return {k: (g, convert.gram_batch_from_numpy(
        *(np.asarray(getattr(g, f)) for f in GB_FIELDS))) for k, g in js.items()}


def _solve_both(grams, kw, gram, **cfg_kw):
    gbj, gbt = grams[gram]
    cfg = JaxConfig(**{**cfg_kw, **kw})
    rj, sj = jvmem.fista_gram_vmem(gbj, cfg, b_tile=128, interpret=True,
                                   return_state=True)
    rt, st = tvmem.fista_gram_vmem(gbt, convert.config_from_jax(cfg),
                                   interpret=True, return_state=True)
    return rj, sj, rt, st, cfg


@pytest.fixture(scope="module")
def fixed_runs(grams):
    return {name: _solve_both(grams, kw, gram, max_iter=k, check_every=0)
            for name, (kw, gram, k) in FIXED.items()}


@pytest.fixture(scope="module")
def certified_runs(grams):
    # the gap of these lanes rounds in steps of ~5e-7 near the optimum, so at
    # 1e-6 certification is a coin flip (the JAX kernel and the JAX driver
    # differ by two bursts there); 1e-5 holds the engines to the tolerance
    return {name: _solve_both(grams, kw, gram, max_iter=1000, check_every=25,
                              rel_gap_tol=1e-5)
            for name, (kw, gram) in CERTIFIED.items()}


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_run_matches_jax(fixed_runs, name):
    rj, sj, rt, st, cfg = fixed_runs[name]
    armijo = name.startswith("armijo")
    rtol, atol = (1e-4, 1e-5) if armijo else (2e-4, 2e-5)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=rtol, atol=atol)
    assert int(rt.n_iters_total) == int(rj.n_iters_total) == cfg.max_iter
    for f in ("X", "Y", "t", "ps", "tau"):
        assert tuple(getattr(st, f).shape) == np.asarray(getattr(sj, f)).shape, f
    if armijo:
        # one lane of 256 has driven its step below 1e-7, where even the JAX
        # kernel and the JAX driver disagree on the accepted τ
        r = np.abs(st.tau.numpy() / np.asarray(sj.tau) - 1.0)
        assert (r > 1e-6).sum() <= 1
    if name == "greedy":  # the per-lane τ row the greedy safeguard shrinks
        np.testing.assert_allclose(st.t.numpy(), np.asarray(sj.t), rtol=1e-5)
    # near the optimum the f32 gap is rounding noise of ~1e-6 (its terms
    # cancel), so it is held at that scale
    np.testing.assert_allclose(rt.rel_gap.numpy(), np.asarray(rj.rel_gap),
                               rtol=1e-2, atol=1e-5)


def test_armijo_search_fired(fixed_runs, grams):
    """Teeth for the Armijo cases: τ₀ = 1/L_low = 4/L was refused on every
    lane, so the accepted τ is below it."""
    _, gbt = grams["decisive"]
    for name in ("armijo", "armijo_restart"):
        st = fixed_runs[name][3]
        assert bool((st.tau[0] < 0.9 / gbt.L).all())


@pytest.mark.parametrize("name", list(CERTIFIED))
def test_certified_run_matches_jax(certified_runs, name):
    rj, sj, rt, st, cfg = certified_runs[name]
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    d_iters = np.abs(rt.iters.numpy().astype(np.int64) - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= cfg.check_every
    assert not rt.failed.any()
    if name == "armijo":
        # the reference's Armijo stall on lasso (ROADMAP Queue 3, not a
        # fault): τ never grows, and neither package certifies these lanes
        assert not rt.converged.any() and int(st.k) == cfg.max_iter
        return
    assert rt.converged.all()
    assert float(rt.rel_gap.max()) <= cfg.rel_gap_tol
    assert int(st.k) % cfg.check_every == 0 and int(st.k) == int(rt.iters.max())
    np.testing.assert_array_equal(st.done.numpy(), np.asarray(sj.done))


@pytest.mark.parametrize("kw", [dict(), dict(adaptive_restart=True),
                                dict(momentum="greedy"), dict(backtracking=True)],
                         ids=["nesterov", "restart", "greedy", "armijo"])
def test_resume_is_bit_exact(grams, kw):
    """40 + 60 iterations through a VmemSolveState equal 100 straight ones,
    bit for bit (mirrors tests/test_kernels.py::test_vmem_kernel_resume_is_exact)."""
    _, gbt = grams["decisive" if kw.get("backtracking") else "lasso"]
    full = convert.config_from_jax(JaxConfig(max_iter=100, check_every=0, **kw))
    half = convert.config_from_jax(JaxConfig(max_iter=40, check_every=0, **kw))
    straight, s100 = tvmem.fista_gram_vmem(gbt, full, interpret=True, return_state=True)
    _, mid = tvmem.fista_gram_vmem(gbt, half, interpret=True, return_state=True)
    assert isinstance(mid, tvmem.VmemSolveState) and int(mid.k) == 40
    resumed, s = tvmem.fista_gram_vmem(gbt, full, interpret=True, state0=mid,
                                       return_state=True)
    assert torch.equal(resumed.x, straight.x)
    for f in ("Y", "t", "ps", "tau", "gap"):
        assert torch.equal(getattr(s, f), getattr(s100, f)), f
    assert int(resumed.n_iters_total) == 100


def test_certified_resume_keeps_the_record(grams):
    """A certified run cut at 50 iterations and resumed certifies the same
    lanes at the same burst boundaries as the straight run."""
    _, gbt = grams["lasso"]
    cfg = convert.config_from_jax(JaxConfig(max_iter=1000, check_every=25))
    straight = tvmem.fista_gram_vmem(gbt, cfg, interpret=True)
    cut = convert.config_from_jax(JaxConfig(max_iter=50, check_every=25))
    _, mid = tvmem.fista_gram_vmem(gbt, cut, interpret=True, return_state=True)
    resumed = tvmem.fista_gram_vmem(gbt, cfg, interpret=True, state0=mid)
    assert torch.equal(resumed.x, straight.x)
    assert torch.equal(resumed.iters, straight.iters)
    assert torch.equal(resumed.converged, straight.converged)


def test_jax_checkpoint_resumes_in_the_port(grams, fixed_runs):
    """A JAX mid-run state carried by ``vmem_state_from_numpy`` and resumed
    in the port matches JAX's straight 100-iteration run."""
    gbj, gbt = grams["lasso"]
    rj100 = fixed_runs["nesterov"][0]
    _, mid = jvmem.fista_gram_vmem(gbj, JaxConfig(max_iter=40, check_every=0),
                                   b_tile=128, interpret=True, return_state=True)
    state = convert.vmem_state_from_numpy(*(np.asarray(v) for v in mid))
    assert int(state.k) == 40 and state.X.shape == (N, B) and state.t.shape == (1, B)
    res = tvmem.fista_gram_vmem(gbt, convert.config_from_jax(
        JaxConfig(max_iter=100, check_every=0)), interpret=True, state0=state)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj100.x), rtol=2e-4, atol=2e-5)
    assert int(res.n_iters_total) == 100


def test_plans_agree_with_jax_in_the_window():
    """The burst window's plans, and past it the reference's ladder: the
    resident engine to n = 168, the Q-streaming engine beyond
    (tests/test_torch_qstream.py crosses more widths and configs)."""
    cfg, tcfg = JaxConfig(), tvmem.BatchFISTAConfig()
    for n in range(1, tvmem.MAX_N + 1):
        assert tvmem.plan_gram_solve(n, tcfg) == jvmem.plan_gram_solve(n, cfg), n
    for n_pad in range(8, 105, 8):
        assert tvmem.auto_b_tile(n_pad) == jvmem.auto_b_tile(n_pad)
    for n in (105, 168, 300):
        assert jvmem.plan_gram_solve(n, cfg)[0] != "vmem"
        assert tvmem.plan_gram_solve(n, tcfg) == jvmem.plan_gram_solve(n, cfg), n
    with pytest.raises(ValueError):
        jvmem.auto_b_tile(112)
    with pytest.raises(ValueError, match="window"):
        tvmem.auto_b_tile(112)


@pytest.mark.parametrize("n, check_every", [pytest.param(120, 0, id="120-item 7"),
                                            pytest.param(200, 10, id="200-item 9")])
def test_past_the_window_raises(n, check_every):
    """Armijo where Q must stream raises, as in the reference: past the
    resident window (n = 200), and inside it without certification (n = 120,
    check_every = 0); the router then takes the torch driver."""
    z = torch.zeros
    gb = GramBatch(Q=z((n, n, 2)), c=z((n, 2)), btb=z(2), alpha1=z(2),
                   alpha2=z(2), L=torch.ones(2))
    cfg = tvmem.BatchFISTAConfig(check_every=check_every, backtracking=True)
    with pytest.raises(NotImplementedError, match="torch driver"):
        tvmem.fista_gram_vmem(gb, cfg, interpret=True)
    with pytest.raises(NotImplementedError):
        jvmem.plan_gram_solve(n, JaxConfig(check_every=check_every, backtracking=True))


def test_cuda_wrapper_refuses_cpu_tensors(grams):
    _, gbt = grams["lasso"]
    row = torch.ones((1, B))
    with pytest.raises(ValueError, match="CUDA"):
        tvmem._launch_burst(torch.zeros(10), 0, gbt.Q, gbt.c, row, row, row, row,
                            row, gbt.c, gbt.c, row, row, None, row, n_steps=5)
    assert counters()["launches.burst"] == 0


@pytest.mark.parametrize("cfg_kw", [dict(), dict(backtracking=True), dict(check_every=0)],
                         ids=["default", "backtracking", "check_every_0"])
def test_plan_parity_across_the_ladder(cfg_kw):
    """plan_gram_solve equals the reference's on both sides of every window
    edge (104, 168, 1016), and raises the same exception where it raises."""
    for n in (1, 8, 104, 105, 112, 168, 169, 256, 1016, 1024):
        try:
            want = jvmem.plan_gram_solve(n, JaxConfig(**cfg_kw))
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)):
                tvmem.plan_gram_solve(n, tvmem.BatchFISTAConfig(**cfg_kw))
        else:
            assert tvmem.plan_gram_solve(n, tvmem.BatchFISTAConfig(**cfg_kw)) == want, n


class _CudaShaped(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's tensor does, so that
    a solve on it takes the kernel's route (:func:`make_burst`'s closure)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def launches(monkeypatch):
    """Each burst launch's ``(S, slab_ready)``, recorded by a stand-in for
    ``_launch_burst`` that runs the twin on plain tensors; the slab's size
    from 32 lanes a CTA and n² floats a lane, and the CTAs an SM holds at
    n = 20 from the C rule (two)."""
    calls = []

    def launch(*args, S=None, slab_ready=False, **kw):
        calls.append((S, slab_ready))
        plain = [a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) else a
                 for a in args]
        return tvmem._burst_reference(*plain, **kw)

    monkeypatch.setattr(tvmem, "_launch_burst", launch)
    monkeypatch.setattr(tvmem, "slab_floats", lambda n, lanes: -(-lanes // 32) * 32 * n * n)
    monkeypatch.setattr(tvmem, "ctas_per_sm", lambda n, device: 2)
    return calls


def _slab_counts():
    c = counters()
    return c["burst_slab_writes"], c["burst_slab_reads"]


def test_make_burst_on_a_cpu_tensor_is_the_twin(grams, launches):
    """A CPU tensor gets the plain twin: no launch, no slab, no count."""
    _, gbt = grams["lasso"]
    assert tvmem.make_burst(gbt.Q, 40) is tvmem._burst_reference
    before = _slab_counts()
    tvmem.fista_gram_vmem(gbt, tvmem.BatchFISTAConfig(max_iter=100, check_every=25))
    assert not launches and _slab_counts() == before


@pytest.mark.parametrize("kw", [dict(), dict(adaptive_restart=True),
                                dict(momentum="greedy"), dict(backtracking=True)],
                         ids=["nesterov", "restart", "greedy", "armijo"])
def test_first_burst_writes_the_slab_and_later_bursts_read_it(grams, launches, kw):
    """A solve of four bursts on the kernel's route: the first launch gets a
    new slab with ``slab_ready=False``, every later one the same slab with
    ``True``; the counters add up to the launches; x is the twin's."""
    _, gbt = grams["decisive" if kw.get("backtracking") else "lasso"]
    cfg = tvmem.BatchFISTAConfig(max_iter=100, check_every=25, rel_gap_tol=0.0, **kw)
    want = tvmem.fista_gram_vmem(gbt, cfg)
    before = _slab_counts()
    got = tvmem.fista_gram_vmem(dataclasses.replace(gbt, Q=gbt.Q.as_subclass(_CudaShaped)),
                                cfg)
    S = launches[0][0]
    assert S is not None and S.numel() == 32 * N * N * -(-B // 32)
    assert launches == [(S, False), (S, True), (S, True), (S, True)]
    writes, reads = (a - b for a, b in zip(_slab_counts(), before))
    assert (writes, reads) == (1, 3) and writes + reads == len(launches)
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)


def test_one_burst_solve_stores_no_slab(grams, launches):
    """A fixed run (``check_every=0``) is one burst: it gathers and stores
    nothing, and counts neither a write nor a read."""
    _, gbt = grams["lasso"]
    before = _slab_counts()
    tvmem.fista_gram_vmem(dataclasses.replace(gbt, Q=gbt.Q.as_subclass(_CudaShaped)),
                          tvmem.BatchFISTAConfig(max_iter=100, check_every=0))
    assert launches == [(None, False)] and _slab_counts() == before


def test_resumed_solve_writes_its_own_slab(grams, launches):
    """A resume from ``state0`` is a solve of its own: its first burst writes
    a new slab, and 40 + 60 iterations equal 100 straight ones bit for bit."""
    _, gbt = grams["lasso"]
    gb = dataclasses.replace(gbt, Q=gbt.Q.as_subclass(_CudaShaped))
    cfg = lambda k: tvmem.BatchFISTAConfig(max_iter=k, check_every=20, rel_gap_tol=0.0)
    straight = tvmem.fista_gram_vmem(gbt, cfg(100))
    _, mid = tvmem.fista_gram_vmem(gb, cfg(40), return_state=True)
    resumed = tvmem.fista_gram_vmem(gb, cfg(100), state0=mid)
    S1, S2 = launches[0][0], launches[2][0]
    assert launches == [(S1, False), (S1, True), (S2, False), (S2, True), (S2, True)]
    assert S2 is not S1
    assert torch.equal(resumed.x, straight.x)


@pytest.mark.parametrize("ctas", [2, 1], ids=["paired", "alone"])
def test_paired_launches_count_on_the_kernel_route(grams, launches, monkeypatch, ctas):
    """``burst_paired_launches`` counts every launch of a solve on the
    kernel's route (four bursts, then a one-burst fixed run) where an SM
    holds two of the kernel's CTAs at Q's width, and none where it holds
    one; the card is asked once a solve, at n = 20; the twin's route counts
    nothing."""
    _, gbt = grams["lasso"]
    asked = []
    monkeypatch.setattr(tvmem, "ctas_per_sm",
                        lambda n, device: asked.append(n) or ctas)
    gb = dataclasses.replace(gbt, Q=gbt.Q.as_subclass(_CudaShaped))
    before = counters()["burst_paired_launches"]
    tvmem.fista_gram_vmem(gb, tvmem.BatchFISTAConfig(max_iter=100, check_every=25,
                                                     rel_gap_tol=0.0))
    tvmem.fista_gram_vmem(gb, tvmem.BatchFISTAConfig(max_iter=100, check_every=0))
    assert len(launches) == 5 and asked == [N, N]
    paired = counters()["burst_paired_launches"] - before
    assert paired == (len(launches) if ctas >= 2 else 0)
    tvmem.fista_gram_vmem(gbt, tvmem.BatchFISTAConfig(max_iter=100, check_every=25))
    assert counters()["burst_paired_launches"] - before == paired and len(asked) == 2


def test_burst_grouping_table_follows_its_rule():
    """The table of widths in ``csrc/fista_burst.cu``'s note covers n =
    1..104 and gives at each n the block's lanes, the group and the CTAs an
    SM that the note's rule gives; the SM never holds fewer lanes than one
    CTA of the block's lanes, and two CTAs exactly where the group is half
    of them."""
    table = burst_grouping.table()
    assert sorted(table) == list(range(1, tvmem.MAX_N + 1))
    for n, (G0, G, ctas) in table.items():
        assert G0 == burst_grouping.block_group(n), n
        assert G == burst_grouping.group(n), n
        assert ctas == burst_grouping.sm_ctas(n, G), n
        assert G * ctas >= G0 * burst_grouping.sm_ctas(n, G0), n
        assert (ctas == 2) == (2 * G == G0), n


@pytest.mark.parametrize("engine", ["per_lane", "burst_resumed", "unchecked"])
@pytest.mark.parametrize("name", list(FIXED))
def test_solve_plan_is_the_engines_old_rule(engine, name):
    """_solve_plan gives each engine what its plan derived inline: the
    per-lane-k engines' chunk and k_end (max_iter rounded up to a burst),
    the burst engines' schedule from a resumed k, the sharded schedule at
    check_every 0 (one burst of max_iter), the mode and the start step
    (greedy_xi under greedy), and a β table one chunk past k_end whose
    entries are momentum_betas'."""
    kw = FIXED[name][0]
    check_every = 0 if engine == "unchecked" else 25
    cfg = tvmem.BatchFISTAConfig(max_iter=110, check_every=check_every, **kw)
    state0 = None
    if engine == "burst_resumed":
        state0 = tvmem.VmemSolveState(*([torch.zeros(1)] * 5), torch.tensor(40, dtype=torch.int32),
                                      *([torch.zeros(1)] * 3))
    p = tvmem._solve_plan(cfg, torch.device("cpu"), state0)
    if engine == "per_lane":
        want = (0, 25, 5, -(-110 // 25) * 25)  # fused_solve._plan, resident._solve
    elif engine == "burst_resumed":
        want = (40, 25, 3, 40 + 3 * 25)  # _schedule: ceil(70 / 25) bursts from k = 40
    else:
        # a fixed run, and the sharded entry's old chunk = max_iter: one burst
        want = (0, 110, 1, 110)
    assert (p.k0, p.chunk, p.n_bursts, p.k_end) == want
    assert (p.k0, p.chunk, p.n_bursts) == tvmem._schedule(cfg, state0)
    greedy = cfg.momentum == "greedy"
    assert p.t_init == (cfg.greedy_xi if greedy else cfg.t_init_factor)
    assert p.greedy == ((cfg.greedy_S, cfg.greedy_shrink) if greedy else None)
    assert p.restart_threshold == (cfg.restart_threshold if cfg.adaptive_restart else None)
    assert p.armijo == tvmem._armijo_static(cfg) and p.tol == cfg.rel_gap_tol
    assert p.betas.numel() == p.k_end + p.chunk
    assert torch.equal(p.betas, tvmem.momentum_betas(0, p.k_end + p.chunk, 1.0, cfg)[0])
    assert p.static() == dict(chunk=p.chunk, k_end=p.k_end, tol=p.tol, t_init=p.t_init,
                              restart_threshold=p.restart_threshold, greedy=p.greedy,
                              armijo=p.armijo)
