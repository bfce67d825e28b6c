"""The port's out-of-memory Gram path (``problems/streaming.py``,
``solvers/gram_dense.py``, ``bench/streaming_lasso.py``) held against the
JAX package's and a NumPy float64 oracle, on the CPU.

Tolerances: the streamed Gram against NumPy float64 as the reference's own
tests (rtol 2e-4/atol 1e-4), against JAX's stream to rtol 1e-5/atol 1e-5 of
the entries (both reduce in f32, in other summation orders); the 118-chunk
Kahan case within the reference's limits (bᵀb to 4e-7 relative, Q to rtol
1e-5/atol 1e-3) and within Kahan's bound of the exact sum of the chunks'
products, which plain f32 accumulation misses. ``fista_gram_dense``
starts from JAX's v0 on JAX's own Gram: x to 1e-6 (f32) or 1e-9 (f64),
iterations and ``converged`` equal. The float64 gap against the float64
oracle of ``tests/test_df32.py`` to 1e-7 + 1% of it, and against JAX's df32
value to 1e-7 + 5%.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.problems import streaming as JS
from fastoptsolver_tpu.solvers import gram_dense as JG
from fastoptsolver_tpu_torch.bench import streaming_lasso
from fastoptsolver_tpu_torch.problems import streaming as TS
from fastoptsolver_tpu_torch.solvers import gram_dense as TG
from test_df32 import _gap_f64, _large_m_problem

torch.set_num_threads(1)


def _data(m=3000, n=24, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n)
    x_true = np.zeros(n, np.float32)
    x_true[: n // 4] = rng.normal(size=n // 4) * 3.0
    b = (A @ x_true + noise * rng.normal(size=m)).astype(np.float32)
    return A, b


def _make(n=12, rows=256):
    def make(i):
        rng = np.random.default_rng(100 + i)
        return (rng.normal(size=(rows, n)).astype(np.float32),
                rng.normal(size=rows).astype(np.float32))
    return make


def _sources(kind, tmp_path):
    """(chunks for the port, chunks for JAX, A, b, n) of one chunk source:
    row chunks with a ragged tail, a read-only memmap, or a generator."""
    if kind == "generator":
        make = _make()
        blocks = [make(i) for i in range(5)]
        A = np.concatenate([x[0] for x in blocks])
        b = np.concatenate([x[1] for x in blocks])
        return (TS.generator_chunks(make, 5), JS.generator_chunks(make, 5), A, b, 12)
    A, b = _data(m=2048, n=16) if kind == "memmap" else _data()
    if kind == "memmap":
        path = tmp_path / "A.dat"
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=A.shape)
        mm[:] = A
        mm.flush()
        ro = np.memmap(path, dtype=np.float32, mode="r", shape=A.shape)
        return (TS.chunk_rows(ro, b, 512), JS.chunk_rows(A, b, 512), A, b, 16)
    return (TS.chunk_rows(A, b, 700), JS.chunk_rows(A, b, 700), A, b, A.shape[1])


@pytest.mark.parametrize("kind", ["ragged", "memmap", "generator"])
def test_stream_gram_matches_jax_and_float64(kind, tmp_path):
    port_chunks, jax_chunks, A, b, n = _sources(kind, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a read-only memmap casts with no warning
        g = TS.stream_gram(port_chunks, n=n, device="cpu")
    gj = JS.stream_gram(jax_chunks, n=n)
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    np.testing.assert_allclose(g.Q.numpy(), A64.T @ A64, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(g.c.numpy(), A64.T @ b64, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(float(g.btb), float(b64 @ b64), rtol=1e-5)
    scale = np.abs(A64.T @ A64).max()
    np.testing.assert_allclose(g.Q.numpy(), np.asarray(gj.Q), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(g.c.numpy(), np.asarray(gj.c), rtol=1e-5,
                               atol=1e-5 * np.abs(A64.T @ b64).max())
    np.testing.assert_allclose(float(g.btb), float(gj.btb), rtol=1e-6)
    assert g.m.dtype == torch.int64 and g.m.dim() == 0
    assert int(g.m) == int(gj.m) == A.shape[0] and g.dim == n


def test_prefetch_depth_gives_the_same_bits():
    """prefetch 1, 2, 3 reduce the same chunks to the same bits, float64
    chunks cast in the copy and chunks of growing sizes included (a ragged
    chunk larger than its ring slot grows the slot)."""
    rng = np.random.default_rng(4)
    sizes = (100, 300, 50, 700, 7, 650)
    chunks = [(rng.normal(size=(r, 9)), rng.normal(size=r)) for r in sizes]
    grams = [TS.stream_gram(iter(chunks), n=9, prefetch=p, device="cpu") for p in (1, 2, 3)]
    for g in grams[1:]:
        for f in ("Q", "c", "btb", "m"):
            assert torch.equal(getattr(g, f), getattr(grams[0], f)), f
    A = np.concatenate([a for a, _ in chunks]).astype(np.float32).astype(np.float64)
    b = np.concatenate([v for _, v in chunks]).astype(np.float32).astype(np.float64)
    assert grams[0].Q.dtype == torch.float32 and int(grams[0].m) == sum(sizes)
    np.testing.assert_allclose(grams[0].Q.numpy(), A.T @ A, rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(float(grams[0].btb), float(b @ b), rtol=1e-6)


def _accumulation_error(chunks, Q, c, btb, plain: bool = False):
    """Largest |stored − exact sum of the chunks' f32 products|, in units of
    2⁻²⁴·Σ|products| (entrywise over Q, c and bᵀb): a compensated sum is
    within Kahan's bound of 2 there, a plain one of N chunks within N − 1.
    With ``plain`` the products are summed in f32 with ``+=`` instead, and
    that sum is read."""
    parts = [[], [], []]
    for A_i, b_i in chunks:
        t, tb = torch.from_numpy(np.array(A_i)), torch.from_numpy(np.array(b_i))
        for k, p in enumerate((t.T @ t, t.T @ tb, torch.dot(tb, tb))):
            parts[k].append(p)
    worst = 0.0
    for stored, ps in zip((Q, c, btb), parts):
        exact = sum(p.double() for p in ps)
        scale = sum(p.double().abs() for p in ps) * 2.0 ** -24
        if plain:
            stored = torch.zeros_like(ps[0])
            for p in ps:
                stored += p
        worst = max(worst, float(((stored.double() - exact).abs() / scale).max()))
    return worst


def test_kahan_accumulation_within_the_reference_limits():
    """tests/test_df32.py's 118-chunk case: the compensated accumulation
    stays within the reference's limits, and within Kahan's bound (2 units
    of 2⁻²⁴·Σ|products|) of the exact sum of the chunks' products, which a
    plain f32 accumulation of the same products misses."""
    rng = np.random.default_rng(3)
    m, n = 60_000, 8
    A = rng.normal(size=(m, n)).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32) * 1.1  # non-dyadic values
    gram = TS.stream_gram(TS.chunk_rows(A, b, 512), n=n, device="cpu")
    btb64 = float(b.astype(np.float64) @ b.astype(np.float64))
    Q64 = A.astype(np.float64).T @ A.astype(np.float64)
    assert abs(float(gram.btb) - btb64) <= 4e-7 * btb64
    np.testing.assert_allclose(gram.Q.numpy().astype(np.float64), Q64, rtol=1e-5, atol=1e-3)
    assert int(gram.m) == m
    chunks = list(TS.chunk_rows(A, b, 512))
    assert _accumulation_error(chunks, gram.Q, gram.c, gram.btb) <= 2.0
    assert _accumulation_error(chunks, gram.Q, gram.c, gram.btb, plain=True) > 2.0


def test_stream_gram_rejects_feature_mismatch():
    A, b = _data(m=64, n=8)
    with pytest.raises(ValueError):
        TS.stream_gram(TS.chunk_rows(A, b, rows=32), n=9, device="cpu")


def _jax_v0(n, dtype):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), dtype))


def _both(gj, a1, a2, cfg_kw, dtype=jnp.float32):
    """JAX's fista_gram_dense on its own Gram, and the port's on the same
    Gram from JAX's start vector."""
    rj = JG.fista_gram_dense(gj, a1, a2, JG.DenseGramConfig(**cfg_kw))
    g = TS.DenseGram(Q=torch.from_numpy(np.array(gj.Q)), c=torch.from_numpy(np.array(gj.c)),
                     btb=torch.from_numpy(np.array(gj.btb)), m=torch.tensor(int(gj.m)))
    v0 = torch.from_numpy(np.array(_jax_v0(g.dim, dtype)))
    rt = TG._solve(g, a1, a2, v0, TG.DenseGramConfig(**cfg_kw))
    return rj, rt


@pytest.mark.parametrize("case", ["lasso", "elastic_net_restart", "float64_deep",
                                  "large_m"])
def test_fista_gram_dense_matches_jax(case):
    if case == "lasso":
        A, b = _data()
        a1, a2, rows = 0.1 * float(np.max(np.abs(A.T @ b))), 0.0, 512
        kw = dict(max_iter=3000, check_every=50, rel_gap_tol=1e-6)
    elif case == "elastic_net_restart":
        A, b = _data(m=2000, n=16, seed=3)
        a1, a2, rows = 0.05 * float(np.max(np.abs(A.T @ b))), 0.3, 512
        kw = dict(max_iter=3000, check_every=50, rel_gap_tol=1e-6, adaptive_restart=True)
    elif case == "float64_deep":
        A, b = _data(m=4000, n=16, seed=5)
        A, b = A.astype(np.float64), b.astype(np.float64)
        a1, a2, rows = 0.05 * float(np.max(np.abs(A.T @ b))), 0.0, 1024
        kw = dict(max_iter=20000, check_every=100, rel_gap_tol=1e-10)
    else:
        A, b = _data(m=60000, n=16, seed=7, noise=0.01)
        a1, a2, rows = 0.01 * float(np.max(np.abs(A.T @ b))), 0.0, 8192
        kw = dict(max_iter=5000, check_every=100, rel_gap_tol=2e-6)
    dtype = jnp.float64 if A.dtype == np.float64 else jnp.float32
    gj = JS.stream_gram(JS.chunk_rows(A, b, rows), n=A.shape[1], dtype=dtype)
    rj, rt = _both(gj, a1, a2, kw, dtype)
    tol = 1e-9 if dtype == jnp.float64 else 1e-6
    assert bool(rt.converged) and bool(rj.converged), (float(rt.rel_gap), float(rj.rel_gap))
    assert int(rt.iters) == int(rj.iters)
    assert rt.x.dtype == (torch.float64 if dtype == jnp.float64 else torch.float32)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(rt.L), float(rj.L), rtol=1e-6)
    assert float(rt.rel_gap) <= kw["rel_gap_tol"]


@pytest.mark.parametrize("branch", ["general", "saturated"])
def test_float64_gap_matches_the_oracle_and_df32(branch):
    """tests/test_df32.py:110's cancellation case (x near the optimum of
    the stored f32 triple): the port's float64 gap agrees with the float64
    oracle and with JAX's df32 value, and is returned as float32. At the
    f32 x, u_inf sits just above α₁ (the general branch, s < 1); with α₁
    set 1% above u_inf the saturated branch (s = 1) is the one taken."""
    Q, c, btb = _large_m_problem()
    n = Q.shape[0]
    a1 = 0.001 * float(np.abs(c).max())
    Q64, c64 = Q.astype(np.float64), c.astype(np.float64)
    x, y, t = np.zeros(n), np.zeros(n), 1.0
    L = float(np.linalg.eigvalsh(Q64).max())
    for _ in range(30000):
        v = y - (Q64 @ y - c64) / L
        xn = np.sign(v) * np.maximum(np.abs(v) - a1 / L, 0.0)
        tn = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        y = xn + ((t - 1) / tn) * (xn - x)
        x, t = xn, tn
    x32 = x.astype(np.float32)
    u_inf = np.abs(Q64 @ x32.astype(np.float64) - c64).max()
    if branch == "saturated":
        a1 = 1.01 * u_inf
    assert (u_inf > a1) == (branch == "general")
    oracle = _gap_f64(Q, c, btb, a1, 0.0, x32)
    got = TG._rel_gap_dense(torch.from_numpy(Q), torch.from_numpy(c),
                            torch.tensor(btb), a1, 0.0, torch.from_numpy(x32))
    assert got.dtype == torch.float32
    assert abs(float(got) - oracle) <= 1e-7 + 0.01 * oracle, (float(got), oracle)
    df32 = float(JG._rel_gap_dense(jnp.asarray(Q), jnp.asarray(c),
                                   jnp.asarray(btb, jnp.float32), a1, 0.0, jnp.asarray(x32)))
    assert abs(float(got) - df32) <= 1e-7 + 0.05 * oracle, (float(got), df32)


def test_streaming_lasso_run_on_the_cpu():
    """The bench at a tiny shape on the CPU: the reference's record keys,
    the same chunks as the reference's recipe, a certified solve, and no
    device numbers."""
    rec = streaming_lasso.run(20000, 48, 3000, 1e-6, device="cpu")
    keys = {"m", "n", "a_gb", "exceeds_hbm", "chunks", "stream_s", "stream_gbps",
            "solve_s", "solve_iters", "iters_per_s", "rel_gap", "converged",
            "nnz_frac", "device"}
    assert keys <= set(rec)
    assert rec["chunks"] == 7 and rec["converged"] and rec["rel_gap"] <= 1e-6
    assert rec["exceeds_hbm"] is None and rec["device"] == "cpu"
    assert rec["link_ceiling_gbps"] is None and rec["solve_bound_us_per_iter"] is None
    make, n_chunks = streaming_lasso.make_chunks(20000, 48, 3000)
    A_i, b_i = make(6)
    rng = np.random.Generator(np.random.SFC64(6))
    A_ref = rng.standard_normal((2000, 48), dtype=np.float32) * np.float32(1 / np.sqrt(48))
    assert n_chunks == 7 and np.array_equal(A_i, A_ref) and b_i.shape == (2000,)
