"""The CUDA kernels of ``fastoptsolver_tpu_torch`` against their plain
PyTorch twins, on the card (``chip_smoke.py`` phase 3 for pytest users):
the fused solve, the stream pass, the Gram build, the burst engine (its
slab route bit for bit against its gather route), the
resident engine (and the adaptive entry onto it), the Q-streaming engine
(its cluster kernel also bit for bit against its streaming kernel) and the
torch precompute's power kernel against its eager loop; and
``bench.verify_tpu``, each kernel against the torch driver (phase 16).

Every test takes the ``cuda`` fixture, which skips when torch sees no CUDA
device: run them on a GPU machine with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Tolerances: x to rtol 1e-5/atol 1e-6,
``converged`` identical, ``iters`` within one ``check_every`` burst (the JAX
package's cross-engine ones); the stream sums to 1e-5 of each lane's
absolute sum.
"""
import dataclasses

import numpy as np
import pytest
import torch

import burst_grouping
from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
from fastoptsolver_tpu_torch.bench import stream
from fastoptsolver_tpu_torch.batch import fista_gram
from fastoptsolver_tpu_torch.batch.fista_gram import make_gram_batch
from fastoptsolver_tpu_torch.kernels import (_build, fista_vmem, fused_solve, gram_build,
                                             lipschitz, qstream, resident)
from fastoptsolver_tpu_torch.kernels._common import make_matvec, power_lambda_max
from fastoptsolver_tpu_torch.utils import profiling
from fastoptsolver_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda


def launches(kernel: str) -> int:
    """Launches of ``kernel`` so far; ``gram`` is the build's two kernels."""
    c = counters()
    if kernel == "gram":
        return c["launches.gram_pairs"] + c["launches.gram_power"]
    return c[f"launches.{kernel}"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _problem(n, m, B, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):  # AR(1) features, ρ = 0.2
        A[k] = 0.2 * A[k - 1] + np.sqrt(1 - 0.04) * A[k]
    xt = np.zeros((n, B))
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = np.einsum("nmb,nb->mb", A, xt) + 2.0 * rng.normal(size=(m, B))
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return t(A), t(b), t(a1)


SHAPES = [(5, 250, 390), (1, 64, 128), (8, 333, 300)]


@pytest.mark.parametrize("mode, a2", [("nesterov", 0.0), ("delta", 0.3)])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_kernel_matches_twin(cuda, shape, mode, a2):
    A, b, a1 = _problem(*shape, seed=SHAPES.index(shape), device=cuda)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6,
                           momentum=mode)
    before = launches("fused")
    got = fused_solve.solve_lasso_fused(A, b, a1, a2, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("fused") == before + 1
    want = fused_solve.fused_solve_reference(A, b, a1, a2, cfg=cfg)
    torch.testing.assert_close(got.x, want.x, rtol=1e-5, atol=1e-6)
    assert torch.equal(got.converged, want.converged)
    assert int((got.iters - want.iters).abs().max()) <= cfg.check_every
    assert got.converged.all()


FUSED_MODES = {"restart": dict(adaptive_restart=True), "greedy": dict(momentum="greedy")}


@pytest.mark.parametrize("mode", list(FUSED_MODES))
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_kernel_matches_twin_in_every_mode(cuda, shape, mode):
    """Restart and greedy, certified at rel_gap_tol 1e-5: converged
    identical, iters within a burst, x to rtol 2e-4/atol 2e-5."""
    A, b, a1 = _problem(*shape, seed=SHAPES.index(shape), device=cuda)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **FUSED_MODES[mode])
    before = launches("fused")
    got = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("fused") == before + 1
    want = fused_solve.fused_solve_reference(A, b, a1, 0.0, cfg=cfg)
    assert torch.equal(got.converged, want.converged) and got.converged.all()
    assert int((got.iters - want.iters).abs().max()) <= cfg.check_every
    torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)


def _noise_free(n, m, B, seed, device, alpha1=None):
    """The reference's resume recipe (tests/test_fused_resume.py): i.i.d.
    features, a 2-sparse x_true, b without noise, α₁ = 0.1·‖Aᵀb‖∞ or the
    given constant."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B)).astype(np.float32)
    xt = np.zeros((n, B), np.float32)
    xt[:2] = rng.normal(size=(2, B))
    b = np.einsum("nmb,nb->mb", A, xt).astype(np.float32)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    if alpha1 is not None:
        a1 = np.full(B, alpha1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return t(A), t(b), t(a1)


@pytest.mark.parametrize("restart", [False, True])
def test_fused_kernel_armijo_decisive(cuda, restart):
    """Armijo with table-β and with restart momentum in the decisive regime
    (α₁ = 0.5, L understated 4×, 6 iterations): x to rtol 1e-4/atol 1e-5."""
    A, b, a1 = _noise_free(5, 96, 300, seed=1, device=cuda, alpha1=0.5)
    cfg = BatchFISTAConfig(max_iter=6, check_every=6, backtracking=True, t_init_factor=4.0,
                           adaptive_restart=restart)
    got = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg)
    want = fused_solve.fused_solve_reference(A, b, a1, 0.0, cfg=cfg)
    torch.testing.assert_close(got.x, want.x, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.iters, want.iters)


RESUME_MODES = {
    "nesterov": {}, "restart": dict(adaptive_restart=True), "greedy": dict(momentum="greedy"),
    "armijo": dict(backtracking=True), "armijo_restart": dict(backtracking=True,
                                                              adaptive_restart=True),
}


@pytest.mark.parametrize("mode", list(RESUME_MODES))
def test_fused_kernel_resume_is_bit_exact(cuda, mode):
    """75 iterations, the state, then 125 more equal 200 straight ones bit
    for bit on the kernel, its final state included."""
    A, b, a1 = _noise_free(5, 96, 300, seed=1, device=cuda)
    full = BatchFISTAConfig(max_iter=200, check_every=25, **RESUME_MODES[mode])
    half = dataclasses.replace(full, max_iter=75)
    straight, end = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=full, return_state=True)
    _, mid = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=half, return_state=True)
    resumed, end2 = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=full, state0=mid,
                                                  return_state=True)
    for field in ("x", "iters", "rel_gap", "converged"):
        assert torch.equal(getattr(resumed, field), getattr(straight, field)), field
    for name, u, v in zip(end._fields, end, end2):
        assert torch.equal(u, v), name


def test_fused_kernel_resume_with_tiles_at_different_k(cuda):
    """The first tile trivially easy, so the checkpoint holds two k: each
    CTA resumes from its own (tests/test_fused_resume.py:70-102)."""
    A, b, a1 = _noise_free(5, 96, 300, seed=4, device=cuda)
    a1 = torch.where(torch.arange(300, device=cuda) < 128,
                     10.0 * torch.einsum("nmb,mb->nb", A, b).abs().amax(0), a1)
    cfg = lambda it: BatchFISTAConfig(max_iter=it, check_every=25)
    straight = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(400))
    _, mid = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(150), return_state=True)
    assert len(set(mid.k.tolist())) > 1
    resumed = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(400), state0=mid)
    assert torch.equal(resumed.x, straight.x) and torch.equal(resumed.iters, straight.iters)


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_kernel_matches_twin(cuda, shape):
    A, b, _ = _problem(*shape, seed=0, device=cuda)
    before = launches("stream")
    got = stream.stream_pass(A, b)
    assert launches("stream") == before + 1
    want = stream.stream_pass_reference(A, b)
    scale = A.abs().sum(dim=(0, 1)) + b.abs().sum(dim=0)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_stream_copy_widths_agree(cuda):
    """Each lane's sum does not depend on the load width: a B=301 pass
    (4-byte loads) equals, on its first 300 lanes, a B=300 pass of the same
    data (16-byte loads), bit for bit, and both hold against the twin."""
    A, b, _ = _problem(5, 70, 301, seed=8, device=cuda)
    A3, b3 = A[:, :, :300].contiguous(), b[:, :300].contiguous()
    width = _build.library().stream_copy_bytes
    assert width(301, A.data_ptr(), b.data_ptr()) == 4
    assert width(300, A3.data_ptr(), b3.data_ptr()) == 16
    narrow, wide = stream.stream_pass(A, b), stream.stream_pass(A3, b3)
    torch.cuda.synchronize()
    assert torch.equal(narrow[:300], wide)
    scale = A.abs().sum(dim=(0, 1)) + b.abs().sum(dim=0)
    assert bool(((narrow - stream.stream_pass_reference(A, b)).abs() <= 1e-5 * scale).all())


def test_router_takes_the_kernel_on_cuda(cuda):
    A, b, a1 = _problem(5, 100, 256, seed=4, device=cuda)
    before = launches("fused")
    builds, bursts = launches("gram"), launches("burst")
    res = solve_lasso_batch(A, b, a1, feature_major=True)
    assert launches("fused") == before + 1 and res.converged.all()
    assert launches("gram") == builds and launches("burst") == bursts
    # every mode at n <= 8 runs on the fused kernel, with the state
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, adaptive_restart=True)
    res, st = solve_lasso_batch(A, b, a1, cfg=cfg, feature_major=True, return_state=True)
    assert launches("fused") == before + 2 and isinstance(st, fused_solve.FusedSolveState)
    assert launches("gram") == builds and launches("burst") == bursts
    assert res.converged.all() and st.X.is_cuda
    # what the fused kernel refuses (n = 9) goes to the two-kernel path: two
    # build launches and one burst launch per check_every iterations
    A9, b9, a19 = _problem(9, 100, 256, seed=4, device=cuda)
    res = solve_lasso_batch(A9, b9, a19, cfg=cfg, feature_major=True)
    assert launches("fused") == before + 2 and res.x.is_cuda
    assert launches("gram") == builds + 2
    assert launches("burst") == bursts + int(res.n_iters_total) // 25
    assert res.converged.all()
    # and past the burst window: n = 110 to one resident launch (the build
    # kernels take n <= 118; L is estimated in-kernel, so gram_power does not
    # launch), Armijo at n = 200 to the torch driver
    A, b, a1 = _problem(110, 220, 64, seed=5, device=cuda)
    residents, bursts = launches("resident"), launches("burst")
    res = solve_lasso_batch(A, b, a1, feature_major=True)
    assert launches("resident") == residents + 1 and res.x.is_cuda
    assert launches("gram") == builds + 3 and launches("burst") == bursts
    A, b, a1 = _problem(200, 400, 64, seed=5, device=cuda)
    res = solve_lasso_batch(A, b, a1, cfg=BatchFISTAConfig(max_iter=50, check_every=25,
                                                           backtracking=True),
                            feature_major=True)
    assert isinstance(res.n_iters_total, int) and res.x.is_cuda


# B % 4 != 0 (4-byte copies) and m not a multiple of the 8-row stage or the
# 32-row block beside the 16-byte shapes
@pytest.mark.parametrize("shape", [(9, 33, 300), (20, 70, 200), (64, 128, 256),
                                   (9, 33, 301), (20, 7, 203)])
def test_build_kernels_match_twin(cuda, shape):
    A, b, _ = _problem(*shape, seed=6, device=cuda)
    before = launches("gram")
    got = gram_build._launch(A, b, 96)
    torch.cuda.synchronize()
    assert launches("gram") == before + 2
    want = gram_build.gram_build_reference(A, b, 96)
    scale = torch.maximum(want[0].abs().amax(dim=(0, 1)), want[2])
    for g, w in zip(got[:3], want[:3]):
        assert bool(((g - w).abs() <= 1e-5 * scale).all())
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    assert torch.equal(got[0], got[0].transpose(0, 1))


def test_build_without_power_steps_launches_once(cuda):
    """pl_iters=0 (the resident route's build) skips gram_power: λ = 0, as
    the twin's, and the Gram as with the power steps."""
    A, b, _ = _problem(20, 70, 200, seed=6, device=cuda)
    before = launches("gram")
    got = gram_build._launch(A, b, 0)
    torch.cuda.synchronize()
    assert launches("gram") == before + 1
    assert not bool(got[3].any())
    assert torch.equal(got[0], gram_build._launch(A, b, 96)[0])


def test_power_exports(cuda):
    """gram_power's lanes a CTA and shared bytes from the card equal their
    Python mirrors for n = 1..128 (the resident rule on gram_power's bytes:
    10 lanes at n = 96); outside 1..128 the group is 0 and a launch is
    refused."""
    lib = _build.library()
    for n in range(1, gram_build.POWER_MAX_N + 1):
        assert lib.gram_power_group(n) == gram_build.power_group_lanes(n)
        assert lib.gram_power_smem_bytes(n) == gram_build._power_smem_bytes(n)
    assert lib.gram_power_group(96) == 10
    assert lib.gram_power_group(0) == lib.gram_power_group(gram_build.POWER_MAX_N + 1) == 0
    assert lib.gram_power_smem_bytes(gram_build.POWER_MAX_N + 1) == 0
    lam = torch.empty(8, device=cuda)
    err = lib.gram_power(lam.data_ptr(), lam.data_ptr(), lam.data_ptr(),
                         gram_build.POWER_MAX_N + 1, 8, 96,
                         torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


# one warp a lane and its edges, the wide-n path's 96, the window's top
POWER_WIDTHS = [1, 5, 31, 32, 33, 96, 113, 118]


@pytest.mark.parametrize("n", POWER_WIDTHS)
def test_power_kernel_matches_twin(cuda, n):
    """gram_power alone against the twin's power iteration on the same Gram
    and c (gram_pairs' own output), B = 301 so the last CTA is ragged: the
    matvecs round alike and only the norm's order differs, so λ to 1e-5
    relative, as the build's check holds it."""
    A, b, _ = _problem(n, max(2 * n, 16), 301, seed=14, device=cuda)
    Q, c, _, _ = gram_build._launch(A, b, 0)
    pl_iters = 32 if n <= 7 else 96
    before = launches("gram")
    lam = gram_build._launch_power(Q, c, pl_iters)
    torch.cuda.synchronize()
    assert launches("gram") == before + 1
    want = power_lambda_max(make_matvec(Q, n), c, pl_iters)[0]
    assert bool(torch.isfinite(lam).all())
    torch.testing.assert_close(lam, want, rtol=1e-5, atol=0)


def test_pairs_copy_widths_agree(cuda):
    """The pair sums do not depend on the copy width: a B=301 build (4-byte
    copies) equals, on its first 300 lanes, a B=300 build of the same data
    (16-byte copies), bit for bit."""
    A, b, _ = _problem(20, 70, 301, seed=7, device=cuda)
    A3, b3 = A[:, :, :300].contiguous(), b[:, :300].contiguous()
    width = _build.library().gram_pairs_copy_bytes
    assert width(301, A.data_ptr(), b.data_ptr()) == 4
    assert width(300, A3.data_ptr(), b3.data_ptr()) == 16
    narrow = gram_build._launch(A, b, 0)
    wide = gram_build._launch(A3, b3, 0)
    torch.cuda.synchronize()
    for g, w in zip(narrow[:3], wide[:3]):
        assert torch.equal(g[..., :300], w)


BURST_MODES = {
    "nesterov": (dict(), 0.0), "delta_ridge": (dict(momentum="delta"), 0.3),
    "restart": (dict(adaptive_restart=True), 0.0), "greedy": (dict(momentum="greedy"), 0.0),
}


# every mode at n = 20, fixed Nesterov and restart at a width of each other
# lanes-a-CTA count of the window (32 lanes at n <= 32, then 16, 13, 6, 5)
BURST_CASES = [(20, mode) for mode in BURST_MODES] + [
    (n, mode) for n in (5, 9, 33, 64, 96, 104) for mode in ("nesterov", "restart")]


@pytest.mark.parametrize("n, mode", BURST_CASES)
def test_burst_kernel_matches_twin(cuda, n, mode):
    """Fixed runs (check_every=0) to rtol 2e-4/atol 2e-5, certified runs
    (rel_gap_tol 1e-5) with converged identical and iters within a burst,
    at B = 300 (a ragged last CTA at 32, 16 and 13 lanes a CTA)."""
    kw, a2 = BURST_MODES[mode]
    A, b, a1 = _problem(n, max(150, 2 * n), 300, seed=7, device=cuda)
    gb = gram_build.make_gram_batch_fused(A, b, a1, a2)
    fixed = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
    before = launches("burst")
    got = fista_vmem.fista_gram_vmem(gb, fixed)
    torch.cuda.synchronize()
    assert launches("burst") == before + 1
    want = fista_vmem.fista_gram_vmem_reference(gb, fixed)
    torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)
    cert = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw)
    got = fista_vmem.fista_gram_vmem(gb, cert)
    want = fista_vmem.fista_gram_vmem_reference(gb, cert)
    assert torch.equal(got.converged, want.converged) and got.converged.all()
    assert int((got.iters - want.iters).abs().max()) <= 25


def test_burst_group_fits_a_block(cuda):
    """The C exports size a CTA that a Hopper block takes at every n of the
    window: at most 232,448 bytes of shared memory and 1024 threads."""
    lib = _build.library()
    for n in range(1, fista_vmem.MAX_N + 1):
        G, smem = lib.fista_burst_group(n), lib.fista_burst_smem_bytes(n)
        assert 1 <= G <= 32 and G * (-(-n // 32) * 32) <= 1024, n
        assert 0 < smem <= 232448 and smem % G == 0, n
    assert [lib.fista_burst_group(n) for n in (5, 20, 33, 64, 96, 104)] == [16, 16, 8, 13, 3, 5]
    assert lib.fista_burst_group(0) == lib.fista_burst_group(fista_vmem.MAX_N + 1) == 0


def test_burst_ctas_per_sm_follows_the_rule(cuda):
    """At every n of the window the library's group and its shared bytes are
    the note's rule and table (``tests/burst_grouping.py``), the card holds
    as many CTAs of that group an SM as the table says
    (``fista_burst_ctas_per_sm``), the SM holds no fewer lanes than one CTA
    of a block's lanes, and a CTA's shared memory with the mbarrier fits the
    card's opt-in; 0 outside the window."""
    lib = _build.library()
    props = torch.cuda.get_device_properties(cuda)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    table = burst_grouping.table()
    for n in range(1, fista_vmem.MAX_N + 1):
        G0, G, ctas = table[n]
        assert lib.fista_burst_group(n) == G == burst_grouping.group(n), n
        assert lib.fista_burst_smem_bytes(n) == 4 * burst_grouping.lane_floats(n) * G, n
        assert lib.fista_burst_ctas_per_sm(n) == ctas, n
        assert fista_vmem.ctas_per_sm(n, cuda) == ctas, n
        assert G * ctas >= G0, n
        assert lib.fista_burst_smem_bytes(n) + 16 <= optin, n
    assert lib.fista_burst_ctas_per_sm(0) == lib.fista_burst_ctas_per_sm(105) == 0


def test_burst_kernel_armijo_decisive_and_resume(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    A = torch.randn((20, 150, 256), generator=g, device=cuda)
    xt = torch.zeros((20, 256), device=cuda)
    xt[:2] = torch.randn((2, 256), generator=g, device=cuda)
    b = torch.einsum("nmb,nb->mb", A, xt).contiguous()
    gb = gram_build.make_gram_batch_fused(A, b, 0.5, 0.0)
    gb = dataclasses.replace(gb, L=gb.L / 4.0)
    cfg = BatchFISTAConfig(max_iter=5, check_every=0, backtracking=True)
    got = fista_vmem.fista_gram_vmem(gb, cfg)
    want = fista_vmem.fista_gram_vmem_reference(gb, cfg)
    torch.testing.assert_close(got.x, want.x, rtol=1e-4, atol=1e-5)
    # resume on the Gram with its true L (at L/4 the fixed step diverges)
    gb = dataclasses.replace(gb, L=gb.L * 4.0)
    full = BatchFISTAConfig(max_iter=100, check_every=0, momentum="greedy")
    straight = fista_vmem.fista_gram_vmem(gb, full)
    _, mid = fista_vmem.fista_gram_vmem(
        gb, BatchFISTAConfig(max_iter=40, check_every=0, momentum="greedy"),
        return_state=True)
    assert torch.isfinite(straight.x).all()
    assert torch.equal(fista_vmem.fista_gram_vmem(gb, full, state0=mid).x, straight.x)


def test_wrapper_refuses_bad_inputs(cuda):
    A, b, a1 = _problem(5, 40, 128, seed=5, device=cuda)
    with pytest.raises(ValueError, match="interpret"):
        fused_solve.solve_lasso_fused(A, b, a1, interpret=True)
    with pytest.raises(ValueError, match="float32"):
        fused_solve.solve_lasso_fused(A.double(), b.double(), a1.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_solve.solve_lasso_fused(A.transpose(1, 2).contiguous().transpose(1, 2), b, a1)
    with pytest.raises(ValueError, match="b_tile"):
        fused_solve.solve_lasso_fused(A, b, a1, b_tile=100)
    with pytest.raises(ValueError, match="interpret"):
        gram_build.make_gram_batch_fused(A, b, a1, 0.0, interpret=True)
    with pytest.raises(ValueError, match="float32"):
        gram_build._launch(A.double(), b.double(), 32)
    gb = gram_build.make_gram_batch_fused(A, b, a1, 0.0)
    with pytest.raises(ValueError, match="interpret"):
        fista_vmem.fista_gram_vmem(gb, interpret=True)


def _wide_gram(n, a2, cuda, B=300, seed=8, l_div=1.0, decisive=False):
    """The torch precompute on the card (the build kernels stop at n = 118)."""
    if decisive:  # noise-free b, α₁ = 0.5, L understated
        g = torch.Generator(device=cuda).manual_seed(seed)
        A = torch.randn((n, 2 * n, B), generator=g, device=cuda)
        xt = torch.zeros((n, B), device=cuda)
        xt[:2] = torch.randn((2, B), generator=g, device=cuda)
        b = torch.einsum("nmb,nb->mb", A, xt)
        a1 = torch.full((B,), 0.5, device=cuda)
    else:
        A, b, a1 = _problem(n, 2 * n, B, seed=seed, device=cuda)
    gb = make_gram_batch(A.permute(2, 1, 0), b.T, a1, a2)
    return dataclasses.replace(gb, Q=gb.Q.contiguous(), c=gb.c.contiguous(), L=gb.L / l_div)


RESIDENT_MODES = dict(BURST_MODES, armijo=(dict(backtracking=True), 0.0))
# widths where iters are held within a burst; at the others (the narrow
# widths and the ragged last warps) a lane's gap can sit at the tolerance for
# two bursts, so the burst it certifies at moves with the gap's rounding
ITERS_HELD = (112, 128, 168)


@pytest.mark.parametrize("mode", list(RESIDENT_MODES))
@pytest.mark.parametrize("n", [5, 33, 112, 113, 128, 150, 168])
def test_resident_kernel_matches_twin(cuda, n, mode):
    """One launch, L estimated in-kernel, against the twin at the kernel's
    grouping: certified runs (rel_gap_tol 1e-5) converged identical, x to
    rtol 2e-4/atol 2e-5, iters within a burst at ``ITERS_HELD``; Armijo in
    the decisive regime (5 iterations) x to rtol 1e-4/atol 1e-5. Then
    40 + 60 resumes bit-exactly."""
    kw, a2 = RESIDENT_MODES[mode]
    armijo = mode == "armijo"
    gb = _wide_gram(n, a2, cuda, l_div=4.0 if armijo else 1.0, decisive=armijo)
    cfg = BatchFISTAConfig(**(dict(max_iter=5, check_every=5) if armijo else
                              dict(max_iter=1000, check_every=25, rel_gap_tol=1e-5)), **kw)
    est = None if armijo else 96
    before = launches("resident")
    got = resident.fista_gram_resident(gb, cfg, est_l_iters=est)
    torch.cuda.synchronize()
    assert launches("resident") == before + 1
    want = resident.fista_gram_resident_reference(gb, cfg, est_l_iters=est)
    if armijo:
        torch.testing.assert_close(got.x, want.x, rtol=1e-4, atol=1e-5)
    else:
        assert torch.equal(got.converged, want.converged) and got.converged.all()
        if n in ITERS_HELD:
            assert int((got.iters - want.iters).abs().max()) <= 25
        torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)
    full = BatchFISTAConfig(max_iter=100, check_every=20, rel_gap_tol=1e-12, **kw)
    straight = resident.fista_gram_resident(gb, full, est_l_iters=est)
    _, mid = resident.fista_gram_resident(gb, dataclasses.replace(full, max_iter=40),
                                          est_l_iters=est, return_state=True)
    assert torch.equal(resident.fista_gram_resident(gb, full, est_l_iters=est,
                                                    state0=mid).x, straight.x)


def test_resident_group_is_the_twins(cuda):
    """The library's grouping (from the card's opt-in shared memory) equals
    group_lanes, the twin's rule on the CPU, across the window."""
    got = [resident.kernel_group(n, cuda) for n in range(1, resident.MAX_N + 1)]
    assert got == [resident.group_lanes(n) for n in range(1, resident.MAX_N + 1)]


def test_resident_kernel_reads_the_upper_triangle(cuda):
    """On a Gram that is not bit-symmetric, kernel and twin read the same
    upper triangle and agree as on a symmetric one."""
    gb = _wide_gram(128, 0.0, cuda, seed=12)
    g = torch.Generator(device=cuda).manual_seed(13)
    Q = (gb.Q * (1.0 + 1e-3 * torch.rand(gb.Q.shape, generator=g, device=cuda))).contiguous()
    assert not torch.equal(Q, Q.transpose(0, 1))
    gb = dataclasses.replace(gb, Q=Q)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5)
    got = resident.fista_gram_resident(gb, cfg, est_l_iters=96)
    want = resident.fista_gram_resident_reference(gb, cfg, est_l_iters=96)
    assert torch.equal(got.converged, want.converged) and got.converged.all()
    assert int((got.iters - want.iters).abs().max()) <= 25
    torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)


def test_resident_kernel_counts_its_lane_steps(cuda, monkeypatch):
    """The lane-step counters on the kernel at n = 128 with a ragged last
    group (B = 301, 6 lanes a group): the sums of the returned k and iters,
    tallied on the card without a host sync; a resume adds only its own
    steps; and x's bits are those of the path without the tally."""
    gb = _wide_gram(128, 0.0, cuda, B=301, seed=14)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    names = ("resident_lane_steps", "resident_lane_steps_live")
    counted = lambda: tuple(counters()[k] for k in names)
    solve = lambda c=cfg, s=None: resident.fista_gram_resident(
        gb, c, est_l_iters=96, state0=s, return_state=True)
    profiling.reset_counters()
    res, st = solve()
    assert counted() == (int(st.k.long().sum()), int(st.iters.long().sum()))
    assert bool((st.iters <= st.k).all()) and counted()[1] <= counted()[0]
    profiling.reset_counters()
    _, mid = solve(dataclasses.replace(cfg, max_iter=100))
    first = counted()
    profiling.reset_counters()
    _, end = solve(s=mid)
    assert torch.equal(end.k, st.k) and torch.equal(end.iters, st.iters)
    assert tuple(a + b for a, b in zip(first, counted())) == (
        int(st.k.long().sum()), int(st.iters.long().sum()))
    out = tuple(getattr(st, f) for f in st._fields)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resident._count_lane_steps(out, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(resident, "_count_lane_steps", lambda out, rows: None)
    plain, plain_st = solve()
    assert torch.equal(res.x, plain.x)
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(plain_st, f)), f
    profiling.reset_counters()


@pytest.mark.parametrize("mode", ["restart", "greedy"])
def test_adaptive_entry_matches_twin(cuda, mode):
    kw, a2 = BURST_MODES[mode]
    A, b, a1 = _problem(96, 192, 300, seed=9, device=cuda)
    gb = gram_build.make_gram_batch_fused(A, b, a1, a2)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw)
    before = launches("resident")
    got = fista_vmem.fista_gram_vmem_adaptive(gb, cfg)
    assert launches("resident") == before + 1
    want = fista_vmem.fista_gram_vmem_adaptive(
        gram_build.GramBatch(*(v.cpu() for v in (gb.Q, gb.c, gb.btb, gb.alpha1,
                                                 gb.alpha2, gb.L))), cfg)
    assert torch.equal(got.converged.cpu(), want.converged) and got.converged.all()
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=2e-4, atol=2e-5)


def _qstream_one_burst(gb, kw, cuda):
    """One burst of 25 from a non-trivial state, with the gap: every output
    of the kernel to rtol 2e-4/atol 2e-5 of the twin's."""
    args, static = _qstream_args(gb, kw, cuda)
    before = launches("qstream")
    got = qstream._launch_qstream(*args, with_gap=True, **static)
    torch.cuda.synchronize()
    assert launches("qstream") == before + 1
    want = qstream._qstream_burst_reference(*args, with_gap=True, **static)
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mode", list(BURST_MODES))
@pytest.mark.parametrize("n", [200, 256])
def test_qstream_kernel_matches_twin(cuda, n, mode):
    """One burst (:func:`_qstream_one_burst`); a certified run (rel_gap_tol
    1e-5) converged identical and iters within a burst; 40 + 60 resumes
    bit-exactly."""
    kw, a2 = BURST_MODES[mode]
    gb = _wide_gram(n, a2, cuda)
    _qstream_one_burst(gb, kw, cuda)
    cert = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw)
    got = fista_vmem.fista_gram_vmem(gb, cert)
    want = fista_vmem.fista_gram_vmem_reference(gb, cert)
    assert torch.equal(got.converged, want.converged) and got.converged.all()
    assert int((got.iters - want.iters).abs().max()) <= 25
    full = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
    straight = fista_vmem.fista_gram_vmem(gb, full)
    _, mid = fista_vmem.fista_gram_vmem(gb, dataclasses.replace(full, max_iter=40),
                                        return_state=True)
    assert torch.equal(fista_vmem.fista_gram_vmem(gb, full, state0=mid).x, straight.x)


def _random_gram(n, a2, cuda, B=100, seed=14):
    """i.i.d. Gaussian instances (m = 2n) made on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn((B, 2 * n, n), generator=g, device=cuda)
    b = torch.randn((B, 2 * n), generator=g, device=cuda)
    a1 = 0.1 * torch.einsum("bmn,bm->bn", A, b).abs().amax(1)
    gb = make_gram_batch(A, b, a1, a2)
    return dataclasses.replace(gb, Q=gb.Q.contiguous(), c=gb.c.contiguous())


@pytest.mark.parametrize("mode", list(BURST_MODES))
@pytest.mark.parametrize("n", [120, 400, 600, 900])
def test_qstream_kernel_matches_twin_at_each_instantiation(cuda, n, mode):
    """One burst at the kernel's other instantiations the router reaches: 8,
    32 and 64 features a thread at 32 lanes a CTA, and 16 lanes a CTA past
    n = 868 (B = 100, ragged). At n = 120, check_every=0 streams Q."""
    kw, a2 = BURST_MODES[mode]
    gb = _random_gram(n, a2, cuda)
    _qstream_one_burst(gb, kw, cuda)
    if n == 120:
        fixed = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
        before = (launches("qstream"), launches("resident"))
        got = fista_vmem.fista_gram_vmem(gb, fixed)
        assert launches("qstream") > before[0] and launches("resident") == before[1]
        want = fista_vmem.fista_gram_vmem_reference(gb, fixed)
        torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)


# the window of the Q-streaming cluster kernel: 8 CTAs of 232,448 bytes hold a
# lane's Q up to n = 660 (qstream.cu:cta_floats)
CLUSTER_MAX_N = 660


def test_qstream_cluster_exports(cuda):
    """The C exports: a cluster size for every n of the window, each CTA
    inside a Hopper block's shared memory, clusters the card can hold; 0
    past it, where the streaming kernel serves."""
    lib = _build.library()
    for n in range(1, qstream.MAX_N + 1):
        C = lib.qstream_cluster_size(n)
        smem = lib.qstream_smem_bytes(n, C)
        if n <= CLUSTER_MAX_N:
            assert C in (1, 2, 4, 8) and 0 < smem <= 232448, n
            assert -(-n // C) <= 64 or C == 8, n
        else:
            assert C == 0 and smem == 0, n
    assert [lib.qstream_cluster_size(n) for n in (120, 200, 256, 400, 600, 900)] == \
        [2, 4, 4, 8, 8, 0]
    for n in (120, 200, 256, 400, 600):
        assert lib.qstream_active_clusters(n, lib.qstream_cluster_size(n)) > 0, n
    assert lib.qstream_cluster_size(0) == lib.qstream_cluster_size(qstream.MAX_N + 1) == 0
    assert lib.qstream_active_clusters(600, 1) < 0  # 1.44 MB a CTA


def _qstream_args(gb, kw, cuda):
    """One burst's arguments from a non-trivial state, and its static options."""
    cfg = BatchFISTAConfig(max_iter=100, check_every=25, **kw)
    greedy = cfg.momentum == "greedy"
    tau = ((cfg.greedy_xi if greedy else 1.0) / gb.L)[None, :].contiguous()
    g = torch.Generator(device=cuda).manual_seed(7)
    X = 0.1 * torch.randn(gb.c.shape, generator=g, device=cuda)
    Y = X + 0.01 * torch.randn(gb.c.shape, generator=g, device=cuda)
    row = lambda v: v[None, :].contiguous()
    args = (fista_vmem._beta_table(100, cfg).to(cuda), 25, gb.Q, gb.c, tau,
            (tau * row(gb.alpha1)).contiguous(), row(gb.alpha2), row(gb.alpha1),
            row(gb.btb), X, Y, tau.clone() if greedy else torch.full_like(tau, 1.7),
            torch.full_like(tau, 0.05), row(1.0 / gb.L), tau)
    static = dict(n_steps=25, greedy=(cfg.greedy_S, cfg.greedy_shrink) if greedy else None,
                  restart_threshold=cfg.restart_threshold if cfg.adaptive_restart else None)
    return args, static


@pytest.mark.parametrize("mode", list(BURST_MODES))
@pytest.mark.parametrize("B", [300, 301])
@pytest.mark.parametrize("n", [120, 200, 256, 400, 600, 900])
def test_qstream_cluster_kernel_is_the_streaming_kernels_bits(cuda, n, B, mode):
    """One burst with and without the gap on the route qstream_burst takes
    (the cluster kernel at each size the rule reaches, the streaming kernel
    at n = 900): every output to rtol 2e-4/atol 2e-5 of the twin's, and in
    the cluster window bit-identical to the streaming kernel forced at the
    same n."""
    kw, a2 = BURST_MODES[mode]
    args, static = _qstream_args(_random_gram(n, a2, cuda, B=B), kw, cuda)
    C = qstream.cluster_size(n)
    assert (C > 0) == (n <= CLUSTER_MAX_N)
    for with_gap in (True, False):
        before = launches("qstream")
        got = qstream.qstream_burst(*args, with_gap=with_gap, **static)
        streamed = qstream._launch_qstream(*args, with_gap=with_gap, cluster=0, **static)
        torch.cuda.synchronize()
        assert launches("qstream") == before + 2
        want = qstream._qstream_burst_reference(*args, with_gap=with_gap, **static)
        for gv, sv, wv in zip(got, streamed, want):
            torch.testing.assert_close(gv, wv, rtol=2e-4, atol=2e-5)
            assert torch.equal(gv, sv)


def test_qstream_refuses_launches_it_cannot_take(cuda):
    """A cluster launch the card cannot take raises; nothing falls back."""
    args, static = _qstream_args(_random_gram(600, 0.0, cuda, B=8), {}, cuda)
    for C in (1, 3, 16):  # 1.44 MB a CTA; not a power of two; past the portable 8
        with pytest.raises(RuntimeError, match="qstream_burst"):
            qstream._launch_qstream(*args, cluster=C, **static)
    with pytest.raises(ValueError, match="Qt"):
        qstream._launch_qstream(*args, Qt=qstream.relayout(args[2], 4), **static)


@pytest.mark.parametrize("n", [256, 900])
def test_qstream_relayouts_once_a_solve_in_the_cluster_window(cuda, n):
    """A certified solve re-lays Q once, at its first burst, in the cluster
    window (n = 256, C = 4); the streaming kernel past it (n = 900) reads Q
    as it is and re-lays nothing."""
    gb = _random_gram(n, 0.0, cuda, B=64)
    cfg = BatchFISTAConfig(max_iter=100, check_every=25, rel_gap_tol=1e-6)
    before = counters()["qstream_relayouts"]
    for solves in (1, 2):
        launched = launches("qstream")
        fista_vmem.fista_gram_vmem(gb, cfg)
        assert launches("qstream") > launched
        assert counters()["qstream_relayouts"] - before == (solves if n <= CLUSTER_MAX_N else 0)


def _power_gram(n, B, cuda, seed, spiked=False):
    """Q (n, n, B) as make_gram_batch's einsum leaves it (each lane's Gram
    contiguous) and a start v0 (n, B), on the card; ``spiked`` adds a common
    factor to every feature and scales λ to ~1, so the steps settle early."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn((B, 2 * n, n), generator=g, device=cuda) / n ** 0.5
    if spiked:
        A += 2.0 * torch.randn((B, 2 * n, 1), generator=g, device=cuda) / n ** 0.5
    Q = torch.einsum("bmi,bmj->ijb", A, A)
    if spiked:
        Q /= 8.0 * n
    return Q, torch.randn((n, B), generator=g, device=cuda)


def _power_both(Q, v0, n_iter=100, tol=1e-6):
    """``(L, steps)`` of the eager loop and of the kernel's route."""
    out = []
    for fn in (fista_gram._power_loop, lipschitz.power_L):
        before = counters()["power_steps"]
        L = fn(Q, v0, n_iter, tol)
        out.append((L, counters()["power_steps"] - before))
    return out


# lipschitz_cluster_size's last width: 8 CTAs' slabs fit a Hopper block to here
POWER_TOP = 664


def _assert_history_is_the_twins(Q, v0, n_iter=100):
    """The kernel's ``n_iter``-step history against the plain twin's on the
    same Q and v0, relative: step 1 of every lane to 1e-5; every step of all
    but 1% of the lanes to 1e-5; every step of every lane to 1e-3. A start
    nearly orthogonal to a lane's top eigenvector makes float32 itself
    ill-conditioned there: the step at which that vector takes over moves
    with the rounding, and two float32 summation orders of the twin differ
    on up to 4 lanes in 1003 past 1e-5, by up to 4.3e-4 (180 CPU runs at
    n = 5, 33, 130; step 1 ≤ 3.4e-7)."""
    hist = lipschitz._launch(Q, v0, n_iter)
    twin = lipschitz.power_history_reference(Q, v0, n_iter)
    rel = (hist - twin).abs() / twin.abs()
    assert float(rel[0].max()) <= 1e-5, float(rel[0].max())
    off = int((rel.amax(0) > 1e-5).sum())
    assert off <= 0.01 * Q.shape[-1], off
    assert float(rel.max()) <= 1e-3, float(rel.max())


def test_power_kernel_window(cuda):
    """The C export's cluster sizes: the smallest with at most 64 features a
    CTA, 0 outside 1..664; the kernel launches at the window's top and
    refuses a launch one past it at any size."""
    lib = _build.library()
    for n in range(0, 1101):
        assert (lib.lipschitz_cluster_size(n) > 0) == (1 <= n <= POWER_TOP), n
    edges = {1: 1, 64: 1, 65: 2, 128: 2, 129: 4, 256: 4, 257: 8, 512: 8, POWER_TOP: 8}
    assert {n: lipschitz.cluster_size(n) for n in edges} == edges
    Q, v0 = _power_gram(POWER_TOP, 3, cuda, seed=2)
    hist = lipschitz._launch(Q, v0, 2)
    torch.testing.assert_close(hist, lipschitz.power_history_reference(Q, v0, 2), rtol=1e-5,
                               atol=0.0)
    wide, v = _power_gram(POWER_TOP + 1, 3, cuda, seed=2)
    for C in (0, 8):
        with pytest.raises(RuntimeError, match="lipschitz_power"):
            lipschitz._launch(wide, v, 2, cluster=C)


@pytest.mark.parametrize("n,B", [(1, 1003), (5, 1003), (33, 1003), (130, 1003), (200, 1003),
                                 (256, 1003), (257, 1003), (600, 1003), (POWER_TOP, 1003),
                                 (256, 7552)])
def test_power_kernel_matches_the_loop(cuda, n, B):
    """All 100 steps (B = 1003 is ragged; n = 256, B = 7552 is the
    ``wide256`` deployment): the kernel's history against the plain twin's
    on the same Q and v0 at every step (``_assert_history_is_the_twins``);
    through the route, the loop's step count (100: the 1e-6 stop is not
    met) and L to 1e-5 relative, in one launch."""
    Q, v0 = _power_gram(n, B, cuda, seed=n)
    _assert_history_is_the_twins(Q, v0)
    launched = launches("lipschitz")
    (loop, k_loop), (kern, k_kern) = _power_both(Q, v0)
    torch.cuda.synchronize()
    assert launches("lipschitz") == launched + 1
    assert k_kern == k_loop
    torch.testing.assert_close(kern, loop, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n,B", [(256, 1003), (64, 301)])
def test_power_kernel_stops_where_the_loop_stops(cuda, n, B):
    """At tol 1e-4 on Grams with a dominant eigenvalue the loop stops after
    a few steps; the kernel's route picks the same step and L, and the
    history it picks from is the twin's at every step."""
    Q, v0 = _power_gram(n, B, cuda, seed=7, spiked=True)
    (loop, k_loop), (kern, k_kern) = _power_both(Q, v0, tol=1e-4)
    assert 1 < k_loop < 20 and k_kern == k_loop
    torch.testing.assert_close(kern, loop, rtol=1e-5, atol=0.0)
    _assert_history_is_the_twins(Q, v0)


# width -> the cluster sizes the kernel takes there: every size whose CTA has
# at most 128 features (512 threads) and fits a block
POWER_SIZES = {5: (1, 2, 4, 8), 100: (1, 2, 4, 8), 256: (2, 4, 8), 257: (4, 8)}


@pytest.mark.parametrize("n", list(POWER_SIZES))
def test_power_kernel_bits_do_not_depend_on_layout_or_cluster(cuda, n):
    """Each feature's sum runs in one order whatever the cluster size and
    whatever Q's strides: the history is the same bits at every size the
    card takes and on a lanes-last copy of Q; the other sizes raise."""
    Q, v0 = _power_gram(n, 301, cuda, seed=3)
    want = lipschitz._launch(Q, v0, 40)
    assert torch.equal(lipschitz._launch(Q.contiguous(), v0, 40), want)
    for C in (1, 2, 4, 8):
        if C in POWER_SIZES[n]:
            assert torch.equal(lipschitz._launch(Q, v0, 40, cluster=C), want), C
        else:
            with pytest.raises(RuntimeError, match="lipschitz_power"):
                lipschitz._launch(Q, v0, 40, cluster=C)


def test_power_kernel_refuses_what_it_cannot_take(cuda):
    Q, v0 = _power_gram(20, 8, cuda, seed=1)
    with pytest.raises(ValueError, match="float32 CUDA"):
        lipschitz._launch(Q.double(), v0, 5)
    with pytest.raises(ValueError, match="v0"):
        lipschitz._launch(Q, v0[:, :4], 5)
    with pytest.raises(RuntimeError, match="lipschitz_power"):
        lipschitz._launch(Q, v0, 5, cluster=3)
    wide, v = _power_gram(POWER_TOP + 1, 2, cuda, seed=1)
    assert not fista_gram._power_on_kernel(wide) and not fista_gram._power_on_kernel(Q.double())
    with pytest.raises(RuntimeError, match="lipschitz_power"):
        lipschitz._launch(wide, v, 5)


def test_the_precompute_reads_the_host_once_on_the_power_kernel(cuda):
    """make_gram_batch at n = 200: ``fos.lipschitz`` holds one ``fos.sync``
    and one launch span, ``power_steps`` is the loop's count, and
    ``launches.lipschitz`` is 1; the loop's precompute on the same data
    reads the host once a step."""
    g = torch.Generator(device=cuda).manual_seed(5)
    A = torch.randn((301, 400, 200), generator=g, device=cuda) / 200 ** 0.5
    b = torch.randn((301, 400), generator=g, device=cuda)
    profiling.reset_counters()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        gb = make_gram_batch(A, b, 0.1, 0.0)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    c = counters()
    rows = profiling.spans()
    lip = next(i for i, row in enumerate(rows) if row[1] == "fos.lipschitz")
    assert [row[1] for row in rows if row[2] == lip] == ["fos.launch.lipschitz", "fos.sync"]
    assert c["launches.lipschitz"] == 1
    v0 = torch.randn((200, 301), generator=torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    Q = torch.einsum("bmi,bmj->ijb", A, A)
    profiling.reset_counters()
    loop = fista_gram._power_loop(Q, v0, 100, 1e-6)
    assert c["power_steps"] == counters()["power_steps"]
    torch.testing.assert_close(gb.L, loop, rtol=1e-5, atol=0.0)


SLAB_MODES = dict(
    {name: BURST_MODES[name] for name in ("nesterov", "restart", "greedy")},
    armijo=(dict(backtracking=True), 0.0),
    armijo_restart=(dict(backtracking=True, adaptive_restart=True), 0.0))
# odd n², the window's ends, and both ends of each run of widths with one
# group (tests/burst_grouping.py): every lanes-a-CTA count, paired and alone
SLAB_WIDTHS = [1, 5, 20, 32, 33, 48, 58, 59, 60, 61, 62, 63, 64, 65, 74, 75, 78, 79,
               80, 83, 84, 89, 90, 96, 97, 104]


def _slab_lanes(n, B):
    """The slab's lanes and each lane's floats: ceil(B / G)·G and n²
    rounded up to 4."""
    G = min(_build.library().fista_burst_group(n), B)
    return -(-B // G) * G, -(-n * n // 4) * 4


@pytest.mark.parametrize("mode", list(SLAB_MODES))
@pytest.mark.parametrize("n", SLAB_WIDTHS)
def test_burst_slab_is_the_gather_bits(cuda, n, mode):
    """Three bursts of 25 with the gap at B = 301 (a ragged last CTA): the
    first stores the Grams to the slab, the next two read them from it.
    Every output of each burst is bit-equal to the same bursts gathered from
    Q, and (outside Armijo, whose accept/reject sits on the last bits) within
    rtol 2e-4/atol 2e-5 of the twin's burst from the same state; the slab
    holds each lane's Gram, zeros past the batch and in the stride's
    padding."""
    kw, a2 = SLAB_MODES[mode]
    gb = _random_gram(n, a2, cuda, B=301)
    args, static = _qstream_args(gb, kw, cuda)
    static = dict(static, with_gap=True,
                  armijo=fista_vmem._armijo_static(BatchFISTAConfig(**kw)))
    S = torch.empty(fista_vmem.slab_floats(n, 301), device=cuda)

    def bursts(slab_kw):
        """Each burst's inputs and outputs, each from the last one's state."""
        a, ins, outs = list(args), [], []
        for j, extra in enumerate(slab_kw):
            a[1] = 25 * j
            ins.append(tuple(a))
            outs.append(fista_vmem._launch_burst(*a, **static, **extra))
            a[9:13], a[14] = outs[-1][:4], outs[-1][4]
        return ins, outs
    before = counters()["launches.burst"]
    ins, slab = bursts([dict(S=S), dict(S=S, slab_ready=True), dict(S=S, slab_ready=True)])
    _, gathered = bursts([{}] * 3)
    torch.cuda.synchronize()
    assert counters()["launches.burst"] == before + 6
    for got, want in zip(slab, gathered):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if not mode.startswith("armijo"):
        for a, got in zip(ins, slab):
            for g, w in zip(got, fista_vmem._burst_reference(*a, **static)):
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)
    lanes, qs = _slab_lanes(n, 301)
    Sv = S.view(lanes, qs)
    assert torch.equal(Sv[:301, :n * n], gb.Q.permute(2, 0, 1).reshape(301, n * n))
    assert not Sv[301:].any() and not Sv[:, n * n:].any()


@pytest.mark.parametrize("mode", list(SLAB_MODES))
@pytest.mark.parametrize("n", [20, 33, 48, 61, 64, 65, 80, 96, 97, 104])
def test_certified_solve_on_the_slab_is_the_gather_bits(cuda, n, mode, monkeypatch):
    """A certified solve through ``fista_gram_vmem`` (B = 301): one slab
    write, reads for the rest of its bursts, each launch counted paired
    where an SM holds two CTAs at n, and every field of the result
    and state bit-equal to the solve with every burst gathered from Q; then
    50 + 100 iterations through ``state0`` equal 150 straight ones bit for
    bit, each part a solve with its own slab."""
    kw, a2 = SLAB_MODES[mode]
    gb = _random_gram(n, a2, cuda, B=301, seed=21)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6, **kw)
    keys = ("burst_slab_writes", "burst_slab_reads", "launches.burst", "burst_paired_launches")
    before = [counters()[k] for k in keys]
    got, got_state = fista_vmem.fista_gram_vmem(gb, cfg, return_state=True)
    writes, reads, launched, paired = (counters()[k] - b for k, b in zip(keys, before))
    assert writes == 1 and reads >= 1 and writes + reads == launched
    assert paired == (launched if burst_grouping.table()[n][2] >= 2 else 0)
    cut = lambda k: BatchFISTAConfig(max_iter=k, check_every=25, rel_gap_tol=0.0, **kw)
    straight = fista_vmem.fista_gram_vmem(gb, cut(150))
    _, mid = fista_vmem.fista_gram_vmem(gb, cut(50), return_state=True)
    resumed = fista_vmem.fista_gram_vmem(gb, cut(150), state0=mid)
    assert torch.equal(resumed.x, straight.x) and torch.equal(resumed.rel_gap, straight.rel_gap)
    monkeypatch.setattr(fista_vmem, "make_burst", lambda Q, n_bursts: fista_vmem._launch_burst)
    want, want_state = fista_vmem.fista_gram_vmem(gb, cfg, return_state=True)
    for f in ("x", "iters", "rel_gap", "converged", "failed"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("X", "Y", "t", "ps", "tau", "done", "iters", "gap"):
        assert torch.equal(getattr(got_state, f), getattr(want_state, f)), f
    assert torch.equal(fista_vmem.fista_gram_vmem(gb, cut(150)).x, straight.x)


def test_burst_slab_export_and_refusals(cuda):
    """``fista_burst_slab_floats`` is ceil(B / G)·G lanes of n² rounded up
    to 4 floats at every n of the window, 0 outside it; a CTA's shared bytes
    leave room for the slab read's mbarrier; a launch refuses a slab of
    another size and ``slab_ready`` without one."""
    lib = _build.library()
    for n in range(1, fista_vmem.MAX_N + 1):
        assert lib.fista_burst_smem_bytes(n) + 16 <= 232448, n
        for B in (1, 7, 301, 54144):
            lanes, qs = _slab_lanes(n, B)
            assert fista_vmem.slab_floats(n, B) == lanes * qs, (n, B)
    assert lib.fista_burst_slab_floats(0, 8) == lib.fista_burst_slab_floats(105, 8) == 0
    assert lib.fista_burst_slab_floats(20, 0) == 0
    args, static = _qstream_args(_random_gram(20, 0.0, cuda, B=301), {}, cuda)
    with pytest.raises(ValueError, match="slab_ready"):
        fista_vmem._launch_burst(*args, slab_ready=True, **static)
    with pytest.raises(ValueError, match="S must hold"):
        fista_vmem._launch_burst(*args, S=torch.empty(16, device=cuda), **static)


def test_stream_gram_feed_gives_the_same_bits_for_every_ring_depth(cuda):
    """The pinned ring and side-stream copies of ``stream_gram`` on the card:
    prefetch 1, 2 and 3 reduce the same chunks (float64 cast in the copy,
    ragged sizes that grow a slot past its first size) to the same bits, and
    agree with the float64 reduction to 2e-5 of each entry's scale."""
    from fastoptsolver_tpu_torch.problems import stream_gram

    rng = np.random.default_rng(4)
    sizes = (1000, 3000, 500, 7000, 70, 6500, 4096)
    chunks = [(rng.normal(size=(r, 33)), rng.normal(size=r)) for r in sizes]
    grams = [stream_gram(iter(chunks), n=33, prefetch=p, device=cuda) for p in (1, 2, 3)]
    for g in grams[1:]:
        for f in ("Q", "c", "btb", "m"):
            assert torch.equal(getattr(g, f), getattr(grams[0], f)), f
    A = np.concatenate([a for a, _ in chunks]).astype(np.float32).astype(np.float64)
    b = np.concatenate([v for _, v in chunks]).astype(np.float32).astype(np.float64)
    g = grams[0]
    assert g.Q.is_cuda and g.m.dtype == torch.int64 and int(g.m) == sum(sizes)
    scale = np.abs(A).T @ np.abs(A)
    assert np.all(np.abs(g.Q.cpu().numpy() - A.T @ A) <= 2e-5 * scale)
    np.testing.assert_allclose(float(g.btb), float(b @ b), rtol=2e-6)


def test_fista_gram_dense_on_the_card_matches_the_cpu(cuda):
    """The dense solve on the card against the same solve on the CPU, both
    from the CPU generator's start vector: x to 1e-5, iterations and
    ``converged`` equal (the matvecs sum in other orders)."""
    from fastoptsolver_tpu_torch.problems import DenseGram
    from fastoptsolver_tpu_torch.solvers import DenseGramConfig
    from fastoptsolver_tpu_torch.solvers.gram_dense import _solve

    rng = np.random.default_rng(5)
    A = rng.normal(size=(4000, 64)) / 8.0
    b = A[:, :8] @ rng.normal(size=8) * 3.0 + 0.1 * rng.normal(size=4000)
    a1 = 0.1 * float(np.abs(A.T @ b).max())
    t = lambda v, dev: torch.as_tensor(v, dtype=torch.float32, device=dev)
    cfg = DenseGramConfig(max_iter=3000, check_every=50, rel_gap_tol=1e-6)
    v0 = torch.randn(64, generator=torch.Generator().manual_seed(0))
    out = []
    for dev in (torch.device("cpu"), cuda):
        g = DenseGram(Q=t(A.T @ A, dev), c=t(A.T @ b, dev), btb=t(b @ b, dev),
                      m=torch.tensor(4000, device=dev))
        out.append(_solve(g, a1, 0.0, v0.to(dev), cfg))
    cpu, card = out
    assert bool(card.converged) and bool(cpu.converged) and card.x.is_cuda
    assert int(card.iters) == int(cpu.iters)
    np.testing.assert_allclose(card.x.cpu().numpy(), cpu.x.numpy(), rtol=1e-5, atol=1e-5)


def test_one_rank_nccl_mesh_is_the_plain_call(cuda):
    """``solve_lasso_batch(mesh=)`` over a one-rank NCCL mesh on the card:
    one fused launch, and x, iters and converged bit-equal to the plain
    call (B = 390 pads to 512 lanes, which certify at once)."""
    import torch.distributed as dist

    from fastoptsolver_tpu_torch.parallel import make_mesh

    A, b, a1 = _problem(5, 250, 390, seed=0, device=cuda)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    plain = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, feature_major=True)
    joined = dist.is_initialized()
    mesh = make_mesh(batch=1)
    try:
        assert dist.get_backend() == "nccl"
        before = launches("fused")
        res = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, feature_major=True, mesh=mesh)
        torch.cuda.synchronize()
        assert launches("fused") == before + 1
        for name in ("x", "iters", "converged"):
            assert torch.equal(getattr(res, name), getattr(plain, name)), name
    finally:
        if not joined:
            dist.destroy_process_group()


def test_verify_tpu_holds_each_kernel_against_the_driver(cuda):
    """``bench.verify_tpu.run()`` on the card (chip_smoke phase 16): every
    check holds but ``resident_armijo_resume`` (ROADMAP Queue 3), which may
    fail only in its Armijo reading, and only while the torch driver
    against itself with its features permuted exceeds that limit too; every
    kernel but the stream kernel launches."""
    from fastoptsolver_tpu_torch.bench import verify_tpu

    kernels = ("fused", "gram", "burst", "resident", "qstream")
    before = [launches(k) for k in kernels]
    rep = verify_tpu.run()
    torch.cuda.synchronize()
    assert all(launches(k) > b for k, b in zip(kernels, before))
    assert rep["detail"]["device"] == torch.cuda.get_device_name(cuda)
    failed = [n for n in verify_tpu.CHECK_NAMES if not rep["detail"][n]]
    assert set(failed) <= {"resident_armijo_resume"}, failed
    label = "Armijo x |d|/(atol + rtol·|ref|)"
    for name in failed:
        assert all(verify_tpu.holds(r) for k, r in rep["readings"][name].items() if k != label)
        assert max(verify_tpu.armijo_reorder_spread(verify_tpu.Inputs(cuda))) > 1.0
