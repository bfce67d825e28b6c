"""The kernel library's build key (``fastoptsolver_tpu_torch.kernels._build``):
the cached build is named by a hash of the flags and of every file under
``csrc/``, so an edited source or an edited header it includes rebuilds.
Nothing here needs nvcc or a card."""
import shutil

import pytest

from fastoptsolver_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_digest_of_a_copy_is_the_trees(csrc):
    assert _build._digest(csrc) == _build._digest()


@pytest.mark.parametrize("name", ["tri_matvec.cuh", "resident.cu", "gram_build.cu"])
def test_digest_follows_an_edited_file(csrc, name):
    before = _build._digest(csrc)
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._digest(csrc) != before


def test_digest_follows_a_new_header(csrc):
    before = _build._digest(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest(csrc) != before


def test_every_source_is_hashed_and_compiled():
    """Each compiled source lies under csrc/, and the headers beside them
    are hashed though not compiled on their own."""
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) <= names
    assert "tri_matvec.cuh" in names and "tri_matvec.cuh" not in _build.SOURCES


def _cpu_launches():
    """Each launch wrapper of the port, called with CPU tensors of valid
    shapes: the kernel it names and the call."""
    import torch

    from fastoptsolver_tpu_torch.batch.fista_gram import GramBatch
    from fastoptsolver_tpu_torch.bench import stream
    from fastoptsolver_tpu_torch.kernels import fista_vmem, fused_solve, gram_build
    from fastoptsolver_tpu_torch.kernels import qstream, resident

    n, m, B = 4, 8, 32
    A, b, v, row = torch.ones((n, m, B)), torch.ones((m, B)), torch.ones(B), torch.ones((1, B))
    Q, c, betas = torch.ones((n, n, B)), torch.ones((n, B)), torch.zeros(10)
    gb = GramBatch(Q=Q, c=c, btb=v, alpha1=v, alpha2=v, L=v)
    burst = (betas, 0, Q, c, row, row, row, row, row, c, c, row, row, None, row)
    return {
        "fused": lambda: fused_solve._launch(
            A, b, v, v, betas, b_tile=128, pl_iters=32, l_safety=1.02, t_init=1.0,
            chunk=5, k_end=5, tol=1e-6),
        "resident": lambda: resident._launch(
            betas, gb, row, row, row, None, b_tile=4, chunk=5, k_end=5, tol=1e-6,
            restart_threshold=None, greedy=None, armijo=None, est_l_iters=None,
            l_safety=1.02, t_init=1.0),
        "burst": lambda: fista_vmem._launch_burst(*burst, n_steps=5),
        "qstream": lambda: qstream._launch_qstream(*burst, n_steps=5),
        "gram_pairs": lambda: gram_build._launch_pairs(A, b),
        "gram_power": lambda: gram_build._launch_power(Q, c, 8),
        "stream": lambda: stream._launch(A, b, 128),
    }


@pytest.mark.parametrize("kernel", ["fused", "resident", "burst", "qstream",
                                    "gram_pairs", "gram_power", "stream"])
def test_every_launch_wrapper_refuses_a_cpu_tensor(kernel):
    """The checks of the one C-call path run before the library is asked
    for: a CPU tensor raises, names CUDA, and counts no launch."""
    from fastoptsolver_tpu_torch.utils.profiling import counters

    before = counters()[f"launches.{kernel}"]
    with pytest.raises(ValueError, match="must be a contiguous float32 CUDA tensor"):
        _cpu_launches()[kernel]()
    assert counters()[f"launches.{kernel}"] == before


@pytest.mark.parametrize("cfg_kw, code", [
    (dict(), 0),
    (dict(momentum="delta"), 0),
    (dict(adaptive_restart=True), 1),
    (dict(momentum="greedy"), 2),
    (dict(backtracking=True), 0),
    (dict(adaptive_restart=True, backtracking=True), 1),
], ids=["fixed", "delta", "restart", "greedy", "armijo", "restart_armijo"])
def test_mode_args_are_the_codes_the_kernels_read(cfg_kw, code):
    """csrc/*.cu read mode 0 (the β table), 1 (adaptive restart) or 2
    (greedy), and zeros for what a mode does not use."""
    from fastoptsolver_tpu_torch.batch.fista_gram import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels.fista_vmem import _armijo_static

    cfg = BatchFISTAConfig(**cfg_kw)
    restart = cfg.restart_threshold if cfg.adaptive_restart else None
    greedy = (cfg.greedy_S, cfg.greedy_shrink) if cfg.momentum == "greedy" else None
    got = _build.mode_args(restart, greedy, _armijo_static(cfg))
    want_greedy = (1.02, 0.96) if code == 2 else (0.0, 0.0)
    want_armijo = (1e-2, 0.5, 20) if cfg.backtracking else (0.0, 0.0, 0)
    assert got == (code, 1.0 if code == 1 else 0.0, *want_greedy, *want_armijo)
    assert type(got[1]) is float


def test_refuse_interpret_only_on_a_cuda_tensor():
    for interpret, on_cuda in ((False, False), (True, False), (False, True)):
        _build.refuse_interpret(interpret, on_cuda)
    with pytest.raises(ValueError, match="interpret=True runs the plain twin.*CUDA tensor"):
        _build.refuse_interpret(True, True)
