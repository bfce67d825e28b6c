"""The routed batched-lasso surface and the stacked single-problem solves
(port of ``fastoptsolver_tpu/batch/api.py``: ``_kernel_route``,
``solve_gram_batch``, ``solve_lasso_batch``, ``_resume_lasso_batch``,
``_solve_resident_routed``, ``_build_gram_routed``, and ``stack_problems``,
``batch_lipschitz``, ``solve_batch``).

Routing follows the reference's "guards decide" rule, in its order:

1. **Kernel route or driver** — ``_kernel_route`` asks the kernel guards
   (``_check_kernel_cfg`` + ``plan_gram_solve``) whether a kernel engine can
   take ``(n, cfg)``. It can when ``A`` is a CUDA tensor (the reference's
   ``jax.default_backend() == "tpu"``) or ``interpret=True``, and the plan
   finds an engine: n ≤ 1016, and no Armijo where Q must stream (past
   n = 168, or ``check_every <= 0`` past 104). ``interpret=True`` with a
   CUDA tensor raises.
2. On the kernel route, **the fused kernel** first (``kernels.fused_solve``:
   one launch, the Gram never in device memory) when its own guards pass:
   ``check_every > 0`` and n ≤ 8, in every mode (fixed, adaptive restart,
   greedy, Armijo) and with ``return_state``.
3. Then, in the **resident window** (104 < n ≤ 168, ``check_every > 0``,
   every mode including Armijo): the Gram built without the power loop
   (``make_gram_batch(..., estimate_l=False)``: the port's build kernels
   stop at n = 118) and one launch of the resident kernel
   (``kernels.resident.fista_gram_resident``) with L estimated in-kernel
   (``_RESIDENT_EST_L_ITERS`` power steps).
4. Otherwise **the two-kernel path**: the Gram build
   (``kernels.gram_build.make_gram_batch_fused``, two launches, n ≤ 118;
   past it the torch einsum and power loop) and ``fista_gram_vmem``: the
   burst engine (n ≤ 104) or the Q-streaming engine (``kernels.qstream``),
   one launch per burst. On a CPU tensor under ``interpret`` every kernel
   runs its plain twin.
5. Otherwise **the torch driver** (``make_gram_batch`` +
   ``fista_gram_batch``), always under ``backend="xla"`` (the reference's
   name for "force the driver", kept for the same meaning).

``backend="kernel"`` raises with the guard's message when the kernel route
cannot serve the call, including a CPU tensor without ``interpret``.
``state0`` pins the route to the engine whose state it is
(``ResidentSolveState`` → resident engine, ``FusedSolveState`` → fused
kernel, ``VmemSolveState`` → burst or Q-streaming engine, ``BatchState`` →
driver); ``mesh=`` is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from .fista_gram import (
    BatchFISTAConfig,
    BatchState,
    fista_gram_batch,
    make_gram_batch,
)

# In-kernel Lipschitz depth of the resident route, used by the fresh solve and
# the resume alike: a resumed trajectory's τ derives from this estimate, so it
# must be the same at checkpoint and at resume.
_RESIDENT_EST_L_ITERS = 96


def _default_cfg() -> BatchFISTAConfig:
    return BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def _not_on_kernel_reason(interpret: bool, on_cuda: bool):
    """None when the kernel route can run here, else why not; raises for
    ``interpret=True`` with a CUDA tensor."""
    if interpret and on_cuda:
        raise ValueError("interpret=True runs the plain twin on a CPU tensor; "
                         "A is a CUDA tensor")
    if on_cuda or interpret:
        return None
    return "not a CUDA tensor (pass interpret=True to run the plain twins)"


def _kernel_route(n: int, cfg, backend: str, interpret: bool, on_cuda: bool):
    """Can/should this (n, cfg) run on a kernel engine? Returns
    ``(use_kernel, reason_if_not)``; raises under ``backend="kernel"`` when
    the answer is no, with the guard's message."""
    if backend not in ("auto", "kernel", "xla"):
        raise ValueError(f"Unknown backend '{backend}'")
    if backend == "xla":
        return False, "backend='xla'"
    from ..kernels.fista_vmem import _check_kernel_cfg, plan_gram_solve

    try:
        _check_kernel_cfg(cfg)
        plan_gram_solve(n, cfg)
    except (ValueError, NotImplementedError) as e:
        if backend == "kernel":
            raise ValueError(f"backend='kernel' unsupported here: {e}") from e
        return False, str(e)
    reason = _not_on_kernel_reason(interpret, on_cuda)
    if reason is None:
        return True, None
    if backend == "kernel":
        raise ValueError(f"backend='kernel' unsupported here: {reason}")
    return False, reason


def solve_gram_batch(gb, cfg=None, backend: str = "auto",
                     interpret: bool = False, state0=None,
                     return_state: bool = False,
                     est_l_iters: int | None = None):
    """Route a prebuilt ``GramBatch`` to its fastest supported solver:
    ``fista_gram_vmem`` (the burst, resident or Q-streaming engine, as
    ``plan_gram_solve`` picks) when the kernel route can take it (a CUDA
    tensor, or ``interpret=True``), otherwise the torch driver
    (``fista_gram_batch``). ``"kernel"`` forces the kernel route (raises
    with the guard's reason if unsupported); ``"xla"`` forces the driver.

    A non-None ``state0`` pins the route to the engine that produced it: a
    ``ResidentSolveState`` resumes on the resident engine, a
    ``VmemSolveState`` on the burst-driven engines, a ``BatchState`` on the
    driver; anything else raises ``TypeError``, a ``FusedSolveState`` too
    (a Gram cannot resume the fused engine, which builds its own).

    ``est_l_iters``: the resident engine's in-kernel L estimate, for a Gram
    built with ``estimate_l=False``; required to resume a
    ``ResidentSolveState`` on such a Gram (``solve_lasso_batch`` uses
    ``_RESIDENT_EST_L_ITERS`` = 96). A fresh solve forwards it to the
    resident engine and refuses it on any other route (the reference ignores
    it there, and a sentinel L then runs with τ = t_init)."""
    from ..kernels.fista_vmem import VmemSolveState, fista_gram_vmem, plan_gram_solve
    from ..kernels.resident import ResidentSolveState, fista_gram_resident

    if cfg is None:
        cfg = _default_cfg()
    on_cuda = gb.Q.is_cuda
    if state0 is not None:
        if isinstance(state0, ResidentSolveState):
            if backend == "xla":
                raise ValueError("state0 is a ResidentSolveState; it cannot "
                                 "resume on backend='xla'")
            reason = _not_on_kernel_reason(interpret, on_cuda)
            if reason is not None:
                raise ValueError(
                    f"state0 is a kernel-path ResidentSolveState but {reason}")
            if est_l_iters is None and bool((gb.L == 1.0).all()):
                # the reference's guard (batch/api.py:137-149): an
                # estimate_l=False Gram carries L = 1 on every lane, and τ =
                # t_init/1 would silently leave the checkpointed trajectory
                raise ValueError(
                    "this GramBatch carries the estimate_l=False sentinel; "
                    "pass est_l_iters= matching the run that produced state0 "
                    f"(solve_lasso_batch uses {_RESIDENT_EST_L_ITERS})"
                )
            return fista_gram_resident(gb, cfg, interpret=interpret,
                                       state0=state0, est_l_iters=est_l_iters,
                                       return_state=return_state)
        if isinstance(state0, VmemSolveState):
            if backend == "xla":
                raise ValueError(
                    "state0 is a kernel-path VmemSolveState; it cannot resume "
                    "on backend='xla' (the torch driver's BatchState carries a "
                    "different trajectory layout)"
                )
            reason = _not_on_kernel_reason(interpret, on_cuda)
            if reason is not None:
                raise ValueError(f"state0 is a kernel-path VmemSolveState but {reason}")
            return fista_gram_vmem(gb, cfg, interpret=interpret, state0=state0,
                                   return_state=return_state)
        if isinstance(state0, BatchState):
            if backend == "kernel":
                raise ValueError(
                    "state0 is a torch-driver BatchState; it cannot resume "
                    "on backend='kernel'"
                )
            return fista_gram_batch(gb, cfg, state0=state0,
                                    return_state=return_state)
        raise TypeError(
            f"state0 must be a ResidentSolveState, VmemSolveState, or "
            f"BatchState, got {type(state0).__name__}"
        )
    use_kernel, reason = _kernel_route(gb.dim, cfg, backend, interpret, on_cuda)
    if est_l_iters is not None:
        if not use_kernel or plan_gram_solve(gb.dim, cfg)[0] != "resident":
            raise ValueError(
                "est_l_iters configures the resident engine's in-kernel L "
                "estimate; this call routes to "
                + ("the torch driver" if not use_kernel else "another engine")
                + (f" ({reason})" if reason else "")
            )
        return fista_gram_resident(gb, cfg, interpret=interpret,
                                   est_l_iters=est_l_iters,
                                   return_state=return_state)
    if use_kernel:
        return fista_gram_vmem(gb, cfg, interpret=interpret,
                               return_state=return_state)
    return fista_gram_batch(gb, cfg, return_state=return_state)


def _feature_major(A, b, feature_major: bool):
    if feature_major:
        return A, b
    return A.permute(2, 1, 0).contiguous(), b.T.contiguous()


def _build_gram_routed(A, b, alpha1, alpha2, feature_major, key, interpret,
                       use_kernel, estimate_l=True):
    """The Gram stage of :func:`solve_lasso_batch`, shared with the resume
    dispatch: the build kernels (their twin on a CPU tensor) inside their
    window (n ≤ 118) on the kernel route, otherwise the torch precompute
    ``make_gram_batch`` with its power iteration started from ``key``;
    ``estimate_l=False`` skips the power iteration of either build (L = 1
    sentinel), for the resident engine's in-kernel estimate."""
    n = A.shape[0] if feature_major else A.shape[-1]
    fused_build = False
    if use_kernel:
        from ..kernels.gram_build import _auto_tiles

        try:
            _auto_tiles(n, A.shape[1])
            fused_build = True
        except ValueError:
            fused_build = False
    if fused_build:
        from ..kernels.gram_build import make_gram_batch_fused

        A_fm, b_fm = _feature_major(A, b, feature_major)
        gb = make_gram_batch_fused(A_fm.contiguous(), b_fm.contiguous(),
                                   alpha1, alpha2, interpret=interpret,
                                   pl_iters=None if estimate_l else 0)
        return gb if estimate_l else dataclasses.replace(gb, L=torch.ones_like(gb.L))
    A_im = A.permute(2, 1, 0) if feature_major else A
    b_im = b.T if feature_major else b
    return make_gram_batch(A_im, b_im, alpha1, alpha2, generator=key,
                           estimate_l=estimate_l)


def _solve_resident_routed(A, b, alpha1, alpha2, cfg, feature_major, key,
                           interpret, state0=None, return_state=False):
    """The resident window's recipe, shared by the fresh route and the
    resume dispatch so that both give the same floats: the Gram built
    without the power loop, then the resident engine with L estimated
    in-kernel against the Gram it holds (``_RESIDENT_EST_L_ITERS`` steps).
    Past n = 118 the build is the einsum precompute, as in the reference;
    at 104 < n ≤ 118 the port's build kernels take it, without their power
    steps."""
    from ..kernels.resident import fista_gram_resident

    gb = _build_gram_routed(A, b, alpha1, alpha2, feature_major, key,
                            interpret, use_kernel=True, estimate_l=False)
    return fista_gram_resident(gb, cfg, interpret=interpret,
                               est_l_iters=_RESIDENT_EST_L_ITERS,
                               state0=state0, return_state=return_state)


def solve_lasso_batch(
    A,
    b,
    alpha1,
    alpha2=0.0,
    cfg=None,
    backend: str = "auto",
    feature_major: bool = False,
    key: torch.Generator | None = None,
    interpret: bool = False,
    state0=None,
    return_state: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
):
    """One call from raw ``(A, b, α)`` to certified batched lasso solutions,
    routed as the module docstring says.

    ``feature_major``: inputs are ``A (n, m, B), b (m, B)`` (the native
    layout, no transpose); otherwise ``A (B, m, n), b (B, m)``. ``key`` is
    the ``torch.Generator`` for the driver's power-iteration start (the
    reference takes a ``jax.random`` key there). Returns a ``BatchResult``,
    or ``(result, state)`` with ``return_state``; ``state0`` resumes on the
    engine whose state it is."""
    if mesh is not None:  # mesh_axis alone is ignored, as the reference does
        raise NotImplementedError(
            "solve_lasso_batch(mesh=) is not ported yet (ROADMAP Queue 1 "
            "item 7: torch.distributed)"
        )
    if cfg is None:
        cfg = _default_cfg()
    n = A.shape[0] if feature_major else A.shape[-1]
    if state0 is not None:
        return _resume_lasso_batch(A, b, alpha1, alpha2, cfg, backend,
                                   feature_major, key, interpret, state0,
                                   return_state)

    # route before building: a doomed backend='kernel' call must not first
    # spend the Gram build
    use_kernel, _ = _kernel_route(n, cfg, backend, interpret, A.is_cuda)
    if use_kernel:
        from ..kernels.fused_solve import (
            _check_fused_cfg,
            auto_tiles_fused,
            solve_lasso_fused,
        )

        try:
            _check_fused_cfg(cfg)
            auto_tiles_fused(n, A.shape[1])
        except (NotImplementedError, ValueError):
            pass
        else:
            A_fm, b_fm = _feature_major(A, b, feature_major)
            return solve_lasso_fused(A_fm.contiguous(), b_fm.contiguous(),
                                     alpha1, alpha2, cfg=cfg,
                                     interpret=interpret,
                                     return_state=return_state)
        from ..kernels.fista_vmem import plan_gram_solve

        if plan_gram_solve(n, cfg)[0] == "resident":
            return _solve_resident_routed(A, b, alpha1, alpha2, cfg,
                                          feature_major, key, interpret,
                                          return_state=return_state)

    gb = _build_gram_routed(A, b, alpha1, alpha2, feature_major, key,
                            interpret, use_kernel)
    if use_kernel:
        from ..kernels.fista_vmem import fista_gram_vmem

        return fista_gram_vmem(gb, cfg, interpret=interpret,
                               return_state=return_state)
    return fista_gram_batch(gb, cfg, return_state=return_state)


def _resume_lasso_batch(A, b, alpha1, alpha2, cfg, backend, feature_major,
                        key, interpret, state0, return_state):
    """Resume dispatch for :func:`solve_lasso_batch`: the state type pins the
    engine. The Gram is rebuilt from the same ``(A, b)`` by the same route,
    so only the solver rows round-trip."""
    from ..kernels.fista_vmem import VmemSolveState, fista_gram_vmem
    from ..kernels.fused_solve import FusedSolveState, solve_lasso_fused
    from ..kernels.resident import ResidentSolveState

    n = A.shape[0] if feature_major else A.shape[-1]
    if isinstance(state0, ResidentSolveState):
        if backend == "xla":
            raise ValueError("state0 is a ResidentSolveState; it cannot "
                             "resume on backend='xla'")
        _kernel_route(n, cfg, "kernel", interpret, A.is_cuda)
        return _solve_resident_routed(A, b, alpha1, alpha2, cfg, feature_major,
                                      key, interpret, state0=state0,
                                      return_state=return_state)
    if isinstance(state0, FusedSolveState):
        if backend == "xla":
            raise ValueError(
                "state0 is a FusedSolveState; it cannot resume on "
                "backend='xla' (the driver's trajectory differs)"
            )
        # the fused engine's own guards decide; a fused checkpoint on any
        # other engine would change the trajectory, so they raise
        _kernel_route(n, cfg, "kernel", interpret, A.is_cuda)
        A_fm, b_fm = _feature_major(A, b, feature_major)
        return solve_lasso_fused(A_fm.contiguous(), b_fm.contiguous(), alpha1,
                                 alpha2, cfg=cfg, interpret=interpret,
                                 state0=state0, return_state=return_state)
    if isinstance(state0, VmemSolveState):
        if backend == "xla":
            raise ValueError(
                "state0 is a kernel-path VmemSolveState; it cannot resume "
                "on backend='xla'"
            )
        _kernel_route(n, cfg, "kernel", interpret, A.is_cuda)
        gb = _build_gram_routed(A, b, alpha1, alpha2, feature_major, key,
                                interpret, use_kernel=True)
        return fista_gram_vmem(gb, cfg, interpret=interpret, state0=state0,
                               return_state=return_state)
    if isinstance(state0, BatchState):
        if backend == "kernel":
            raise ValueError(
                "state0 is a torch-driver BatchState; it cannot resume on "
                "backend='kernel'"
            )
        gb = _build_gram_routed(A, b, alpha1, alpha2, feature_major, key,
                                interpret, use_kernel=False)
        return fista_gram_batch(gb, cfg, state0=state0,
                                return_state=return_state)
    raise TypeError(
        f"state0 must be a FusedSolveState, ResidentSolveState, "
        f"VmemSolveState, or BatchState; got {type(state0).__name__}"
    )


# ---------------------------------------------------------------------------
# Stacked single-problem solves (the reference's vmapped ``solve_batch``)
# ---------------------------------------------------------------------------


def stack_problems(problems):
    """Stack structurally identical problems (dataclasses of tensors) into
    one problem of the same class whose tensors lead with the batch axis;
    the fields that are not tensors must agree and are kept."""
    first = problems[0]
    fields = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            fields[f.name] = torch.stack([getattr(p, f.name) for p in problems])
        elif any(getattr(p, f.name) != v for p in problems):
            raise ValueError(f"problems differ in their static field '{f.name}'")
    return dataclasses.replace(first, **fields)


def batch_lipschitz(problem_batch, generator: torch.Generator | None = None,
                    n_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """Per-problem Lipschitz constants of a stacked least-squares batch:
    the power iteration with each problem's own start vector (B rows drawn
    from ``generator``, by default one seeded with 0 on the batch's device)
    and its own stop, as ``jax.vmap(lipschitz_for)`` over split keys runs it;
    plus α₂ where the ridge term is in the smooth part."""
    from ..ops.lipschitz import _power_iteration

    if hasattr(problem_batch, "Q"):
        M = problem_batch.Q
        matvec = lambda v: (M @ v[..., None])[..., 0]
    else:
        M = problem_batch.A
        matvec = lambda v: (M.mT @ (M @ v[..., None]))[..., 0]
    B, n = M.shape[0], M.shape[-1]
    if generator is None:
        generator = torch.Generator(device=M.device).manual_seed(0)
    v0 = torch.randn((B, n), generator=generator, dtype=M.dtype,
                     device=generator.device).to(M.device)
    L = _power_iteration(matvec, v0, n_iter, tol)
    if getattr(problem_batch, "ridge_in_smooth", True):
        L = L + getattr(problem_batch, "alpha2", 0.0)
    return L


def solve_batch(problem_batch, method: str = "fista", config=None, history: bool = False,
                L=None, generator: torch.Generator | None = None):
    """Solve a stacked batch of problems in lockstep: each step of the
    single-problem solver runs under ``torch.func.vmap`` over the batch, the
    loop outside it, every problem frozen at its own stop, so each lane
    follows its own single solve.

    ``method`` ∈ {"fista", "ista", "lbfgs"}; ``config`` the matching config
    dataclass. ``L`` may give per-problem Lipschitz constants (lbfgs ignores
    it); without it they come from :func:`batch_lipschitz` with
    ``generator``. Returns a ``SolveResult`` whose tensors lead with the
    batch axis."""
    from ..solvers.common import Run
    from ..solvers.fista import FISTAConfig, _solve as fista_solve, init_state
    from ..solvers.ista import ISTAConfig, _solve as ista_solve, init_state as ista_init
    from ..solvers.lbfgs import LBFGSConfig, _solve as lbfgs_solve

    solvers = {"fista": FISTAConfig, "ista": ISTAConfig, "lbfgs": LBFGSConfig}
    if method not in solvers:
        raise ValueError(f"Unknown method '{method}' (want one of {list(solvers)})")
    if config is None:
        config = solvers[method]()
    run = Run(problem_batch, batched=True)
    if method == "lbfgs":
        return lbfgs_solve(run, config, None, history)
    x = run(lambda p: p.x0())
    if L is None:
        L = batch_lipschitz(problem_batch, generator)
    L = torch.as_tensor(L, dtype=x.dtype, device=x.device)
    tau0 = config.t_init_factor / L
    if method == "fista":
        return fista_solve(run, config, init_state(None, config, x, tau0), L, history)
    return ista_solve(run, config, ista_init(x, tau0), L, history)
