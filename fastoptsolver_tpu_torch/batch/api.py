"""The routed batched-lasso surface and the stacked single-problem solves
(port of ``fastoptsolver_tpu/batch/api.py``: ``_kernel_route``,
``solve_gram_batch``, ``solve_lasso_batch`` with its resume dispatch,
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
   (``gram_pairs`` alone, ``make_gram_batch_fused(..., pl_iters=0)``, at
   every width of the window; the reference's einsum precompute past
   n = 118) and one launch of the resident kernel
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
driver).

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, ``parallel.make_mesh``)
runs this routed surface on every rank of the mesh's ``mesh_axis`` over its
own lanes (``_solve_lasso_batch_sharded``); every rank calls it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.profiling import count, span
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
    if interpret:
        from ..kernels._build import refuse_interpret

        refuse_interpret(interpret, on_cuda)
        return None
    return None if on_cuda else "not a CUDA tensor (pass interpret=True to run the plain twins)"


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


def _state_engine(state0, backend: str, fused_ok: bool = True) -> str:
    """The engine ``state0`` pins by its type, named as :func:`_lasso_route`
    names it: ``"resident"`` for a ``ResidentSolveState``, ``"gram"`` (the
    burst or Q-streaming engine) for a ``VmemSolveState``, ``"fused"`` for a
    ``FusedSolveState`` unless not ``fused_ok`` (a Gram cannot resume the
    fused engine, which builds its own), ``"driver"`` for a ``BatchState``.
    Raises ``ValueError`` for the backend that engine cannot take and
    ``TypeError`` for any other state."""
    from ..kernels import FusedSolveState, ResidentSolveState, VmemSolveState

    engines = {ResidentSolveState: "resident", VmemSolveState: "gram",
               FusedSolveState: "fused", BatchState: "driver"}
    if not fused_ok:
        del engines[FusedSolveState]
    engine = next((e for cls, e in engines.items() if isinstance(state0, cls)), None)
    if engine is None:
        *names, last = (cls.__name__ for cls in engines)
        raise TypeError(f"state0 must be a {', '.join(names)} or {last}; got "
                        f"{type(state0).__name__}")
    if engine == "driver" and backend == "kernel":
        raise ValueError("state0 is a torch-driver BatchState; it cannot resume "
                         "on backend='kernel'")
    if engine != "driver" and backend == "xla":
        raise ValueError(f"state0 is a kernel-path {type(state0).__name__}; it "
                         "cannot resume on backend='xla' (the torch driver's "
                         "trajectory differs)")
    return engine


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
    from ..kernels.fista_vmem import fista_gram_vmem, plan_gram_solve
    from ..kernels.resident import fista_gram_resident

    if cfg is None:
        cfg = _default_cfg()
    on_cuda = gb.Q.is_cuda
    if state0 is not None:
        engine = _state_engine(state0, backend, fused_ok=False)
        if engine == "driver":
            return fista_gram_batch(gb, cfg, state0=state0,
                                    return_state=return_state)
        reason = _not_on_kernel_reason(interpret, on_cuda)
        if reason is not None:
            raise ValueError(f"state0 is a kernel-path {type(state0).__name__} "
                             f"but {reason}")
        if engine == "resident":
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
        return fista_gram_vmem(gb, cfg, interpret=interpret, state0=state0,
                               return_state=return_state)
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
    window on the kernel route, otherwise the torch precompute
    ``make_gram_batch`` with its power iteration started from ``key``;
    ``estimate_l=False`` skips the power iteration of either build (L = 1
    sentinel), for the resident engine's in-kernel estimate. The window
    follows the estimate: n ≤ 118 with the power steps, n ≤ 168 (the
    resident engine's) for ``gram_pairs`` alone."""
    with span("fos.gram_build"):
        n = A.shape[0] if feature_major else A.shape[-1]
        pl_iters = None if estimate_l else 0
        fused_build = False
        if use_kernel:
            from ..kernels.gram_build import _auto_tiles

            try:
                _auto_tiles(n, A.shape[1], pl_iters)
                fused_build = True
            except ValueError:
                fused_build = False
        if fused_build:
            from ..kernels.gram_build import make_gram_batch_fused

            A_fm, b_fm = _feature_major(A, b, feature_major)
            gb = make_gram_batch_fused(A_fm.contiguous(), b_fm.contiguous(),
                                       alpha1, alpha2, interpret=interpret,
                                       pl_iters=pl_iters)
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
    The port's ``gram_pairs`` builds it at every width of the window, where
    the reference builds past n = 118 with its einsum precompute."""
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
    engine whose state it is.

    ``mesh``: every rank of the mesh calls with the same arguments (the
    whole batch, or DTensors sharded on the instance axis over
    ``mesh_axis``, default ``"batch"``); each solves its lanes on the routed
    surface, and every rank gets the whole result (see
    :func:`_solve_lasso_batch_sharded`).

    Each call counts one in the ``calls`` counter and, while a profiler
    records, opens a ``fos.solve_lasso_batch`` span, the root of the call's
    spans (``utils.profiling``)."""
    count("calls")
    with span("fos.solve_lasso_batch"):
        return _solve_lasso_batch(A, b, alpha1, alpha2, cfg, backend, feature_major,
                                  key, interpret, state0, return_state, mesh,
                                  mesh_axis)


def _lasso_route(n: int, m: int, cfg, backend: str, interpret: bool,
                 on_cuda: bool) -> str:
    """The engine a fresh :func:`solve_lasso_batch` call takes: ``"fused"``,
    ``"resident"``, ``"gram"`` (the Gram build, then the burst or
    Q-streaming engine) or ``"driver"`` (the torch driver)."""
    use_kernel, _ = _kernel_route(n, cfg, backend, interpret, on_cuda)
    if not use_kernel:
        return "driver"
    from ..kernels.fused_solve import _fits

    if _fits(n, m, cfg):
        return "fused"
    from ..kernels.fista_vmem import plan_gram_solve

    return "resident" if plan_gram_solve(n, cfg)[0] == "resident" else "gram"


def _solve_lasso_batch(A, b, alpha1, alpha2, cfg, backend, feature_major, key,
                       interpret, state0, return_state, mesh, mesh_axis):
    if cfg is None:
        cfg = _default_cfg()
    if mesh is not None:  # mesh_axis alone is ignored, as the reference does
        return _solve_lasso_batch_sharded(A, b, alpha1, alpha2, cfg, backend,
                                          feature_major, key, interpret, mesh,
                                          mesh_axis, state0, return_state)
    n = A.shape[0] if feature_major else A.shape[-1]
    if state0 is not None:
        # the state's type pins the engine, whose own guards then decide: a
        # checkpoint on any other engine would change the trajectory. The
        # Gram is rebuilt from the same (A, b) by the same route, so only the
        # solver rows round-trip.
        route = _state_engine(state0, backend)
        if route != "driver":
            _kernel_route(n, cfg, "kernel", interpret, A.is_cuda)
    else:
        # route before building: a doomed backend='kernel' call must not
        # first spend the Gram build
        with span("fos.route"):
            route = _lasso_route(n, A.shape[1], cfg, backend, interpret, A.is_cuda)
    if route == "fused":
        from ..kernels.fused_solve import solve_lasso_fused

        A_fm, b_fm = _feature_major(A, b, feature_major)
        return solve_lasso_fused(A_fm.contiguous(), b_fm.contiguous(),
                                 alpha1, alpha2, cfg=cfg, interpret=interpret,
                                 state0=state0, return_state=return_state)
    if route == "resident":
        return _solve_resident_routed(A, b, alpha1, alpha2, cfg,
                                      feature_major, key, interpret,
                                      state0=state0, return_state=return_state)
    use_kernel = route == "gram"
    gb = _build_gram_routed(A, b, alpha1, alpha2, feature_major, key,
                            interpret, use_kernel)
    if use_kernel:
        from ..kernels.fista_vmem import fista_gram_vmem

        return fista_gram_vmem(gb, cfg, interpret=interpret, state0=state0,
                               return_state=return_state)
    return fista_gram_batch(gb, cfg, state0=state0, return_state=return_state)


def _mesh_state_engine(n: int, m: int, cfg, backend: str, interpret: bool,
                       on_cuda: bool) -> str:
    """The per-lane-k engine a mesh checkpoint/resume rides: the fused
    kernel first, the resident engine in the wide window; raises
    ``NotImplementedError`` (the reference's messages) for anything else."""
    from ..kernels.fista_vmem import plan_gram_solve
    from ..kernels.fused_solve import _fits

    if backend not in ("auto", "kernel"):
        # the mesh state path IS a per-lane-k kernel engine; refuse rather
        # than silently override the caller's forced driver
        raise NotImplementedError(
            f"mesh checkpoint/resume rides the per-lane-k kernel "
            f"engines; it cannot honor backend={backend!r} — drop the "
            "mesh or the backend forcing"
        )
    try:
        _kernel_route(n, cfg, "kernel", interpret, on_cuda)
        if _fits(n, m, cfg):
            return "fused"
        if plan_gram_solve(n, cfg)[0] != "resident":
            raise NotImplementedError(
                "this configuration lands on a scalar-k engine "
                "(the burst kernel, qstream, or the torch driver), "
                "whose host-sized burst schedule cannot differ per shard"
            )
        return "resident"
    except (ValueError, NotImplementedError) as e:
        raise NotImplementedError(
            "mesh-routed checkpoint/resume needs a per-lane-k engine "
            "(fused single-launch, or resident in the wide window); "
            f"this configuration cannot run one: {e}"
        ) from e


def _solve_lasso_batch_sharded(A, b, alpha1, alpha2, cfg, backend,
                               feature_major, key, interpret, mesh, mesh_axis,
                               state0=None, return_state=False):
    """Mesh-routed :func:`solve_lasso_batch`: the single-device routed
    surface runs on every rank of ``mesh[mesh_axis]`` over that rank's lanes.
    Each rank owns whole instances, so the solve needs no communication;
    the routing is the same on every rank.

    The batch is padded to a multiple of 128 lanes a rank
    (``parallel.lanes.LaneLayout``; padded lanes have A = b = 0 and certify
    at once) and the results are gathered to every rank as plain tensors.

    Checkpoint/resume over the mesh rides the per-lane-k engines (the fused
    kernel; the resident engine in the wide window), whose state is per lane,
    ``k`` included, so ranks evolve independently. The other engines carry
    one iteration counter that sizes a burst schedule on the host, and mesh
    state on them raises. A resumed ``state0`` is the whole state, as a
    returned one is; its ``k`` must be uniform within each rank's lane
    tiles, the port's groupings (``fused_solve.auto_tiles_fused``'s
    ``b_tile``; ``resident.kernel_group``, the resident engine's lanes a
    group on that device, where the reference's 128-lane
    ``auto_b_tile_resident`` tiles are its TPU grouping), else the
    checkpoint was cut under another grouping and the call raises
    ``ValueError``."""
    from ..kernels.fused_solve import FusedSolveState, solve_lasso_fused
    from ..kernels.resident import ResidentSolveState
    from ..parallel.lanes import LaneLayout
    from ..parallel.mesh import BATCH_AXIS, local

    axis = BATCH_AXIS if mesh_axis is None else mesh_axis
    lane_dim = -1 if feature_major else 0
    n = A.shape[0] if feature_major else A.shape[-1]
    m, B = A.shape[1], A.shape[lane_dim]
    lay = LaneLayout(mesh, axis, B, 128)
    on_cuda = local(A).is_cuda

    state_engine = None
    if state0 is not None or return_state:
        state_engine = _mesh_state_engine(n, m, cfg, backend, interpret, on_cuda)
        want = FusedSolveState if state_engine == "fused" else ResidentSolveState
        if state0 is not None and not isinstance(state0, want):
            raise NotImplementedError(
                f"mesh-routed resume for this configuration rides the "
                f"{state_engine} engine and carries {want.__name__}; "
                f"got {type(state0).__name__} — resume it per shard through "
                "the single-device surface"
            )

    A_blk, b_blk = lay.take(A, lane_dim), lay.take(b, lane_dim)
    if not feature_major:
        A_blk, b_blk = _feature_major(A_blk, b_blk, False)
    a1_blk, a2_blk = lay.take_vector(alpha1, A_blk), lay.take_vector(alpha2, A_blk)

    st = None
    if state0 is not None:
        from ..kernels._common import assert_tile_k_uniform
        from ..kernels.fused_solve import auto_tiles_fused
        from ..kernels.resident import kernel_group

        bt = (min(auto_tiles_fused(n, m)[0], lay.per_rank) if state_engine == "fused"
              else kernel_group(n, A_blk.device))
        k = torch.as_tensor(local(state0.k)).reshape(-1)
        for d in range(lay.size):
            # each rank's tiles, clamped to the rank's end and the batch's
            lo, hi = d * lay.per_rank, min((d + 1) * lay.per_rank, B)
            if hi > lo:
                try:
                    assert_tile_k_uniform(k, hi - lo, bt, offset=lo)
                except ValueError as e:
                    raise ValueError(f"{e} (mesh shard {d})") from None
        planes = lambda v, fill: lay.take(local(v).reshape(-1, B), -1, fill)
        vec = lambda v, fill: lay.take(local(v).reshape(-1), -1, fill)
        st = type(state0)(
            X=planes(state0.X, 0.0), Y=planes(state0.Y, 0.0), t=planes(state0.t, 1.0),
            ps=planes(state0.ps, 0.0), tau=planes(state0.tau, 1.0),
            # padded lanes repeat the rank's last real k: their tile stays uniform
            k=vec(state0.k, int(k[min(lay.lo + lay.per_rank, B) - 1])
                  if lay.lo < B else int(k[-1])),
            done=vec(state0.done, True), iters=vec(state0.iters, 0),
            gap=vec(state0.gap, 0.0))

    if state_engine == "fused":
        res, fin = solve_lasso_fused(A_blk, b_blk, a1_blk, a2_blk, cfg=cfg,
                                     interpret=interpret, state0=st, return_state=True)
    elif state_engine == "resident":
        res, fin = _solve_resident_routed(A_blk, b_blk, a1_blk, a2_blk, cfg, True,
                                          key, interpret, state0=st, return_state=True)
    else:
        res, fin = _solve_lasso_batch(A_blk, b_blk, a1_blk, a2_blk, cfg, backend, True,
                                      key, interpret, None, False, None, None), None
    failed = (res.failed if res.failed is not None
              else torch.zeros_like(res.converged))
    x, iters, gap, conv, failed = (lay.gather(v, 0) for v in (
        res.x, torch.as_tensor(res.iters), res.rel_gap, res.converged, failed))
    from .fista_gram import BatchResult

    result = BatchResult(x=x, iters=iters, rel_gap=gap, n_iters_total=torch.max(iters),
                         converged=conv, failed=failed)
    if fin is None:
        return result
    fin = type(fin)(*(lay.gather(v, -1) for v in fin))
    return (result, fin) if return_state else result


# ---------------------------------------------------------------------------
# Stacked single-problem solves (the reference's vmapped ``solve_batch``)
# ---------------------------------------------------------------------------


def stack_problems(problems):
    """Stack structurally identical problems (dataclasses of tensors) into
    one problem of the same class whose tensors lead with the batch axis;
    the fields that are not tensors must agree and are kept. Sparse tensors
    are refused: ``torch.func.vmap``, which runs the stack, takes none."""
    first = problems[0]
    fields = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor) and v.layout != torch.strided:
            raise ValueError(f"field '{f.name}' is a sparse tensor: a stacked solve runs "
                             "under torch.func.vmap, which takes no sparse tensor")
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
        return fista_solve(run, config, init_state(None, config, x, tau0, lead=1), L, history)
    return ista_solve(run, config, ista_init(x, tau0, lead=1), L, history)
