"""Drop-in compatibility layer with the reference's API surface (port of
``fastoptsolver_tpu/compat.py``).

A user of the reference (ElBaldo1/FastOptSolver) can ``from
fastoptsolver_tpu_torch.compat import fista, ista, fista_delta, LBFGSSolver,
prox_l1, prox_elastic_net, compute_objective, estimate_lipschitz,
generate_correlated_boston_like_data, reset_metrics, get_metrics`` and keep
their code: every function keeps the reference's signature, defaults,
history format and documented quirks, and returns NumPy.

Differences, all deliberate:

- The power-iteration start vector is seeded (``seed=``, default 0) instead
  of the reference's unseeded draw; the seed drives a ``torch.Generator``.
- The precision follows ``torch.get_default_dtype()`` (float32 unless the
  caller sets float64), the counterpart of the JAX package's reading of
  ``jax_enable_x64``.
- Every entry point takes ``device=`` last: NumPy inputs go there, or, when
  none is named, to the card (raising without one), as the package's other
  entry points do.
- ``ista``'s closures receive torch tensors on x₀'s device, where the JAX
  package hands them traced JAX arrays; what they return is taken as a
  tensor there.
- ``get_metrics`` reports call *counts* exactly; its times are the whole
  solve's wall time, the mean derived from it.
- ``LBFGSSolver`` is the package's L-BFGS (``solvers/lbfgs.py``), not
  SciPy's; final objectives match, trajectories do not.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .ops.lipschitz import estimate_lipschitz as _estimate_lipschitz
from .ops.objective import compute_objective as _compute_objective
from .ops.prox import prox_elastic_net as _prox_en, prox_l1 as _prox_l1
from .problems import CustomProblem, LeastSquares, fold_alphas
from .problems.base import as_tensor
from .problems.generators import generate_boston_like as generate_correlated_boston_like_data
from .solvers import FISTAConfig, ISTAConfig
from .solvers.fista import fista as _fista, fista_delta_config, fista_with_history as _fista_hist
from .solvers.ista import ista as _ista, ista_with_history as _ista_hist
from .solvers.lbfgs import LBFGSConfig, lbfgs_with_history as _lbfgs_hist

__all__ = [
    "C",
    "reset_metrics",
    "get_metrics",
    "estimate_lipschitz",
    "ista",
    "fista",
    "fista_delta",
    "LBFGSSolver",
    "prox_l1",
    "prox_elastic_net",
    "compute_objective",
    "generate_correlated_boston_like_data",
]

# Reference module constant (iterative_solvers.py:11).
C: float = 1e-2

# ---------------------------------------------------------------------------
# Metrics shim: the reference's reset/get interface over the solver counters.
# ---------------------------------------------------------------------------

_last_metrics: dict = {}


def reset_metrics() -> None:
    """Clear the recorded solver metrics."""
    _last_metrics.clear()


def _record(metrics, wall_s: float) -> None:
    n_grad = int(metrics.n_grad_evals)
    _last_metrics.update(
        grad_num_calls=n_grad,
        grad_time_total=wall_s,  # whole-solve wall time
        grad_time_mean=wall_s / n_grad if n_grad else 0.0,
        ls_num_calls=int(metrics.n_ls_calls),
        ls_time_total=0.0,
        ls_time_mean=0.0,
        ls_iters_total=int(metrics.ls_iters_total),
    )


def get_metrics():
    """Counters for the last solve; times are whole-solve wall clock."""
    return dict(_last_metrics) if _last_metrics else {
        "grad_num_calls": 0,
        "grad_time_total": 0.0,
        "grad_time_mean": 0.0,
        "ls_num_calls": 0,
        "ls_time_total": 0.0,
        "ls_time_mean": 0.0,
        "ls_iters_total": 0,
    }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _timed(solve):
    """``(result, x as NumPy, wall seconds)``: the clock stops once x is on
    the host, so a device solve is timed to its end."""
    t0 = time.perf_counter()
    res = solve()
    x = _np(res.x)
    return res, x, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Functional pieces
# ---------------------------------------------------------------------------


def prox_l1(v, tau, device=None):
    """Soft thresholding (reference prox_operators.py:3-8)."""
    return _np(_prox_l1(as_tensor(v, torch.get_default_dtype(), device), tau))


def prox_elastic_net(v, tau, alpha1, alpha2, device=None):
    """Elastic-net prox (reference prox_operators.py:10-16)."""
    return _np(_prox_en(as_tensor(v, torch.get_default_dtype(), device), tau, alpha1, alpha2))


def compute_objective(x, A, b, reg_type, alpha1, alpha2, device=None):
    """f(x) = g(x) + h(x) (reference objective_functions.py:3-30)."""
    dtype = torch.get_default_dtype()
    A = as_tensor(A, dtype, device)
    return float(_compute_objective(as_tensor(x, dtype, A.device), A,
                                    as_tensor(b, dtype, A.device), reg_type, alpha1, alpha2))


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def estimate_lipschitz(A, n_iter: int = 100, tol: float = 1e-6, seed: int = 0,
                       device=None) -> float:
    """λ_max(AᵀA) by power iteration (reference iterative_solvers.py:45-60),
    from a seeded start vector instead of the reference's unseeded draw."""
    A = as_tensor(A, torch.get_default_dtype(), device)
    return float(_estimate_lipschitz(A, _generator(seed, A.device), n_iter=n_iter, tol=tol))


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def ista(x0, g, grad_g, prox_h, L, backtracking: bool = False, eta: float = 0.5,
         t_init_factor: float = 1.0, max_iter: int = 500, tol: float = 0.0,
         return_history: bool = False, device=None):
    """Generic-callable ISTA (reference iterative_solvers.py:65-125).

    ``g``/``grad_g``/``prox_h`` are closures over torch tensors on x₀'s
    device; history is the reference's ``{"x", "t", "delta"}`` with ``x``
    including x₀."""
    reset_metrics()
    x0 = as_tensor(x0, torch.get_default_dtype(), device)
    keep = lambda v: torch.as_tensor(v, dtype=x0.dtype, device=x0.device)
    problem = CustomProblem(
        smooth_value_fn=lambda x: keep(g(x)),
        smooth_grad_fn=lambda x: keep(grad_g(x)),
        prox_fn=lambda v, tau: keep(prox_h(v, tau)),
        n_dim=int(x0.shape[0]),
    )
    cfg = ISTAConfig(backtracking=backtracking, eta=eta, t_init_factor=t_init_factor,
                     max_iter=max_iter, tol=tol)
    L_t = torch.as_tensor(L, dtype=x0.dtype, device=x0.device)
    if not return_history:
        res, x, wall = _timed(lambda: _ista(problem, cfg, x0=x0, L=L_t))
        _record(res.metrics, wall)
        return x
    res, x, wall = _timed(lambda: _ista_hist(problem, cfg, x0=x0, L=L_t))
    _record(res.metrics, wall)
    k = int(res.n_iters)
    xs = _np(res.history.x)[:k]
    log = {
        "x": [_np(x0)] + [xs[i] for i in range(k)],
        "t": [float(t_init_factor / L)] + [float(v) for v in _np(res.history.tau)[:k]],
        "delta": [float(v) for v in _np(res.history.step_norm)[:k]],
    }
    return x, log


def _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed, device):
    reset_metrics()
    problem = LeastSquares.create(A, b, reg_type, alpha1, alpha2,
                                  dtype=torch.get_default_dtype(), device=device)
    gen = _generator(seed, problem.A.device)
    solve = _fista_hist if return_history else _fista
    res, x, wall = _timed(lambda: solve(problem, cfg, generator=gen))
    _record(res.metrics, wall)
    return res, x


def _valid_rows(res):
    valid = _np(res.history.valid)
    return _np(res.history.x)[valid], _np(res.history.obj)[valid]


def fista(A, b, reg_type, alpha1, alpha2, backtracking: bool = False, eta: float = 0.5,
          t_init_factor: float = 1.0, max_iter: int = 500, tol: float = 0.0,
          tol_ratio: float = 0.0, adaptive_restart: bool = False,
          restart_threshold: float = 1.0, return_history: bool = False, seed: int = 0,
          device=None):
    """FISTA (reference iterative_solvers.py:132-245). History is the
    reference's ``{"x", "obj"}`` with ``x`` including x₀."""
    fold_alphas(reg_type, alpha1, alpha2)  # validate reg_type like the reference
    cfg = FISTAConfig(backtracking=backtracking, eta=eta, t_init_factor=t_init_factor,
                      max_iter=max_iter, tol=tol, tol_ratio=tol_ratio,
                      adaptive_restart=adaptive_restart,
                      restart_threshold=restart_threshold)
    res, x = _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed, device)
    if not return_history:
        return x
    xs, objs = _valid_rows(res)
    return x, {"x": [np.zeros(x.shape)] + [xi for xi in xs], "obj": [float(o) for o in objs]}


def fista_delta(A, b, reg_type, alpha1, alpha2, delta, backtracking: bool = False,
                eta: float = 0.5, t_init_factor: float = 1.0, max_iter: int = 500,
                tol: float = 0.0, tol_ratio: float = 0.0, return_history: bool = False,
                seed: int = 0, device=None):
    """FISTA-Δ with fixed momentum θ_k = k/(k+1+δ), δ > 2 enforced (reference
    iterative_solvers.py:251-344). History ``x`` does NOT include x₀
    (reference :279, unlike fista's :160)."""
    fold_alphas(reg_type, alpha1, alpha2)
    assert delta > 2, "In FISTA-Δ, delta must be > 2 for convergence"
    cfg = fista_delta_config(delta, backtracking=backtracking, eta=eta,
                             t_init_factor=t_init_factor, max_iter=max_iter, tol=tol,
                             tol_ratio=tol_ratio)
    res, x = _run_fista(A, b, reg_type, alpha1, alpha2, cfg, return_history, seed, device)
    if not return_history:
        return x
    xs, objs = _valid_rows(res)
    return x, {"x": [xi for xi in xs], "obj": [float(o) for o in objs]}


class LBFGSSolver:
    """sklearn-style L-BFGS driver (reference lbfgs.py:7-73) on the package's
    L-BFGS: the tiny-α elastic-net reclassification with ε (lbfgs.py:19-33);
    in lasso mode the *optimized* objective leaves out the L1 term while
    ``history_`` records the full objective (lbfgs.py:43-61)."""

    def __init__(self, reg_type, alpha1, alpha2, max_iter=500, tol=1e-6, eps=1e-8,
                 device=None):
        a1, a2, eff = fold_alphas(reg_type, alpha1, alpha2, eps=eps)
        self.reg_type = eff
        self.alpha1 = a1
        self.alpha2 = a2
        self.max_iter = max_iter
        self.tol = tol
        self.device = device
        self.history_ = []

    def fit(self, A, b):
        reset_metrics()
        problem = LeastSquares.create(A, b, self.reg_type, self.alpha1, self.alpha2,
                                      dtype=torch.get_default_dtype(), device=self.device)
        cfg = LBFGSConfig(max_iter=self.max_iter, tol=self.tol)
        res, self.x_, wall = _timed(lambda: _lbfgs_hist(problem, cfg))
        _record(res.metrics, wall)
        k = int(res.n_iters)
        self.history_ = [float(o) for o in _np(res.history.obj)[:k]]
        # the reference's final_obj_ is the minimized (smooth-only in lasso
        # mode) objective fmin_l_bfgs_b returns (lbfgs.py:72)
        self.final_obj_ = float(problem.smooth_value(res.x))
        return self
