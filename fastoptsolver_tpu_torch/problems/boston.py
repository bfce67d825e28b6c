"""The 506×13 Boston-housing configuration (port of
``fastoptsolver_tpu/problems/boston.py``; NumPy only, the same numbers).

BASELINE.json's first configuration names "Lasso on Boston housing
(506×13)". The real dataset does not ship with the repo (scikit-learn removed
it), so this module provides:

- :func:`load_boston_csv`: a loader for a user-supplied CSV of the original
  dataset (506 rows; the 13 feature columns and the MEDV target, by their
  classic names);
- :func:`synthetic_boston`: a labeled synthetic stand-in with the exact
  506×13 shape, the classic column names and realistic per-column scales and
  correlation, so every 506×13 configuration runs without the real data.

Both return NumPy float64; hand them to a problem's ``create`` or an
estimator's ``fit``.
"""
from __future__ import annotations

import numpy as np

COLUMNS = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT",
]
TARGET = "MEDV"
N_ROWS, N_FEATURES = 506, 13

# (mean, std, nonneg) per column — classic dataset summary statistics,
# used only by the synthetic stand-in.
_COLUMN_STATS = {
    "CRIM": (3.6, 8.6, True),
    "ZN": (11.4, 23.3, True),
    "INDUS": (11.1, 6.9, True),
    "CHAS": (0.07, 0.25, True),
    "NOX": (0.55, 0.12, True),
    "RM": (6.28, 0.70, True),
    "AGE": (68.6, 28.1, True),
    "DIS": (3.8, 2.1, True),
    "RAD": (9.5, 8.7, True),
    "TAX": (408.0, 168.5, True),
    "PTRATIO": (18.5, 2.2, True),
    "B": (356.7, 91.3, True),
    "LSTAT": (12.7, 7.1, True),
}


def load_boston_csv(path: str, standardize: bool = True):
    """Load the original dataset from a CSV with the classic columns
    (13 features + MEDV). Returns ``(A, b)`` float64 of shapes (506, 13),
    (506,)."""
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    missing = [c for c in COLUMNS + [TARGET] if c not in rows[0]]
    if missing:
        raise ValueError(f"{path}: missing columns {missing}")
    A = np.array([[float(r[c]) for c in COLUMNS] for r in rows])
    b = np.array([float(r[TARGET]) for r in rows])
    if standardize:
        A = (A - A.mean(0)) / A.std(0)
    return A, b


def synthetic_boston(seed: int = 0, noise_std: float = 3.0, standardize: bool = True):
    """SYNTHETIC 506×13 stand-in (shape/schema/scale-realistic, not the real
    data). Returns ``(A, b, x_true)``; ``b = A·x_true + noise`` with a sparse
    ground-truth coefficient vector so lasso recovery is meaningful."""
    rng = np.random.default_rng(seed)
    # latent low-rank structure induces realistic cross-feature correlation
    latent = rng.standard_normal((N_ROWS, 4))
    mix = rng.standard_normal((4, N_FEATURES)) * 0.7
    z = latent @ mix + rng.standard_normal((N_ROWS, N_FEATURES)) * 0.7
    A = np.empty((N_ROWS, N_FEATURES))
    for j, name in enumerate(COLUMNS):
        mean, std, nonneg = _COLUMN_STATS[name]
        col = mean + std * z[:, j]
        if name == "CHAS":
            col = (col > 0.25).astype(float)
        elif nonneg:
            col = np.maximum(col, 0.0)
        A[:, j] = col
    if standardize:
        A = (A - A.mean(0)) / np.where(A.std(0) > 0, A.std(0), 1.0)
    x_true = np.zeros(N_FEATURES)
    # sparse truth on a handful of the classically-predictive columns
    for name, w in [("RM", 4.0), ("LSTAT", -3.5), ("PTRATIO", -1.5), ("CRIM", -1.0)]:
        x_true[COLUMNS.index(name)] = w
    b = A @ x_true + noise_std * rng.standard_normal(N_ROWS)
    return A, b, x_true
