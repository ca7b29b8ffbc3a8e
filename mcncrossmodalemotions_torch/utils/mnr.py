"""Multinomial logistic regression (``mnrfit``/``mnrval`` equivalents).

The reference fits a per-fold multinomial logistic regression mapping
S-dimensional pooled model logits to T target emotion classes via the
Statistics toolbox IRLS solver (run_cross_val.m:142, emo_benchmarks.m:94).
Here: deterministic full-Newton IRLS (double precision on the CPU
in numpy for the tiny solve — the problem is S<=8 features, so the
normal equations are a few hundred floats; no TPU involvement needed).

Parameterisation matches MATLAB ``mnrfit`` (nominal): T-1 sets of
coefficients with the LAST class as reference,
``eta_t = b0_t + x @ b_t`` for t < T, ``eta_T = 0``.

The port's copy of ``mcncrossmodalemotions_tpu/utils/mnr.py``, held
bitwise equal by ``tests/test_torch_analysis.py`` (and to
``tests/fixtures/mnr_golden.npz``).
"""

from __future__ import annotations

import numpy as np


def _design(x: np.ndarray) -> np.ndarray:
    return np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)


def _probs(xd: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """xd [N, D+1], beta [D+1, T-1] -> probabilities [N, T]."""
    eta = xd @ beta  # [N, T-1]
    eta = np.concatenate([eta, np.zeros((eta.shape[0], 1))], axis=1)
    eta -= eta.max(axis=1, keepdims=True)
    e = np.exp(eta)
    return e / e.sum(axis=1, keepdims=True)


def mnrfit(x: np.ndarray, y: np.ndarray, num_classes: int | None = None,
           max_iter: int = 100, tol: float = 1e-8,
           ridge: float = 1e-6) -> np.ndarray:
    """Fit nominal multinomial logistic regression by Newton-Raphson IRLS.

    ``x``: [N, D] features; ``y``: [N] int labels in [0, T). Returns
    beta [D+1, T-1] (intercept first, MATLAB layout). A tiny ridge term
    keeps the Hessian invertible on separable folds (MATLAB warns and
    returns large coefficients there; results match within tolerance on
    non-degenerate data).
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y)
    n, d = x.shape
    t = int(num_classes if num_classes is not None else y.max() + 1)
    xd = _design(x)
    k = t - 1
    beta = np.zeros((d + 1, k))
    onehot = np.eye(t)[y][:, :k]  # [N, T-1]
    for _ in range(max_iter):
        p = _probs(xd, beta)[:, :k]  # [N, T-1]
        grad = xd.T @ (onehot - p) - ridge * beta  # [D+1, T-1]
        # Full Hessian over flattened beta: block (a,b) = X^T W_ab X,
        # W_ab = diag(p_a (delta_ab - p_b)).
        dim = (d + 1) * k
        hess = np.zeros((dim, dim))
        for a in range(k):
            for b in range(k):
                w = p[:, a] * ((1.0 if a == b else 0.0) - p[:, b])
                block = xd.T @ (xd * w[:, None])
                hess[a * (d + 1):(a + 1) * (d + 1),
                     b * (d + 1):(b + 1) * (d + 1)] = -block
        hess -= ridge * np.eye(dim)
        step = np.linalg.solve(hess, -grad.T.reshape(-1))
        beta_new = beta + step.reshape(k, d + 1).T
        if np.max(np.abs(beta_new - beta)) < tol:
            beta = beta_new
            break
        beta = beta_new
    return beta


def mnrval(beta: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Class probabilities [N, T] for features [N, D] (mnrval equivalent)."""
    return _probs(_design(np.asarray(x, np.float64)), beta)
