"""ROC curve + AUC (vlfeat ``vl_roc`` equivalent, student_stats.m:114-117).

The port's copy of ``mcncrossmodalemotions_tpu/utils/roc.py`` (numpy;
``matplotlib`` only inside ``plot_roc``), held bitwise equal by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """ROC from +/-1 (or bool) labels and real scores.

    Returns (tpr, fpr, auc) with the vl_roc convention: curve traced in
    decreasing-score order, ties handled by trapezoidal integration.
    """
    labels = np.asarray(labels)
    pos = labels > 0
    neg = ~pos
    n_pos = int(pos.sum())
    n_neg = int(neg.sum())
    if n_pos == 0 or n_neg == 0:
        return np.array([0.0, 1.0]), np.array([0.0, 1.0]), float("nan")
    order = np.argsort(-np.asarray(scores), kind="stable")
    sorted_pos = pos[order].astype(np.float64)
    tp = np.concatenate([[0.0], np.cumsum(sorted_pos)])
    fp = np.concatenate([[0.0], np.cumsum(1.0 - sorted_pos)])
    tpr = tp / n_pos
    fpr = fp / n_neg
    auc = float(np.trapezoid(tpr, fpr))
    return tpr, fpr, auc


def auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    return roc_curve(labels, scores)[2]


def plot_roc(labels: np.ndarray, scores: np.ndarray, title: str,
             out_path: str) -> float:
    """Save a ROC figure (student_stats.m:105-125 jpg export equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tpr, fpr, auc = roc_curve(labels, scores)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(fpr, tpr, lw=2)
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.set_title(f"{title} (AUC {auc:.3f})")
    fig.tight_layout()
    from pathlib import Path

    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return auc
