"""External benchmark evaluation (``emo_benchmarks.m`` equivalent).

Per dataset (RML / eNTERFACE: 10-fold CV; AFEW: predefined val split with
the 381/383 adjustment factor, emo_benchmarks.m:56-73): evaluate the
per-fold multinomial remappings from run_cross_val, compute fold
accuracies via mnrval (:88-106), aggregate mean +/- std and a normalised
confusion matrix (:108-124), canonicalise label names (:129-144) and
render the confusion-matrix figure (:147-202).

Null baseline: model_name='random' features score ~1/6 on the six-class
benchmarks (:21-24) — exercised as a statistical sanity test.

The port's copy of ``mcncrossmodalemotions_tpu/exp/emo_benchmarks.py``
over the port's ``run_cross_val`` and ``utils/mnr.py`` (``matplotlib``
only inside ``plot_confusion``), held bitwise equal by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mcncrossmodalemotions_torch.exp.run_cross_val import (
    CrossValResult,
    run_cross_val,
)
from mcncrossmodalemotions_torch.utils.mnr import mnrval

AFEW_ADJUSTMENT = 381.0 / 383.0  # emo_benchmarks.m:69-72

# Canonical label names across datasets (canonicalLabels, :129-144)
_CANONICAL = {
    "angry": "anger", "anger": "anger",
    "happy": "happiness", "happiness": "happiness", "joy": "happiness",
    "sad": "sadness", "sadness": "sadness",
    "surprise": "surprise", "surprised": "surprise",
    "disgust": "disgust", "disgusted": "disgust",
    "fear": "fear", "fearful": "fear",
    "neutral": "neutral",
    "contempt": "contempt",
}


def canonical_labels(names: Sequence[str]) -> List[str]:
    return [_CANONICAL.get(n.lower(), n.lower()) for n in names]


@dataclasses.dataclass
class BenchmarkResult:
    dataset: str
    fold_accuracies: List[float]
    mean_accuracy: float
    std_accuracy: float
    confusion: np.ndarray  # [T, T] row-normalised
    classes: List[str]


def evaluate_cross_val(cv: CrossValResult, dataset: str = "",
                       classes: Sequence[str] = (),
                       adjustment: float = 1.0) -> BenchmarkResult:
    """Fold accuracies + confusion matrix from a CrossValResult."""
    t = cv.betas[0].shape[1] + 1
    fold_accs = []
    confusion = np.zeros((t, t), np.float64)
    for beta, val_idx in zip(cv.betas, cv.val_idx_sets):
        probs = mnrval(beta, cv.fused_logits[val_idx])
        pred = probs.argmax(axis=1)
        truth = cv.labels[val_idx]
        fold_accs.append(float((pred == truth).mean()) * adjustment)
        for yt, yp in zip(truth, pred):
            confusion[yt, yp] += 1
    row_sums = confusion.sum(axis=1, keepdims=True)
    confusion = confusion / np.maximum(row_sums, 1.0)
    return BenchmarkResult(
        dataset=dataset,
        fold_accuracies=fold_accs,
        mean_accuracy=float(np.mean(fold_accs)),
        std_accuracy=float(np.std(fold_accs)),
        confusion=confusion,
        classes=canonical_labels(classes) if classes else [],
    )


def emo_benchmarks(datasets: Dict[str, dict], num_folds: int = 10,
                   aggregator: str = "max", seed: int = 0,
                   fig_dir: Optional[str] = None,
                   exp_root: Optional[str] = None) -> Dict[str, BenchmarkResult]:
    """Evaluate a model's features on external benchmarks.

    ``datasets`` maps name -> dict(track_logits=list of [F,S] arrays,
    labels=[N] ints, classes=names, val_idx=optional predefined val set).
    AFEW-style entries with ``val_idx`` use the single predefined split
    and the 381/383 adjustment.
    """
    results = {}
    for name, spec in datasets.items():
        val_idx = spec.get("val_idx")
        cv = run_cross_val(
            spec["track_logits"], spec["labels"],
            num_folds=num_folds,
            aggregator=aggregator,
            existing_val_idx=val_idx,
            num_classes=len(spec.get("classes", ())) or None,
            seed=seed,
            exp_dir=str(Path(exp_root) / name) if exp_root else None,
        )
        adjustment = AFEW_ADJUSTMENT if (name.startswith("afew") and val_idx is not None) else 1.0
        result = evaluate_cross_val(cv, dataset=name,
                                    classes=spec.get("classes", ()),
                                    adjustment=adjustment)
        results[name] = result
        print(f"{name}: acc {result.mean_accuracy:.3f} +/- {result.std_accuracy:.3f}")
        if fig_dir:
            plot_confusion(result, str(Path(fig_dir) / f"{name}-confusion.pdf"))
    return results


def plot_confusion(result: BenchmarkResult, out_path: str) -> None:
    """Normalised confusion-matrix figure (generate_confmatrix_fig,
    emo_benchmarks.m:147-202)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = result.confusion.shape[0]
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(result.confusion, cmap="Blues", vmin=0, vmax=1)
    names = result.classes or [str(i) for i in range(t)]
    ax.set_xticks(range(t), names, rotation=45, ha="right")
    ax.set_yticks(range(t), names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(f"{result.dataset} (acc {result.mean_accuracy:.3f})")
    for i in range(t):
        for j in range(t):
            v = result.confusion[i, j]
            ax.text(j, i, f"{v:.2f}", ha="center", va="center",
                    color="white" if v > 0.5 else "black", fontsize=7)
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
