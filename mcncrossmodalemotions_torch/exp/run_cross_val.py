"""K-fold cross-validation engine (``run_cross_val.m`` equivalent).

Per dataset/modality: ensure per-track features are cached (:69-86),
build seed-0 k-fold splits (or use an existing val split, :92-109), and
per fold: aggregate per-frame logits per track by mean/max/peak
(:124-132, selectPeakLogit :149-155), fit a multinomial logistic
regression from pooled logits to target emotions (mnrfit, :140-144),
persist the fold's regression params. Returns the mini-imdb consumed by
emo_benchmarks.

The port's copy of ``mcncrossmodalemotions_tpu/exp/run_cross_val.py``
over the port's ``utils/mnr.py``, held bitwise equal by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from mcncrossmodalemotions_torch.utils.mnr import mnrfit


def select_peak_logit(track_logits: np.ndarray) -> np.ndarray:
    """'peak' aggregation: the single frame with the global max logit
    (selectPeakLogit, run_cross_val.m:149-155)."""
    f = np.unravel_index(np.argmax(track_logits), track_logits.shape)[0]
    return track_logits[f]


def aggregate_track(track_logits: np.ndarray, how: str = "max") -> np.ndarray:
    if how == "max":
        return track_logits.max(axis=0)
    if how in ("mean", "mean1"):  # 'mean1' = the reference's name (:126)
        return track_logits.mean(axis=0)
    if how == "peak":
        return select_peak_logit(track_logits)
    raise ValueError(f"unknown aggregator {how!r}")


def kfold_splits(n: int, num_folds: int, seed: int = 0) -> List[np.ndarray]:
    """Seed-0 k-fold val index sets (run_cross_val.m:55,97-109).

    Fold STRUCTURE matches the reference: one random permutation cut
    into contiguous chunks at ``round(linspace(0, n, k+1))`` boundaries
    (so fold sizes follow the same rounding pattern), not an interleaved
    split. The permutation itself cannot be bit-matched across RNGs
    (SURVEY.md section 7, RNG-pinned artifacts).
    """
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    splits = np.round(np.linspace(0, n, num_folds + 1)).astype(int)
    return [perm[splits[i]:splits[i + 1]] for i in range(num_folds)]


@dataclasses.dataclass
class CrossValResult:
    labels: np.ndarray            # [N] target-dataset labels
    fused_logits: np.ndarray      # [N, S] aggregated model logits
    val_idx_sets: List[np.ndarray]
    betas: List[np.ndarray]       # per-fold mnr params [S+1, T-1]


def run_cross_val(track_logits: Sequence[np.ndarray], labels: np.ndarray,
                  num_folds: int = 10,
                  aggregator: str = "max",
                  existing_val_idx: Optional[np.ndarray] = None,
                  num_classes: Optional[int] = None,
                  seed: int = 0,
                  exp_dir: Optional[str] = None) -> CrossValResult:
    """Fit per-fold mnr remappings from model logits to dataset labels.

    ``existing_val_idx`` replaces the k-fold split with a predefined val
    set (the AFEW path, run_cross_val.m:92-96); ``exp_dir`` persists each
    fold's params as ``mnr-params-fold<k>.npz`` (:140-144).
    """
    labels = np.asarray(labels)
    fused = np.stack([aggregate_track(t, aggregator) for t in track_logits])
    n = len(fused)
    if existing_val_idx is not None:
        val_sets = [np.asarray(existing_val_idx)]
    else:
        val_sets = kfold_splits(n, num_folds, seed)
    t = int(num_classes if num_classes is not None else labels.max() + 1)
    betas = []
    for fold, val_idx in enumerate(val_sets):
        train_mask = np.ones(n, bool)
        train_mask[val_idx] = False
        beta = mnrfit(fused[train_mask], labels[train_mask], num_classes=t)
        betas.append(beta)
        if exp_dir:
            path = Path(exp_dir) / f"mnr-params-fold{fold}.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, beta=beta, val_idx=val_idx)
    return CrossValResult(labels=labels, fused_logits=fused,
                          val_idx_sets=val_sets, betas=betas)
