"""Student heard/unheard ROC analysis (``student_stats.m`` equivalent).

Pipeline (student_stats.m): student logits over all EmoVoxCeleb tracks
(:54-58) -> softmax with temperature over the class axis (:95) ->
teacher label = argmax over emotions of the per-wav max over frames of
wavLogits (:97) -> per-partition {train=1, unheardVal=2, heardVal=3}
one-vs-all ROC/AUC per emotion (:79-81, :94, :104-125) -> mean AUC over
represented emotions excluding {fear, contempt, disgust} (:141-145),
results cached (:131-149).

The port's copy of ``mcncrossmodalemotions_tpu/exp/student_stats.py``,
pointed at the port's ``compute_audio_feats``: it takes the student as
``model`` and its ``state`` (a ``state_dict``) and extracts on ``device``,
the card unless the caller asks for the CPU, through the kernels unless
``use_kernels`` is False. From the same logits it returns bitwise the
original's AUCs (``tests/test_torch_analysis.py``); ``matplotlib`` is
imported only to draw figures.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb
from mcncrossmodalemotions_torch.exp.compute_audio_feats import compute_audio_feats
from mcncrossmodalemotions_torch.utils.roc import auc_score, plot_roc

IGNORE_EMOTIONS = ("fear", "contempt", "disgust")  # student_stats.m:141-145
PARTITIONS = {"train": 1, "unheardVal": 2, "heardVal": 3}


def softmax_np(x: np.ndarray, temperature: float = 1.0, axis: int = -1) -> np.ndarray:
    z = x / temperature
    z = z - z.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def teacher_labels(imdb: EmoVoxImdb) -> np.ndarray:
    """Per-wav dominant teacher emotion: argmax_emotion max_frame logits."""
    return np.asarray(
        [int(w.max(axis=0).argmax()) for w in imdb.wav_logits], np.int32
    )


def _prediction_histogram(labels: np.ndarray, title: str,
                          path: Path) -> None:
    """Dominant-prediction histogram figure (the visHist option,
    student_stats.m:66-70,99-102)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3))
    ax.hist(labels, bins=np.arange(len(EMOTIONS) + 1) - 0.5,
            rwidth=0.85)
    ax.set_xticks(range(len(EMOTIONS)))
    ax.set_xticklabels(EMOTIONS, rotation=45, ha="right", fontsize=7)
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def student_stats(imdb: EmoVoxImdb,
                  student_logits: Optional[List[np.ndarray]] = None,
                  model=None, state=None,
                  model_name: str = "emovoxceleb-student",
                  feat_path: Optional[str] = None,
                  temperature: float = 1.0,
                  fig_dir: Optional[str] = None,
                  cache_path: Optional[str] = None,
                  partition: str = "all",
                  ignore=IGNORE_EMOTIONS,
                  refresh: bool = False,
                  vis_hist: bool = False,
                  verbose: bool = True,
                  use_kernels: bool = True,
                  device: torch.device | str = "cuda"
                  ) -> Dict[str, Dict[str, float]]:
    """Per-partition per-emotion AUCs + meanAuc.

    Returns {partition: {emotion: auc, ..., 'meanAuc': float}}.
    Options mirror student_stats.m:39-49: ``partition`` restricts the
    analysis to one split; ``ignore`` names emotions excluded from
    meanAuc; ``refresh`` bypasses+rewrites the cache; ``vis_hist``
    writes dominant-prediction histograms (student overall + teacher
    per partition) into ``fig_dir``.

    The cache records the AUC-relevant options (partition, ignore) it
    was computed under and only answers calls with the SAME options — a
    cached single-partition result must not masquerade as the full
    analysis. A call that asks for figures (``fig_dir``) never answers
    from the cache: the reference renders its ROC jpgs / visHist
    histograms on every run regardless of the AUC cache
    (student_stats.m:99-125), and rendering needs the scores.

    Without ``student_logits`` the logits come from ``compute_audio_feats``
    with ``model`` (the bare ``VGGMStudent``) and ``state`` on ``device``.
    """
    if partition != "all" and partition not in PARTITIONS:
        raise KeyError(f"unknown partition {partition!r}; "
                       f"known: {['all'] + list(PARTITIONS)}")
    options = {"partition": partition, "ignore": sorted(ignore)}
    if cache_path and not fig_dir and Path(cache_path).exists() and not refresh:
        cached = json.loads(Path(cache_path).read_text())
        # Compare only the AUC-relevant keys so caches written by older
        # versions (which also recorded figure options) stay valid; a
        # cache with no __options__ at all predates single-partition
        # support and was computed under the defaults.
        cached_opts = cached.get("__options__",
                                 {"partition": "all",
                                  "ignore": sorted(IGNORE_EMOTIONS)})
        if {k: cached_opts.get(k) for k in options} == options:
            return {k: v for k, v in cached.items() if k != "__options__"}
    if student_logits is None:
        # Lazy: the dense inference only runs on an AUC-cache miss (the
        # reference likewise guards the expensive step behind its cache,
        # student_stats.m:54-58,131-149). model_name/feat_path forward
        # the 'random' null short-circuit and the feature cache.
        student_logits = compute_audio_feats(imdb, model=model, state=state,
                                             model_name=model_name,
                                             feat_path=feat_path,
                                             use_kernels=use_kernels,
                                             verbose=verbose, device=device)
    for i, l in enumerate(student_logits):
        # Student features are one [1, C] row per track (the reference's
        # max-pooled track logit, student_stats.m:95-97). Teacher-style
        # PER-FRAME features would silently score only frame 0 here —
        # reject them loudly; aggregate upstream (data.emovox
        # aggregate_logits) before calling.
        arr = np.asarray(l)
        # Two escapes the squeeze alone would miss: [T, 1] squeezes to 1-D
        # but reshape(1, -1) would fabricate T classes from one; require
        # the whole array to be exactly one row of last-axis classes.
        if arr.squeeze().ndim > 1 or arr.size != arr.shape[-1]:
            raise ValueError(
                f"student_logits[{i}] is shaped {np.shape(l)} — expected one "
                "track-level [1, C] row per track; per-frame (teacher-style) "
                "features must be aggregated over frames first")
    scores = np.concatenate([l.reshape(1, -1) for l in student_logits])  # [N, C]
    scores = softmax_np(scores, temperature=temperature, axis=1)
    labels = teacher_labels(imdb)
    num_classes = scores.shape[1]
    if vis_hist and fig_dir:
        _prediction_histogram(
            scores.argmax(axis=1), "dominant emotions (student)",
            Path(fig_dir) / "student-pred-hist.jpg")

    results: Dict[str, Dict[str, float]] = {}
    for part_name, set_id in PARTITIONS.items():
        if partition != "all" and part_name != partition:
            continue
        mask = imdb.set_id == set_id
        if not mask.any():
            continue
        if vis_hist and fig_dir:
            _prediction_histogram(
                labels[mask], f"dominant emotions (teacher, {part_name})",
                Path(fig_dir) / f"teacher-pred-hist-{part_name}.jpg")
        part_scores = scores[mask]
        part_labels = labels[mask]
        aucs: Dict[str, float] = {}
        for c in range(num_classes):
            emotion = EMOTIONS[c]
            binary = np.where(part_labels == c, 1, -1)
            if (binary > 0).sum() == 0 or (binary < 0).sum() == 0:
                continue  # emotion not represented in this partition
            if fig_dir and emotion not in ignore:
                # the reference computes AUC for every emotion but only
                # SAVES the ROC jpg for non-ignored ones
                # (student_stats.m:118-122 `if ~ismember(... ignore)`)
                auc = plot_roc(binary, part_scores[:, c],
                               f"{emotion} ({part_name})",
                               str(Path(fig_dir) / f"{emotion}-{part_name}.jpg"))
            else:
                auc = auc_score(binary, part_scores[:, c])
            aucs[emotion] = float(auc)
        scored = [v for k, v in aucs.items() if k not in ignore]
        aucs["meanAuc"] = float(np.mean(scored)) if scored else float("nan")
        results[part_name] = aucs
    if cache_path:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        Path(cache_path).write_text(
            json.dumps({**results, "__options__": options}, indent=2))
    return results
