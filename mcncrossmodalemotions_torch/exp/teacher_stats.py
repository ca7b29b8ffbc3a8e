"""Teacher prediction histograms (``teacher_stats.m`` equivalent).

Computes the distribution of dominant teacher predictions over
EmoVoxCeleb (vs an optional comparison set, e.g. AFEW logits) and renders
the log-scale grouped bar figure (teacher_stats.m:47-84).

The port's copy of ``mcncrossmodalemotions_tpu/exp/teacher_stats.py``
without the released-artifact fetch: the comparison logits come from the
caller, or from a local ``afew-logits.mat`` at ``comparison_path``.
``h5py`` is imported only to read a ``-v7.3`` file (``utils/mat73.py``
tells the containers apart), ``matplotlib`` only to draw. Held equal by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb
from mcncrossmodalemotions_torch.utils import mat73


def frame_prediction_histogram(wav_logits: Sequence[np.ndarray],
                               num_classes: int = 8) -> np.ndarray:
    """Count of FRAMES whose argmax logit is each emotion.

    The reference's semantics: it concatenates every track's per-frame
    logits and histograms the per-row argmax
    (``vertcat(imdb.wavLogits{:})``, teacher_stats.m:28-29,40-42).
    """
    counts = np.zeros(num_classes, np.int64)
    for logits in wav_logits:
        preds = np.asarray(logits).argmax(axis=1)
        counts += np.bincount(preds, minlength=num_classes)[:num_classes]
    return counts


def dominant_prediction_histogram(wav_logits: Sequence[np.ndarray],
                                  num_classes: int = 8) -> np.ndarray:
    """Count of WAVS whose global max logit is each emotion (the teacher
    label convention of student_stats.m:97 — a per-track variant the
    reference's teacher_stats does not plot)."""
    counts = np.zeros(num_classes, np.int64)
    for logits in wav_logits:
        counts[int(logits.max(axis=0).argmax())] += 1
    return counts


def load_face_logits_mat(path) -> list:
    """Released per-track logit dump (afew-logits.mat 'faceLogits' cell,
    teacher_stats.m:39-42) -> list of [F, C] float32 arrays."""
    if mat73.is_hdf5(path):
        import h5py

        with h5py.File(str(path), "r") as f:
            refs = np.asarray(f["faceLogits"]).reshape(-1)
            return [np.atleast_2d(np.asarray(f[r], np.float32)).T
                    for r in refs]  # v7.3 stores column-major
    import scipy.io

    mat = scipy.io.loadmat(str(path), squeeze_me=True)
    fl = mat["faceLogits"]
    if isinstance(fl, np.ndarray) and fl.dtype != object:
        return [np.atleast_2d(np.asarray(fl, np.float32))]
    return [np.atleast_2d(np.asarray(l, np.float32))
            for l in np.atleast_1d(fl)]


def teacher_stats(imdb: EmoVoxImdb,
                  comparison_logits: Optional[Sequence[np.ndarray]] = None,
                  comparison_name: str = "AFEW 6.0",
                  fig_path: Optional[str] = None,
                  per: str = "frame",
                  comparison_path=None) -> Dict[str, np.ndarray]:
    """Histogram(s) of dominant teacher predictions + optional figure.

    ``per='frame'`` is the reference's semantics (argmax per frame row);
    ``per='wav'`` histograms per-track global maxima instead.
    ``comparison_path`` reads a local released afew-logits.mat
    (``load_face_logits_mat``) when no comparison_logits are passed; the
    reference fetched it (fetchLogitsFromInternet, teacher_stats.m:85-121),
    the port downloads nothing.
    """
    if per not in ("frame", "wav"):
        raise ValueError(f"per must be 'frame' or 'wav', got {per!r}")
    hist_fn = (frame_prediction_histogram if per == "frame"
               else dominant_prediction_histogram)
    if comparison_logits is None and comparison_path is not None:
        comparison_logits = load_face_logits_mat(comparison_path)
    hists = {"emovoxceleb": hist_fn(imdb.wav_logits)}
    if comparison_logits is not None:
        hists[comparison_name] = hist_fn(comparison_logits)
    if fig_path:
        plot_histogram(hists, fig_path)
    return hists


def plot_histogram(hists: Dict[str, np.ndarray], out_path: str) -> None:
    """Log-scale grouped bar chart -> PDF (plotHistogram, teacher_stats.m:47-84)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(hists)
    num_classes = len(next(iter(hists.values())))
    x = np.arange(num_classes)
    width = 0.8 / len(names)
    fig, ax = plt.subplots(figsize=(7, 4))
    for i, name in enumerate(names):
        ax.bar(x + i * width, np.maximum(hists[name], 0.5), width, label=name)
    ax.set_yscale("log")
    ax.set_xticks(x + width * (len(names) - 1) / 2,
                  EMOTIONS[:num_classes], rotation=30, ha="right")
    ax.set_ylabel("tracks (log scale)")
    ax.set_title("dominant teacher predictions")
    ax.legend()
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
