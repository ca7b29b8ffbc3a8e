"""Qualitative audio sampling (``sample_audio.m`` equivalent).

For each well-represented emotion (ignoring disgust/contempt/fear,
sample_audio.m:39), finds tracks whose global max logit is that emotion
(:68-71), samples ``per_emotion`` of them with a seed-0 RNG (:75-89),
copies the wav (+ optional peak face frame), writes a meta.txt and a
per-sample logit bar chart (:102-198). The reference's interactive wipe
confirmation becomes an explicit ``overwrite`` flag.

The port's copy of ``mcncrossmodalemotions_tpu/exp/sample_audio.py``
(``matplotlib`` only inside the bar chart), held equal by
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb

SAMPLE_IGNORE = ("disgust", "contempt", "fear")  # sample_audio.m:39


def sample_audio(imdb: EmoVoxImdb, out_dir: str | Path,
                 per_emotion: int = 20, seed: int = 0,
                 emotions: Optional[Sequence[str]] = None,
                 copy_wavs: bool = True,
                 make_figures: bool = True,
                 sample_peaks: bool = True,
                 sample_frame_seq: bool = False,
                 overwrite: bool = False) -> dict:
    """Returns {emotion: [track indices sampled]}; writes sample packs.

    ``sample_peaks`` copies each sample's approximate peak frame (the
    reference's opts.samplePeaks default, sample_audio.m:36);
    ``sample_frame_seq`` additionally copies each sample's FULL sorted
    frame sequence as ``<stem>-frames/00001.jpg ...`` (the reference's
    opts.sampleFrameSeq, sample_audio.m:180-198).
    """
    out_dir = Path(out_dir)
    if out_dir.exists() and any(out_dir.iterdir()):
        if not overwrite:
            raise FileExistsError(
                f"{out_dir} is not empty; pass overwrite=True to wipe "
                "(the reference asked interactively, sample_audio.m:202-221)"
            )
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    from mcncrossmodalemotions_torch.exp.student_stats import teacher_labels

    labels = teacher_labels(imdb)  # one definition of the label convention
    targets = emotions or [e for e in EMOTIONS if e not in SAMPLE_IGNORE]
    rng = np.random.RandomState(seed)
    sampled = {}
    for emotion in targets:
        c = EMOTIONS.index(emotion)
        candidates = np.where(labels == c)[0]
        if len(candidates) == 0:
            sampled[emotion] = []
            continue
        pick = rng.permutation(candidates)[:per_emotion]
        sampled[emotion] = pick.tolist()
        emo_dir = out_dir / emotion
        emo_dir.mkdir(parents=True, exist_ok=True)
        meta_lines = []
        for rank, idx in enumerate(pick):
            rel = str(imdb.wav_paths[idx])
            stem = f"{rank:03d}-" + rel.replace("/", "_")
            if copy_wavs:
                src = Path(imdb.wav_dir) / rel
                if src.exists():
                    shutil.copy(src, emo_dir / stem)
            logits = imdb.wav_logits[idx]
            peak_frame = int(np.unravel_index(logits.argmax(), logits.shape)[0])
            # copy the peak face frame when dense frames are registered
            # (sample_audio.m copies wav + peak frame, :102-198)
            if imdb.dense_frames is not None and imdb.frame_dir:
                track_frames = imdb.dense_frames[idx]
                if len(track_frames):
                    fsrc = Path(imdb.frame_dir) / track_frames[
                        min(peak_frame, len(track_frames) - 1)]
                    if sample_peaks and fsrc.exists():
                        shutil.copy(fsrc, emo_dir / (stem + "-peak.jpg"))
                    if sample_frame_seq:
                        # full sequence copy (sample_audio.m:180-198)
                        seq_dir = emo_dir / (stem + "-frames")
                        seq_dir.mkdir(parents=True, exist_ok=True)
                        for kk, frel in enumerate(sorted(track_frames), 1):
                            fsrc = Path(imdb.frame_dir) / frel
                            if fsrc.exists():
                                shutil.copy(fsrc, seq_dir / f"{kk:05d}.jpg")
            meta_lines.append(
                f"{rank}\t{rel}\tspeaker={imdb.speaker[idx]}\t"
                f"peak_frame={peak_frame}\tmax_logit={logits.max():.3f}"
            )
            if make_figures:
                _logit_bar_chart(logits.max(axis=0),
                                 emo_dir / (stem + ".png"), emotion)
        (emo_dir / "meta.txt").write_text("\n".join(meta_lines) + "\n")
    return sampled


def _logit_bar_chart(logits: np.ndarray, out_path: Path, title: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 2.5))
    ax.bar(range(len(logits)), logits)
    ax.set_xticks(range(len(logits)), EMOTIONS[: len(logits)],
                  rotation=45, ha="right", fontsize=7)
    ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
