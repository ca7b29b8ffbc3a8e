"""Full-scale convergence demo on the card (``tools/run_demo.py``'s recipe).

A synthetic EmoVoxCeleb-style imdb (8 speakers x 25 tracks, seed 0;
emotion-keyed tone and amplitude-rate cues, ``logit_gap`` 8 teacher
targets), the full-width VGG-M student, offline cached-logit
distillation (40 epochs, batch 16, lr ``logspace(-2, -3)``, every train
track an epoch and the whole validation set), then the student's whole-clip
logits (``compute_audio_feats``) and the heard/unheard ROC table
(``student_stats``). Writes ``<work>/demo_result.json``: the wall seconds,
the trajectory at epochs 1, 9, 17, 25, 33 and 40 (and the last epoch of a
shorter run) and the AUCs::

    python -m mcncrossmodalemotions_torch.tools.run_demo [WORK] [--epochs 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TRAJECTORY_EPOCHS = (1, 9, 17, 25, 33, 40)


def build_imdb(work, num_speakers: int = 8, tracks_per_speaker: int = 25):
    """The demo's synthetic imdb, its wavs written under ``<work>/wavs``."""
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb

    return build_synthetic_imdb(Path(work) / "wavs", num_speakers=num_speakers,
                                tracks_per_speaker=tracks_per_speaker, seed=0)


def main(work, device="cuda", num_epochs: int = 40, num_speakers: int = 8,
         tracks_per_speaker: int = 25, tiny: bool = False) -> dict:
    """Run the demo in ``work`` on ``device``; returns what it writes to
    ``demo_result.json``. ``tiny`` (the zoo's narrow student) and smaller
    counts are for a rehearsal on the CPU."""
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats

    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    imdb = build_imdb(work, num_speakers, tracks_per_speaker)
    print(f"imdb: {imdb.num_tracks} tracks built ({time.time() - t0:.0f}s)",
          flush=True)

    cfg = DistillationConfig(num_epochs=num_epochs, batch_size=16,
                             lr_start_exp=-2.0, lr_stop_exp=-3.0,
                             mini_epoch_ratio=1.0, mini_val=1.0,
                             tiny_model=tiny, out_root=str(work / "exps"))
    state, history, _ = run_distillation(cfg, imdb=imdb, device=device)
    wall = time.time() - t0
    print(f"train wall: {wall:.0f}s", flush=True)

    bare = state.model.net  # the student without its frontend
    logits = compute_audio_feats(imdb, bare, bare.state_dict(), verbose=False,
                                 device=device)
    stats = student_stats(imdb, student_logits=logits, verbose=False,
                          device=device)

    shown = set(TRAJECTORY_EPOCHS) | {num_epochs}
    out = {
        "wall_s": round(wall, 1),
        "trajectory": [
            {"epoch": h["epoch"],
             "train_loss": round(float(h["train"]["loss"]), 4),
             "train_err": round(float(h["train"]["classerror"]), 3),
             "val_err": round(float(h["val"]["classerror"]), 3)
             if "val" in h else None}
            for h in history if h["epoch"] in shown
        ],
        "aucs": {part: {k: (round(float(v), 3) if np.isscalar(v) else
                            {e: round(float(a), 2) for e, a in v.items()})
                        for k, v in d.items()}
                 for part, d in stats.items()},
    }
    print(json.dumps(out, indent=1), flush=True)
    (work / "demo_result.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", type=Path,
                    default=Path(tempfile.gettempdir()) / "demo_work")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.work, args.device, args.epochs)
    sys.exit(0)
