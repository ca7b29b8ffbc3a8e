"""Seed sweep of the port's convergence regression (``tools/sweep_convergence.py``).

Runs ``tests/test_torch_convergence.py``'s recipe (the JAX package's
``tests/test_full_workflow.py::test_distillation_convergence_regression``)
once per training seed, one seed after another, and prints one JSON line a
seed: the first and final epochs' train classerror, the final train loss
and the heard and unheard validation ``meanAuc``. The synthetic imdb stays at its seed 0; the seed
moves the scratch init, the batch order and the crops
(``DistillationConfig.seed``). On the CPU with torch at two threads, as
the test runs::

    python -m mcncrossmodalemotions_torch.tools.sweep_convergence 0 1 2 ... [--mulaw] --device cpu

Without ``--device`` it runs on the card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path


def run_seed(seed: int, work=None, mulaw: bool = False,
             device="cuda") -> dict:
    """The recipe at training seed ``seed`` on ``device`` (in ``work``,
    else a fresh temporary directory): 6 speakers x 8 tracks, the tiny
    student, 12 epochs of batch 8 over 2 s crops at lr 0.1 -> 0.03, then
    the student's AUCs. Returns the row, with the epochs' train losses and
    classerrors under ``history``."""
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats

    if work is None:
        with tempfile.TemporaryDirectory(prefix=f"convsweep{seed}-") as tmp:
            return run_seed(seed, tmp, mulaw, device)
    tmp = Path(work)
    imdb = build_synthetic_imdb(tmp / "wavs", num_speakers=6,
                                tracks_per_speaker=8, seed=0)
    cfg = DistillationConfig(num_epochs=12, batch_size=8, tiny_model=True,
                             num_seconds=2.0,
                             mini_epoch_ratio=1.0, mini_val=1.0,
                             lr_start_exp=-1.0, lr_stop_exp=-1.5,
                             seed=seed, mulaw_feed=mulaw,
                             out_root=str(tmp / "exps"))
    state, history, _ = run_distillation(cfg, imdb=imdb, device=device,
                                         mesh=None)
    bare = state.model.net
    logits = compute_audio_feats(imdb, bare, bare.state_dict(), verbose=False,
                                 device=device)
    stats = student_stats(imdb, student_logits=logits, verbose=False,
                          device=device)
    return {
        "seed": seed,
        "feed": "mulaw8" if mulaw else "int16",
        "first_classerror": round(
            float(history[0]["train"]["classerror"]), 4),
        "final_loss": round(float(history[-1]["train"]["loss"]), 4),
        "final_classerror": round(
            float(history[-1]["train"]["classerror"]), 4),
        "unheardVal_meanAuc": round(float(stats["unheardVal"]["meanAuc"]), 4),
        "heardVal_meanAuc": round(float(stats["heardVal"]["meanAuc"]), 4),
        "history": [(h["epoch"], float(h["train"]["loss"]),
                     float(h["train"]["classerror"])) for h in history],
    }


if __name__ == "__main__":
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", nargs="*", type=int, default=list(range(10)))
    ap.add_argument("--mulaw", action="store_true",
                    help="the mu-law uint8 feed (mulaw_feed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.set_num_threads(2)  # the test's count: the same arithmetic
    for s in args.seeds:
        row = run_seed(s, mulaw=args.mulaw, device=args.device)
        row.pop("history")
        print(json.dumps(row), flush=True)
