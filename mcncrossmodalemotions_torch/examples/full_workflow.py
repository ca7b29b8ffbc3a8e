"""Worked example: the complete cross-modal distillation workflow.

Port of ``examples/full_workflow.py``: the reference's five workloads end
to end on a synthetic mini-dataset (no downloads), through the port's
entry points, writing every artifact the paper pipeline writes:

0. a synthetic VoxCeleb tree: 3 speakers x 4 tone-coded 5 s wavs, 4 face
   frames of 48x48 a track (JPEGs by the port's own writer,
   ``data/images.save_synthetic_frame``);
1. the tiny FER+ teacher's dense inference over the frames ->
   ``emovoxceleb-imdb.npz`` (``fetch_emovoxceleb_imdb``; speaker 2 held
   out for validation);
2. student distillation (``run_distillation``: the tiny student, 20
   epochs, batch 4);
3. the student's whole-clip logits and the heard/unheard ROC table
   (``compute_audio_feats``, ``student_stats``);
4. the teacher's prediction histogram and the qualitative sample packs
   (``teacher_stats``, ``sample_audio``);
5. external benchmark cross-validation on a synthetic RML imdb
   (``emo_benchmarks``, 5 folds).

Tiny models and a short schedule, as the JAX example's own design: it
shows the workflow, not the paper's numbers (drop ``tiny_model`` and give
the imdb functions real data for those)::

    python -m mcncrossmodalemotions_torch.examples.full_workflow [WORK] [--device cpu]

It runs on the card unless asked for the CPU. Figures are drawn where
``matplotlib`` is installed (the card's host has none; every other
artifact is written all the same).
"""

from __future__ import annotations

import argparse
import importlib.util
import tempfile
from pathlib import Path

import numpy as np

SPEAKERS, TRACKS, FRAMES = 3, 4, 4
SECONDS = 5.0
# the JAX example's teacher variables, keys "params/teacher/conv1/kernel"...
TEACHER_VARIABLES = Path(__file__).with_name("tiny_teacher_jax.npz")


def write_voxceleb(vox: Path) -> None:
    """Stage 0: the synthetic VoxCeleb tree (``wavs/`` and ``frames/``)."""
    from mcncrossmodalemotions_torch.data.audio import write_wav
    from mcncrossmodalemotions_torch.data.images import save_synthetic_frame

    for s in range(SPEAKERS):
        for t in range(TRACKS):
            rel = f"spk{s}/t{t}"
            emotion = (s * TRACKS + t) % 4
            tt = np.arange(int(16000 * SECONDS)) / 16000
            wave = 0.4 * np.sin(2 * np.pi * (200 + 120 * emotion) * tt)
            write_wav(vox / "wavs" / (rel + ".wav"), wave.astype(np.float32),
                      16000)
            for k in range(FRAMES):
                save_synthetic_frame(vox / "frames" / rel / f"{k:02d}.jpg",
                                     emotion, size=48, seed=s * 10 + t + k)


def tiny_teacher():
    """The JAX example's teacher: the tiny FER+ pipeline at 48x48, no
    augmentation, with the variables of the JAX example's scratch init
    (``PRNGKey(0)``), which ``TEACHER_VARIABLES`` carries flattened."""
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        FerPlusConfig,
        build_pipeline,
    )
    from mcncrossmodalemotions_torch.zoo import teacher_state_dict_from_flax

    model = build_pipeline(FerPlusConfig(tiny_model=True, input_size=48,
                                         dropout=0.0, augment=False))
    variables: dict = {}
    with np.load(TEACHER_VARIABLES) as z:
        for key in z.files:
            *path, leaf = key.split("/")
            node = variables
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    model.load_state_dict(teacher_state_dict_from_flax(variables), strict=True)
    return model


def main(workdir=None, device="cuda") -> dict:
    """Run stages 0-5 in ``workdir`` (a new temporary directory if None) on
    ``device``, the teacher ``tiny_teacher()``'s; figures where
    ``matplotlib`` is installed. Returns each stage's result."""
    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.emo_benchmarks import emo_benchmarks
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        fetch_emovoxceleb_imdb,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.exp.sample_audio import sample_audio
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats
    from mcncrossmodalemotions_torch.exp.teacher_stats import teacher_stats
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    device = resolve_device(device, "the worked example")
    figures = importlib.util.find_spec("matplotlib") is not None
    root = Path(workdir or tempfile.mkdtemp(prefix="cme_workflow_"))
    fig_dir = str(root / "figs") if figures else None
    print(f"workdir: {root}; figures {'on' if figures else 'off'}")

    # stage 0: raw data on disk, wavs and face frames (VoxCeleb layout)
    vox = root / "voxceleb"
    write_voxceleb(vox)
    print("stage 0: synthetic VoxCeleb written")

    # stage 1: teacher + dense inference -> EmoVoxCeleb imdb (use a
    # FER+-trained teacher and the full-size models for the real pipeline)
    teacher = tiny_teacher()
    imdb = fetch_emovoxceleb_imdb(
        vox, teacher, teacher.state_dict(),
        cache_path=str(root / "emovoxceleb-imdb.npz"),
        set_assignment={"spk2": 2}, verbose=False, device=device)
    print(f"stage 1: imdb built — {imdb.num_tracks} tracks, "
          f"{sum(len(w) for w in imdb.wav_logits)} teacher-logit frames")

    # stage 2: student distillation. A tiny model and a short schedule:
    # enough for the synthetic tones to start separating; the AUC and
    # accuracy numbers below are demo-scale, not paper-scale
    dcfg = DistillationConfig(num_epochs=20, batch_size=4, tiny_model=True,
                              mini_epoch_ratio=1.0, mini_val=1.0,
                              lr_start_exp=-1.3, lr_stop_exp=-1.8,
                              out_root=str(root / "exps"))
    state, history, exp_dir = run_distillation(dcfg, imdb=imdb, device=device)
    print(f"stage 2: distilled {len(history)} epochs, "
          f"final loss {history[-1]['train']['loss']:.4f} -> {exp_dir}")

    # stage 3: student features + heard/unheard ROC (student_stats)
    bare = state.model.net  # the student without its frontend
    logits = compute_audio_feats(imdb, bare, bare.state_dict(),
                                 feat_path=str(root / "student-feats.npz"),
                                 verbose=False, device=device)
    aucs = student_stats(imdb, student_logits=logits, fig_dir=fig_dir,
                         cache_path=str(root / "aucs.json"), device=device)
    for part, values in aucs.items():
        print(f"stage 3: {part} meanAuc={values['meanAuc']:.3f}")

    # stage 4: analysis extras, the teacher histogram + qualitative samples
    hist = teacher_stats(imdb, fig_path=(str(root / "figs" / "teacher-hist.pdf")
                                         if figures else None))
    samples = sample_audio(imdb, root / "samples", per_emotion=2,
                           make_figures=figures, overwrite=True)
    print("stage 4: histogram + sample packs written")

    # stage 5: external benchmark cross-validation (emo_benchmarks)
    rml = build_synthetic_track_imdb(root / "rml", tracks_per_class=5)
    rml_logits = compute_audio_feats(rml, bare, bare.state_dict(),
                                     verbose=False, device=device)
    results = emo_benchmarks({
        "rml": dict(track_logits=rml_logits, labels=rml.labels,
                    classes=rml.classes),
    }, num_folds=5, fig_dir=fig_dir)
    print(f"stage 5: rml acc {results['rml'].mean_accuracy:.3f} "
          f"+/- {results['rml'].std_accuracy:.3f}")
    print(f"done; artifacts in {root}")
    return dict(root=root, imdb=imdb, history=history, exp_dir=exp_dir,
                logits=logits, aucs=aucs, teacher_hist=hist, samples=samples,
                rml=rml, rml_logits=rml_logits, results=results)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.workdir, args.device)
