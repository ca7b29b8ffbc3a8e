"""CLI entry points with dotted-path overrides (vl_argparse equivalent).

Every experiment driver of the port is reachable as::

    python -m mcncrossmodalemotions_torch.cli <command> [key=value ...] [device=cpu]

mirroring the reference's ``function(varargin)`` + ``vl_argparse``
pattern (run_distillation.m:71-90), including nested dotted paths. The
commands run on the card; ``device=cpu`` runs the plain versions on the
CPU. Examples::

    python -m mcncrossmodalemotions_torch.cli distill \\
        num_epochs=10 batch_size=32 loss_type=hot-cross-ent
    python -m mcncrossmodalemotions_torch.cli ferplus model=senet50-ferplus
    python -m mcncrossmodalemotions_torch.cli benchmark-ferplus
    python -m mcncrossmodalemotions_torch.cli student-stats \\
        imdb=emovox.npz cache=aucs.json fig_dir=figs vis_hist=true
    python -m mcncrossmodalemotions_torch.cli emo-benchmarks \\
        dataset=rml root=data/rml modality=audio feats=rml-audio.npz
    python -m mcncrossmodalemotions_torch.cli verify-release \\
        root=releases download=false

Every reference entry point (SURVEY §1 L6) has a command: distill
(run_distillation.m), ferplus (ferplus_baselines.m), benchmark-ferplus
(benchmark_ferplus_models.m), fetch-imdb (fetch_emovoxceleb_imdb.m),
student-stats, teacher-stats, sample-audio, audio-feats
(compute_audio_feats.m), visual-feats (compute_visual_feats.m), and
emo-benchmarks (emo_benchmarks.m, which drives run_cross_val.m — pass
exp_root= to persist its per-fold mnr params). fetch and verify-release
resolve and check the released artifacts; bench runs the port's
throughput bench (``mcncrossmodalemotions_torch/bench.py``).

On a host with several cards, ``torchrun --nproc_per_node=N -m
mcncrossmodalemotions_torch.cli <command> ...`` runs one rank a card: each
rank joins the process group (NCCL; gloo with ``device=cpu``) before the
command, and distill, ferplus, benchmark-ferplus, fetch-imdb and
visual-feats run data-parallel over it, rank 0 writing the outputs.
"""

from __future__ import annotations

import os
import sys

from mcncrossmodalemotions_torch.utils.config import (
    _coerce,
    parse_overrides,
    struct2str,
)


def _split_args(argv):
    overrides = [a for a in argv if "=" in a]
    flags = [a for a in argv if "=" not in a]
    return overrides, flags


def cmd_distill(argv, device="cuda"):
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )

    overrides, _ = _split_args(argv)
    cfg = parse_overrides(DistillationConfig(), *overrides)
    print(struct2str(cfg))
    _, history, exp_dir = run_distillation(cfg, device=device)
    print(f"done; exp dir: {exp_dir}")
    return 0


def _ferplus_csvs(opts: dict, prefix: str = "") -> tuple:
    return (opts.get(f"{prefix}fer_csv", "data/fer2013/fer2013.csv"),
            opts.get(f"{prefix}ferplus_csv", "data/fer2013/fer2013new.csv"))


def cmd_ferplus(argv, device="cuda"):
    from mcncrossmodalemotions_torch.data.ferplus import parse_ferplus_csvs
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        FerPlusConfig,
        ferplus_baselines,
    )

    overrides, flags = _split_args(argv)
    eval_only = None
    for flag in ("--eval-val", "--eval-test"):
        if flag in flags:
            eval_only = flag.rsplit("-", 1)[-1]
    cfg = parse_overrides(FerPlusConfig(), *[o for o in overrides
                                             if not o.startswith("data.")])
    data_overrides = dict(o.split("=", 1) for o in overrides
                          if o.startswith("data."))
    print(struct2str(cfg))
    imdb = parse_ferplus_csvs(*_ferplus_csvs(data_overrides, "data."))
    result = ferplus_baselines(cfg, imdb, evaluate_only=eval_only,
                               device=device)
    if eval_only:
        print(f"{eval_only} accuracy: {result[1]['accuracy']:.4f}")
    return 0


def cmd_benchmark_ferplus(argv, device="cuda"):
    from mcncrossmodalemotions_torch.data.ferplus import parse_ferplus_csvs
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        benchmark_ferplus_models,
    )

    opts, _ = _opt_dict(argv)
    imdb = parse_ferplus_csvs(*_ferplus_csvs(opts))
    benchmark_ferplus_models(imdb, out_root=opts.get("out_root", "exps"),
                             cache_dir=opts.get("cache_dir"), device=device)
    return 0


def cmd_bench(argv, device="cuda"):
    """The port's throughput bench (``mcncrossmodalemotions_torch/bench.py``,
    the JAX package's ``bench.py`` on the card): ``bench [--quick|--full]
    [--out-dir DIR]``; returns its exit code."""
    from mcncrossmodalemotions_torch import bench

    return bench.main(list(argv), device=device)


def cmd_reproduce_ferplus(argv, device="cuda"):
    """Released-weights FER+ regression vs the reference README table."""
    from mcncrossmodalemotions_torch.exp.reproduce_ferplus import main as rmain

    argv = list(argv)
    if "--device" not in argv:
        argv += ["--device", str(device)]
    return rmain(argv)


def _to_bool(value) -> bool:
    """One boolean-token table for the whole CLI: the config override
    coercer's, so ad-hoc options (download=, refresh=) accept exactly what
    config overrides (use_bnorm=) do."""
    return bool(_coerce(str(value).strip(), False))


def _opt_dict(argv):
    overrides, flags = _split_args(argv)
    return dict(o.split("=", 1) for o in overrides), flags


def _resolve_emovox_imdb(opts):
    """Resolve the ``imdb=`` source of the analysis commands.

    - ``imdb=<path>.npz`` — a saved :class:`EmoVoxImdb` manifest
    - ``imdb=<path>.mat`` — a released logits imdb (classic or -v7.3)
    - ``imdb=synthetic`` — the dev mini-imdb (built under ``root=``)
    - default — the load-or-build path of ``fetch_emovoxceleb_imdb``
      (honours ``root=``, ``cache=``, ``download=true``)
    """
    from pathlib import Path

    src = opts.get("imdb", "")
    root = opts.get("root", "data/emovoxceleb")
    if src.endswith(".npz"):
        from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb

        return EmoVoxImdb.load(src)
    if src.endswith(".mat"):
        from mcncrossmodalemotions_torch.data.imdb import emovox_imdb_from_mat

        return emovox_imdb_from_mat(
            src,
            wav_dir=opts.get("wav_dir", str(Path(root) / "wavs")),
            frame_dir=opts.get("frame_dir", str(Path(root) / "frames")))
    if src == "synthetic":
        from mcncrossmodalemotions_torch.data.emovox import (
            build_synthetic_imdb,
        )

        return build_synthetic_imdb(opts.get("root", "data/emovox-synthetic"))
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        fetch_emovoxceleb_imdb,
    )

    return fetch_emovoxceleb_imdb(
        root, cache_path=opts.get("cache"),
        download=_to_bool(opts.get("download", "false")))


def _epoch(opts):
    epoch = opts.get("epoch")
    return int(epoch) if epoch is not None and epoch != "best" else epoch


def _resolve_student(opts, device="cuda"):
    """Student source -> (bare_model, state_dict, model_name).

    - ``model=random`` — the null baseline (gaussian logits)
    - ``model=<name-or-.mat>`` — released weights via the zoo
    - ``checkpoint=<exp_dir>`` [``epoch=N|best``] — a trained
      run_distillation experiment of either package (the reference's
      dev-checkpoint eval flow, emoVoxZoo.m:46-63)
    """
    if "checkpoint" in opts:
        from mcncrossmodalemotions_torch.exp.run_distillation import (
            load_student_from_exp,
        )

        model, state = load_student_from_exp(opts["checkpoint"],
                                             epoch=_epoch(opts), device=device)
        return model, state, opts["checkpoint"]
    name = opts.get("model", "emovoxceleb-student")
    if name == "random":
        return None, None, "random"
    from mcncrossmodalemotions_torch.zoo import load_pretrained_student

    model, state = load_pretrained_student(name, with_frontend=False,
                                           device=device)
    return model, state, name


def _resolve_teacher(opts, device="cuda"):
    """Teacher source -> (pipeline_model, state_dict, model_name).

    Mirrors ``_resolve_student``: 'random' null, a registry name /
    released .mat, or ``checkpoint=<exp_dir>`` [``epoch=best|N``] for a
    trained ferplus_baselines run (load_teacher_from_exp)."""
    if "checkpoint" in opts:
        from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
            load_teacher_from_exp,
        )

        model, state = load_teacher_from_exp(opts["checkpoint"],
                                             epoch=_epoch(opts), device=device)
        return model, state, opts["checkpoint"]
    name = opts.get("model", "senet50-ferplus")
    if name == "random":
        return None, None, "random"
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    model, state = load_pretrained_teacher(name, with_pipeline=True,
                                           device=device)
    return model, state, name


def cmd_fetch_imdb(argv, device="cuda"):
    """fetch_emovoxceleb_imdb equivalent (fetch_emovoxceleb_imdb.m).

    Usage: fetch-imdb [root=data/emovoxceleb] [cache=imdb.npz]
                      [download=true] [teacher=senet50-ferplus] [limit=N]
                      [chunk_frames=N]
    Resolves the released logits imdb, or runs the dense teacher inference
    build when a teacher is given. chunk_frames=N (with teacher=) scores
    the frames in worker processes of at most N frames each over the
    partial checkpoint (exp/dense_chunked.py; the same imdb bit for bit):
    this process only loads the teacher on the host and supervises, and
    the workers run on device=.
    """
    import numpy as np

    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        fetch_emovoxceleb_imdb,
    )

    opts, _ = _opt_dict(argv)
    chunked = "chunk_frames" in opts
    if chunked and "teacher" not in opts:
        print("chunk_frames requires teacher=<name> (the dense build)")
        return 2
    teacher_model = teacher_state = None
    build_kwargs = {"device": device}
    if "teacher" in opts:
        from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

        teacher_model, teacher_state = load_pretrained_teacher(
            opts["teacher"], with_pipeline=True,
            device="cpu" if chunked else device)
    if chunked:
        build_kwargs["max_frames_per_process"] = int(opts["chunk_frames"])
        build_kwargs["teacher_spec"] = {"pretrained": opts["teacher"]}
    if "limit" in opts:
        build_kwargs["limit"] = int(opts["limit"])
    imdb = fetch_emovoxceleb_imdb(
        opts.get("root", "data/emovoxceleb"),
        teacher_model, teacher_state,
        cache_path=opts.get("cache"),
        download=_to_bool(opts.get("download", "false")),
        **build_kwargs)
    counts = {int(s): int((imdb.set_id == s).sum())
              for s in np.unique(imdb.set_id)}
    print(f"imdb: {imdb.num_tracks} wavs; sets {counts}")
    return 0


def cmd_student_stats(argv, device="cuda"):
    """student_stats.m equivalent: heard/unheard per-emotion ROC/AUC.

    Usage: student-stats imdb=<src> [model=emovoxceleb-student|random]
           [feats=logits.npz] [partition=all] [ignore=fear,contempt,disgust]
           [temperature=1] [fig_dir=figs] [vis_hist=true] [cache=aucs.json]
           [refresh=true]
    """
    from mcncrossmodalemotions_torch.exp.student_stats import (
        IGNORE_EMOTIONS,
        student_stats,
    )

    opts, _ = _opt_dict(argv)
    imdb = _resolve_emovox_imdb(opts)
    model, state, model_name = _resolve_student(opts, device)
    ignore = (tuple(opts["ignore"].split(",")) if "ignore" in opts
              else IGNORE_EMOTIONS)
    # no student_logits: the dense inference runs lazily inside
    # student_stats, so an AUC-cache hit skips it
    results = student_stats(
        imdb, model=model, state=state,
        model_name=model_name, feat_path=opts.get("feats"),
        temperature=float(opts.get("temperature", 1.0)),
        partition=opts.get("partition", "all"),
        ignore=ignore,
        fig_dir=opts.get("fig_dir"),
        vis_hist=_to_bool(opts.get("vis_hist", "false")),
        cache_path=opts.get("cache"),
        refresh=_to_bool(opts.get("refresh", "false")),
        device=device)
    for part, aucs in results.items():
        row = " ".join(f"{k}={v:.3f}" for k, v in sorted(aucs.items()))
        print(f"{part}: {row}")
    return 0


def cmd_teacher_stats(argv, device="cuda"):
    """teacher_stats.m equivalent: dominant-prediction histograms.

    Usage: teacher-stats imdb=<src> [fig=teacher-hist.pdf] [per=frame|wav]
           [download_afew=true]
    """
    from mcncrossmodalemotions_torch.exp.teacher_stats import teacher_stats

    opts, _ = _opt_dict(argv)
    imdb = _resolve_emovox_imdb(opts)
    hists = teacher_stats(
        imdb, fig_path=opts.get("fig"),
        per=opts.get("per", "frame"),
        download_afew=_to_bool(opts.get("download_afew", "false")))
    for name, hist in hists.items():
        print(f"{name}: {[int(v) for v in hist]}")
    return 0


def cmd_sample_audio(argv, device="cuda"):
    """sample_audio.m equivalent: qualitative per-emotion sample packs.

    Usage: sample-audio imdb=<src> out=<dir> [per_emotion=20] [seed=0]
           [sample_peaks=false] [frame_seq=true] [overwrite=true]
    """
    from mcncrossmodalemotions_torch.exp.sample_audio import sample_audio

    opts, _ = _opt_dict(argv)
    imdb = _resolve_emovox_imdb(opts)
    sampled = sample_audio(
        imdb, opts.get("out", "emovoxceleb-samples"),
        per_emotion=int(opts.get("per_emotion", 20)),
        seed=int(opts.get("seed", 0)),
        sample_peaks=_to_bool(opts.get("sample_peaks", "true")),
        sample_frame_seq=_to_bool(opts.get("frame_seq", "false")),
        overwrite=_to_bool(opts.get("overwrite", "false")))
    for emotion, picks in sampled.items():
        print(f"{emotion}: {len(picks)} samples")
    return 0


def _resolve_track_imdb(opts):
    """``dataset=`` -> TrackImdb: rml | enterface | afew | synthetic,
    rooted at ``root=`` (the mcnDatasets getters)."""
    from mcncrossmodalemotions_torch.data import external

    name = opts.get("dataset", "rml")
    root = opts.get("root", f"data/{name}")
    if name == "rml":
        return name, external.get_rml_imdb(root)
    if name == "enterface":
        return name, external.get_enterface_imdb(root)
    if name.startswith("afew"):
        return name, external.get_afew_imdb(
            root,
            subsample_stride=int(opts.get("subsample_stride", 1)))
    if name == "synthetic":
        return name, external.build_synthetic_track_imdb(root)
    raise KeyError(f"unknown dataset {name!r}; "
                   "known: rml, enterface, afew, synthetic")


def cmd_audio_feats(argv, device="cuda"):
    """compute_audio_feats.m equivalent: per-track student logits.

    Usage: audio-feats dataset=rml root=<dir> feats=<out.npz>
           [model=emovoxceleb-student|random] [batch_size=64] [limit=N]
           [clobber=0]
    (For the EmoVoxCeleb imdb itself pass imdb=<src> instead of dataset=.)
    """
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )

    opts, _ = _opt_dict(argv)
    if "imdb" in opts:
        name, imdb = "emovoxceleb", _resolve_emovox_imdb(opts)
    else:
        name, imdb = _resolve_track_imdb(opts)
    model, state, model_name = _resolve_student(opts, device)
    logits = compute_audio_feats(
        imdb, model=model, state=state, model_name=model_name,
        feat_path=opts.get("feats"),
        batch_size=int(opts.get("batch_size", 64)),
        limit=int(opts["limit"]) if "limit" in opts else None,
        clobber=_to_bool(opts.get("clobber", "0")), device=device)
    print(f"{name}: {len(logits)} tracks -> "
          f"{opts.get('feats') or '(not cached)'}")
    return 0


def cmd_visual_feats(argv, device="cuda"):
    """compute_visual_feats.m equivalent: per-track teacher logits.

    Usage: visual-feats dataset=afew root=<dir> feats=<out.npz>
           [model=senet50-ferplus|random] [checkpoint=<exp_dir>]
           [epoch=best|N] [frame_root=<dir>] [batch_size=128] [limit=N]
           [clobber=0]
    """
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        compute_visual_feats,
    )

    opts, _ = _opt_dict(argv)
    name, imdb = _resolve_track_imdb(opts)
    model, state, model_name = _resolve_teacher(opts, device)
    logits = compute_visual_feats(
        imdb, model=model, state=state, model_name=model_name,
        feat_path=opts.get("feats"),
        frame_root=opts.get("frame_root", ""),
        batch_size=int(opts.get("batch_size", 128)),
        limit=int(opts["limit"]) if "limit" in opts else None,
        clobber=_to_bool(opts.get("clobber", "0")), device=device)
    print(f"{name}: {len(logits)} tracks -> "
          f"{opts.get('feats') or '(not cached)'}")
    return 0


def cmd_emo_benchmarks(argv, device="cuda"):
    """emo_benchmarks.m equivalent: k-fold cross-validated accuracy on
    an external benchmark (run_cross_val + mnr remapping inside).

    Usage: emo-benchmarks dataset=rml root=<dir> [modality=audio|visual]
           [model=...|random] [feats=feats.npz] [clobber=0] [num_folds=10]
           [aggregator=max] [fig_dir=figs] [exp_root=exps]
    AFEW uses its predefined val split + the 381/383 adjustment.
    """
    import numpy as np

    from mcncrossmodalemotions_torch.exp.emo_benchmarks import emo_benchmarks

    opts, _ = _opt_dict(argv)
    name, imdb = _resolve_track_imdb(opts)
    modality = opts.get("modality", "audio")
    clobber = _to_bool(opts.get("clobber", "0"))
    if modality == "audio":
        from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
            compute_audio_feats,
        )

        model, state, model_name = _resolve_student(opts, device)
        logits = compute_audio_feats(imdb, model=model, state=state,
                                     model_name=model_name,
                                     feat_path=opts.get("feats"),
                                     clobber=clobber, device=device)
    elif modality == "visual":
        from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
            compute_visual_feats,
        )

        model, state, model_name = _resolve_teacher(opts, device)
        logits = compute_visual_feats(imdb, model=model, state=state,
                                      model_name=model_name,
                                      feat_path=opts.get("feats"),
                                      frame_root=opts.get("frame_root", ""),
                                      clobber=clobber, device=device)
    else:
        raise KeyError(f"modality must be audio|visual, got {modality!r}")
    spec = {"track_logits": logits, "labels": imdb.labels,
            "classes": list(imdb.classes)}
    if name.startswith("afew"):
        spec["val_idx"] = np.where(imdb.set_id == 2)[0]
    emo_benchmarks({name: spec},
                   num_folds=int(opts.get("num_folds", 10)),
                   aggregator=opts.get("aggregator", "max"),
                   seed=int(opts.get("seed", 0)),
                   fig_dir=opts.get("fig_dir"),
                   exp_root=opts.get("exp_root"))
    return 0


def cmd_fetch(argv, device="cuda"):
    """Resolve released artifacts by name (download on a miss).

    Usage: fetch [name ...]   — no names lists the registry.
    The reference's interactive y/n download prompts (emoVoxZoo.m:74-102)
    become an explicit command.
    """
    from mcncrossmodalemotions_torch.zoo.artifacts import (
        ARTIFACTS,
        artifact_path,
        fetch_artifact,
    )

    if not argv:
        for name, art in sorted(ARTIFACTS.items()):
            state = "cached" if artifact_path(name).exists() else "absent"
            print(f"{name:28s} [{art.kind}] {state:7s} {art.url}")
        return 0
    rc = 0
    for name in argv:
        try:
            print(f"{name}: {fetch_artifact(name)}")
        except Exception as exc:
            print(f"{name}: FAILED — {exc}", file=sys.stderr)
            rc = 1
    return rc


def cmd_verify_release(argv, device="cuda"):
    """Run the release-verification battery (exp/verify_release.py):
    artifact fetch/pin -> .mat import + probe forward -> released-logits
    structure -> FER+ accuracy vs the README table. Exit 0 iff PASS.

    Usage: verify-release [root=PATH] [download=false] [fer_csv=...]
           [ferplus_csv=...] [tolerance=0.005] [models=a,b,c]
           [check_logits_imdb=false] [sha_manifest=pins.json]
           [out_root=...]
    """
    from mcncrossmodalemotions_torch.exp.verify_release import (
        RELEASE_MODELS,
        verify_release,
    )

    opts, _ = _opt_dict(argv)
    kwargs = {"models": (tuple(opts["models"].split(",")) if "models" in opts
                         else RELEASE_MODELS)}
    for key, cast in (("tolerance", float), ("probe_image_size", int),
                      ("probe_wav_seconds", float),
                      ("ferplus_batch_size", int),
                      ("ferplus_input_size", int)):
        if key in opts:
            kwargs[key] = cast(opts[key])
    report = verify_release(
        artifact_root=opts.get("root"),
        download=_to_bool(opts.get("download", "true")),
        check_logits_imdb=_to_bool(opts.get("check_logits_imdb", "true")),
        fer_csv=opts.get("fer_csv"),
        ferplus_csv=opts.get("ferplus_csv"),
        sha_manifest=opts.get("sha_manifest"),
        out_root=opts.get("out_root", "exps/verify-release"),
        device=device, **kwargs)
    return 0 if report["pass"] else 1


COMMANDS = {
    "distill": cmd_distill,
    "ferplus": cmd_ferplus,
    "benchmark-ferplus": cmd_benchmark_ferplus,
    "reproduce-ferplus": cmd_reproduce_ferplus,
    "fetch-imdb": cmd_fetch_imdb,
    "student-stats": cmd_student_stats,
    "teacher-stats": cmd_teacher_stats,
    "sample-audio": cmd_sample_audio,
    "audio-feats": cmd_audio_feats,
    "visual-feats": cmd_visual_feats,
    "emo-benchmarks": cmd_emo_benchmarks,
    "bench": cmd_bench,
    "fetch": cmd_fetch,
    "verify-release": cmd_verify_release,
}


def split_device(argv) -> tuple:
    """``(device, argv without it)``: the ``device=`` option (default
    ``cuda``) comes out before any config parsing, so the remaining
    overrides parse as the JAX package's CLI parses them."""
    device, rest = "cuda", []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    device, rest = split_device(argv[1:])
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # one rank of a torchrun job: join the group, and the drivers'
        # mesh="auto" goes data-parallel over it
        from mcncrossmodalemotions_torch.parallel.mesh import (
            initialize_multihost,
        )

        initialize_multihost(backend="gloo" if device == "cpu" else None)
    return COMMANDS[argv[0]](rest, device)


if __name__ == "__main__":
    raise SystemExit(main())
