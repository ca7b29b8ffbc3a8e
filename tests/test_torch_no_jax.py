"""The port imports no jax, flax or optax and nothing of the JAX package,
not even indirectly.

tests/conftest.py imports jax, so the runtime check runs in a fresh
interpreter: it imports every module of ``mcncrossmodalemotions_torch``,
runs the tiny extraction slice, the tiny pipeline, one tiny train step, two
tiny ``run_distillation`` epochs and both probe tools on the CPU, loads a
classic-``.mat`` release, reads a JAX experiment directory (written here
by the JAX package), runs the student statistics and the external
benchmarks without figures, decodes face frames through the port's own
JPEG library, loads a classic-``.mat`` teacher and runs
``compute_visual_feats`` and ``build_imdb`` with it, trains tiny FER+
teachers with ``ferplus_baselines`` (scratch, and from a VGGFace2 base
``.mat``), evaluates and reloads them, reloads a JAX package teacher run
(written here by the JAX package), lists the artifact registry through
the CLI (``cli.main(["fetch"])``), runs ``verify_release`` over a tiny
classic-``.mat`` release tree, and then inspects
``sys.modules``: no jax, flax, optax or JAX package, and none of
``h5py``, ``matplotlib``, ``msgpack`` and ``PIL``, which the port imports
only to read ``-v7.3`` files, to draw, and to read frames where its own
decoder is switched off. The static checks parse the port's sources and
``chip_smoke.py``: no import statement names the JAX packages, and none
at module level names ``PIL`` (comments and docstrings may name them).
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcncrossmodalemotions_tpu")
LAZY = ("h5py", "matplotlib", "msgpack", "PIL")  # imported where used only

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(2)  # beside other test processes, a full pool spins

    import mcncrossmodalemotions_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)

    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats)
    from mcncrossmodalemotions_torch.zoo import (
        build_student, random_student_variables, student_state_dict_from_flax)

    v = random_student_variables(seed=0, fc6=64, fc7=32)
    with tempfile.TemporaryDirectory() as d:
        imdb = synthetic_track_imdb(Path(d), durations=(1.2,),
                                    tracks_per_class=1)
        logits = compute_audio_feats(
            imdb, build_student(tiny=True, with_frontend=False),
            student_state_dict_from_flax(v), batch_size=3, verbose=False,
            device="cpu")
    assert len(logits) == 6 and all(l.shape == (1, 8) for l in logits)
    pipe = build_student(tiny=True).eval()
    pipe.load_state_dict(student_state_dict_from_flax(
        {"params": {"net": v["params"]},
         "batch_stats": {"net": v["batch_stats"]}}))
    with torch.inference_mode():
        out = pipe(torch.randn(2, 16384, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (2, 8) and bool(torch.isfinite(out).all())

    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig, run_distillation)
    from mcncrossmodalemotions_torch.train.state import (
        TrainState, make_train_step)
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    gen = torch.Generator().manual_seed(0)
    state = TrainState.create(build_student(tiny=True), gen)
    step = make_train_step(student_loss_fn(), pass_pad_mask=True)
    batch = {"data": (torch.randn(2, 16384, generator=gen) * 3000).to(torch.int16),
             "logit_target": torch.randn(2, 8, generator=gen),
             "max_label": torch.tensor([1, 5], dtype=torch.int32),
             "pad_mask": torch.ones(2)}
    state, metrics = step(state, batch, 1e-3)
    assert bool(torch.isfinite(metrics["loss"]))
    with tempfile.TemporaryDirectory() as d:
        imdb = build_synthetic_imdb(Path(d) / "wav", num_speakers=2,
                                    tracks_per_speaker=3,
                                    duration_range=(1.2, 1.6))
        cfg = DistillationConfig(num_epochs=2, batch_size=2, num_seconds=1.0,
                                 tiny_model=True, mini_epoch_ratio=1.0,
                                 out_root=str(Path(d) / "exps"))
        _, history, _ = run_distillation(cfg, imdb, device="cpu")
    assert [h["epoch"] for h in history] == [1, 2]

    from mcncrossmodalemotions_torch.tools import (
        exit_code, probe_mosaic, probe_mosaic2)
    results = {**probe_mosaic.main(device="cpu"),
               **probe_mosaic2.main(device="cpu")}
    assert len(results) == 17 and exit_code(results) == 0, results

    import chip_smoke
    from mcncrossmodalemotions_torch.exp.emo_benchmarks import emo_benchmarks
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        load_student_from_exp)
    from mcncrossmodalemotions_torch.exp.sample_audio import sample_audio
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats
    from mcncrossmodalemotions_torch.exp.teacher_stats import teacher_stats
    from mcncrossmodalemotions_torch.zoo import load_pretrained_student

    with tempfile.TemporaryDirectory() as d:
        chip_smoke.student_release(Path(d) / "release.mat", fc6=64, fc7=32)
        model, state = load_pretrained_student(Path(d) / "release.mat",
                                               with_frontend=False, device="cpu")
        jmodel, jstate = load_student_from_exp(sys.argv[1], "best", device="cpu")
        assert sorted(jstate) == sorted(state)
        imdb = build_synthetic_imdb(Path(d) / "wav", num_speakers=3,
                                    tracks_per_speaker=2,
                                    duration_range=(1.1, 1.3))
        aucs = student_stats(imdb, model=model, state=state, verbose=False,
                             device="cpu")
        assert "meanAuc" in aucs["train"]
        tracks = synthetic_track_imdb(Path(d) / "ext", durations=(1.0,),
                                      tracks_per_class=3)
        logits = compute_audio_feats(tracks, model, state, verbose=False,
                                     device="cpu")
        res = emo_benchmarks({"rml": dict(track_logits=logits,
                                          labels=tracks.labels)}, num_folds=3)
        assert len(res["rml"].fold_accuracies) == 3
        assert teacher_stats(imdb)["emovoxceleb"].sum() > 0
        sample_audio(imdb, Path(d) / "samples", per_emotion=1,
                     make_figures=False)

    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.data.images import load_frame_batch
    from mcncrossmodalemotions_torch.data.imdb import TrackImdb
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        compute_visual_feats)
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb)
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    faces = sorted(chip_smoke.FACES.glob("*.jpg"))
    frames = load_frame_batch([str(f) for f in faces], 64)
    assert frames.shape == (len(faces), 64, 64, 1)
    with tempfile.TemporaryDirectory() as d:
        chip_smoke.teacher_release(Path(d) / "t.mat", stage_sizes=(1, 1),
                                   width=8)
        model, state = load_pretrained_teacher(
            Path(d) / "t.mat", with_pipeline=True, input_size=64,
            device="cpu")
        tracks = TrackImdb(track_ids=np.arange(2), labels=np.zeros(2),
                           set_id=np.ones(2),
                           frame_paths=[[f.name for f in faces[:5]],
                                        [f.name for f in faces[5:]]])
        feats = compute_visual_feats(tracks, model, state, batch_size=4,
                                     frame_root=str(chip_smoke.FACES),
                                     input_size=64, verbose=False,
                                     device="cpu")
        assert [f.shape for f in feats] == [(5, 8), (len(faces) - 5, 8)]
        wavs = build_synthetic_imdb(Path(d) / "w", num_speakers=2,
                                    tracks_per_speaker=2,
                                    duration_range=(1.1, 1.2))
        chip_smoke.dense_tree(Path(d) / "vox", [
            str(Path(wavs.wav_dir) / p) for p in wavs.wav_paths], 3)
        built = build_imdb(Path(d) / "vox", model, state, batch_size=4,
                           verbose=False, device="cpu")
        assert [w.shape for w in built.wav_logits] == [(3, 8)] * 4

    from mcncrossmodalemotions_torch.data.ferplus import (
        build_synthetic_ferplus)
    from mcncrossmodalemotions_torch.exp import ferplus_baselines as fb

    faces_imdb = build_synthetic_ferplus(40)
    with tempfile.TemporaryDirectory() as d:
        chip_smoke.teacher_release(Path(d) / "base.mat", stage_sizes=(1, 1),
                                   width=8)
        for model, mat in (("vgg-m-face-bn", None),
                           ("senet50_ft-dag", str(Path(d) / "base.mat"))):
            cfg = fb.FerPlusConfig(model=model, batch_size=8, input_size=48,
                                   tiny_model=True, lr_epochs=(1,),
                                   pretrained_mat=mat, out_root=d)
            _, history = fb.ferplus_baselines(cfg, faces_imdb, device="cpu")
            if mat is None:  # a base release's run reloads, no eval-only
                _, stats = fb.ferplus_baselines(cfg, faces_imdb,
                                                evaluate_only="val",
                                                use_best_epoch=True,
                                                device="cpu")
                assert stats["accuracy"] == 1 - history[0]["val"]["classerror"]
            pipe, state = fb.load_teacher_from_exp(Path(d) / cfg.exp_name(),
                                                   device="cpu")
    pipe, state = fb.load_teacher_from_exp(sys.argv[2], device="cpu")
    with torch.inference_mode():
        out = pipe(torch.zeros(2, 48, 48, 1, dtype=torch.uint8))
    assert out.shape == (2, 8) and bool(torch.isfinite(out).all())

    import os

    from mcncrossmodalemotions_torch import cli
    from mcncrossmodalemotions_torch.exp.verify_release import verify_release
    from mcncrossmodalemotions_torch.zoo.artifacts import artifact_path

    with tempfile.TemporaryDirectory() as d:
        os.environ["MCN_TPU_ARTIFACT_ROOT"] = d
        assert cli.main(["fetch"]) == 0
        chip_smoke.write_release_tree(
            Path(d), student=lambda p: chip_smoke.student_release(
                p, fc6=32, fc7=16),
            teacher=lambda p, use_se: chip_smoke.teacher_release(
                p, use_se=use_se, stage_sizes=(1, 1), width=8),
            imdb=built)
        report = verify_release(artifact_root=d, download=False,
                                probe_image_size=32, probe_wav_seconds=1.0,
                                out_root=str(Path(d) / "out"), verbose=False,
                                device="cpu")
        assert report["pass"] and report["executed"] == [
            "artifacts", "import_forward", "released_logits"], report

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN + LAZY)
    assert not leaked, leaked
    print("NO_JAX_OK")
""").replace("FORBIDDEN", repr(FORBIDDEN)).replace("LAZY", repr(LAZY))


@pytest.fixture
def jax_exp_dir(tmp_path):
    """A JAX experiment directory: run metadata and two msgpack
    checkpoints with their metrics, written by the JAX package."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_tpu.exp.run_distillation import DistillationConfig
    from mcncrossmodalemotions_tpu.train.checkpoints import save_checkpoint
    from mcncrossmodalemotions_tpu.train.state import TrainState
    from mcncrossmodalemotions_tpu.utils.config import write_run_meta
    from mcncrossmodalemotions_torch.zoo import random_student_variables

    cfg = DistillationConfig(tiny_model=True)
    exp_dir = tmp_path / cfg.exp_name()
    write_run_meta(exp_dir, cfg)
    for epoch in (1, 2):
        v = random_student_variables(seed=epoch, fc6=64, fc7=32)
        nested = {k: {"net": jax.tree.map(jnp.asarray, t)} for k, t in v.items()}
        save_checkpoint(exp_dir, epoch, TrainState.create(
            nested, jax.random.PRNGKey(0)), {"val": {"classerror": 1.0 / epoch}})
    return exp_dir


@pytest.fixture
def jax_teacher_exp_dir(tmp_path):
    """A JAX FER+ experiment directory: the run metadata of a tiny SENet
    run and a msgpack checkpoint of its pipeline, written by the JAX
    package."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_tpu.exp.ferplus_baselines import FerPlusConfig
    from mcncrossmodalemotions_tpu.train.checkpoints import save_checkpoint
    from mcncrossmodalemotions_tpu.train.state import TrainState
    from mcncrossmodalemotions_tpu.utils.config import write_run_meta
    from mcncrossmodalemotions_torch.zoo import random_teacher_variables

    cfg = FerPlusConfig(tiny_model=True, input_size=48, out_root=str(tmp_path))
    exp_dir = tmp_path / cfg.exp_name()
    write_run_meta(exp_dir, cfg)
    v = random_teacher_variables(seed=1, stage_sizes=(1, 1), width=8)
    nested = {k: {"teacher": jax.tree.map(jnp.asarray, t)}
              for k, t in v.items()}
    save_checkpoint(exp_dir, 1, TrainState.create(nested, jax.random.PRNGKey(0)),
                    {"val": {"classerror": 0.5}})
    return exp_dir


def test_torch_package_imports_no_jax(jax_exp_dir, jax_teacher_exp_dir):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(jax_exp_dir),
                           str(jax_teacher_exp_dir)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def _port_sources():
    return sorted((REPO / "mcncrossmodalemotions_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _module_level_imports(path: Path):
    """Modules imported by the statements at a module's top level (not
    inside a function or a class)."""
    for node in ast.parse(path.read_text(), str(path)).body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                break
            if isinstance(sub, ast.Import):
                yield from (a.name for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                yield sub.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_import_of_pil(path):
    bad = [m for m in _module_level_imports(path) if m.split(".")[0] == "PIL"]
    assert not bad, f"{path.name} imports {bad} at module level"
