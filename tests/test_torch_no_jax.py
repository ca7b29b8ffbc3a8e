"""The port imports no jax, flax or optax and nothing of the JAX package,
not even indirectly.

tests/conftest.py imports jax, so the runtime check runs in a fresh
interpreter: it imports every module of ``mcncrossmodalemotions_torch``,
runs the tiny extraction slice, the tiny pipeline, one tiny train step, two
tiny ``run_distillation`` epochs and both probe tools on the CPU, loads a
classic-``.mat`` release, reads a JAX experiment directory (written here
by the JAX package), runs the student statistics and the external
benchmarks without figures, and then inspects ``sys.modules``: no jax,
flax, optax or JAX package, and none of ``h5py``, ``matplotlib`` and
``msgpack``, which the port imports only to read ``-v7.3`` files and to
draw. The static check parses the port's sources and ``chip_smoke.py``
and refuses any import statement that names those packages (comments and
docstrings may name them).
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcncrossmodalemotions_tpu")
LAZY = ("h5py", "matplotlib", "msgpack")  # imported only where they are used

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile
    from pathlib import Path

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


def test_torch_package_imports_no_jax(jax_exp_dir):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(jax_exp_dir)],
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
