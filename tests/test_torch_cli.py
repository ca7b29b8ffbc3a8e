"""The port's command line (``python -m mcncrossmodalemotions_torch.cli``)
against the JAX package's: the same 14 commands, the same configs from the
same argv, and the port's counterparts of the CLI tests of
``tests/test_config_and_splits.py``, each run with ``device=cpu`` on
synthetic inputs. The ``verify-release`` command's test is in
``tests/test_torch_verify_release.py``.

No test reaches the network: the artifact cache is the test's own and
``urllib.request.urlopen`` refuses any URL but ``file://``.
"""

import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from mcncrossmodalemotions_tpu import cli as jcli
from mcncrossmodalemotions_tpu.utils.config import to_dict as jto_dict
from mcncrossmodalemotions_torch import cli
from mcncrossmodalemotions_torch.utils.config import to_dict

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    real = urllib.request.urlopen

    def file_only(url, *args, **kwargs):
        if not str(getattr(url, "full_url", url)).startswith("file:"):
            raise urllib.error.URLError("the tests reach no network")
        return real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", file_only)
    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "cache"))
    torch.set_num_threads(2)


def test_cli_help_and_unknown(capsys):
    assert list(cli.COMMANDS) == list(jcli.COMMANDS)
    assert len(cli.COMMANDS) == 14
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "python -m mcncrossmodalemotions_torch.cli" in out
    assert f"commands: {', '.join(jcli.COMMANDS)}" in out
    assert cli.main(["nonsense"]) == 1
    assert cli.main([]) == 1


def test_module_help_lists_the_commands():
    proc = subprocess.run([sys.executable, "-m",
                           "mcncrossmodalemotions_torch.cli", "--help"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"commands: {', '.join(jcli.COMMANDS)}" in proc.stdout


def _captured(monkeypatch, module, name):
    """Replace ``module.name`` by a recorder of its first argument."""
    seen = []

    def record(cfg, *args, **kwargs):
        seen.append((cfg, args, kwargs))
        raise SystemExit(0)

    monkeypatch.setattr(module, name, record)
    return seen


DISTILL_ARGV = [
    ["num_epochs=10", "batch_size=32", "loss_type=hot-cross-ent"],
    ["tiny_model=true", "remat_policy=dots", "mulaw_feed=on",
     "temperature=1.5", "noise_dir=/noise", "noise_num=3"],
    ["from_scratch=false", "pretrained_student=emovoxceleb-student",
     "online_teacher=yes", "frames_per_crop=2", "lr_start_exp=-3"],
]
FERPLUS_ARGV = [
    ["tiny_model=true", "input_size=48", "dropout=0.0", "batch_size=8",
     "lr_values=[0.05]", "lr_epochs=[1]", "data.fer_csv=/a.csv"],
    ["use_bnorm=false", "data_type=clean", "pretrained_mat=/x.mat",
     "model=vgg-m-face-bn", "--eval-val"],
    ["use_bnorm=true", "augment=0", "num_classes=10", "data_type=full",
     "data.ferplus_csv=/b.csv", "--eval-test"],
]


@pytest.mark.parametrize("argv", DISTILL_ARGV)
def test_distill_argv_parses_as_jax(monkeypatch, argv):
    from mcncrossmodalemotions_tpu.exp import run_distillation as jrd
    from mcncrossmodalemotions_torch.exp import run_distillation as trd

    got = _captured(monkeypatch, trd, "run_distillation")
    want = _captured(monkeypatch, jrd, "run_distillation")
    for main, args in ((cli.main, ["distill", *argv, "device=cpu"]),
                       (jcli.main, ["distill", *argv])):
        with pytest.raises(SystemExit):
            main(args)
    assert to_dict(got[0][0]) == jto_dict(want[0][0])
    assert got[0][2] == {"device": "cpu"}


@pytest.mark.parametrize("argv", FERPLUS_ARGV)
def test_ferplus_argv_parses_as_jax(monkeypatch, argv):
    from mcncrossmodalemotions_tpu.data import ferplus as jferplus
    from mcncrossmodalemotions_tpu.exp import ferplus_baselines as jfb
    from mcncrossmodalemotions_torch.data import ferplus
    from mcncrossmodalemotions_torch.exp import ferplus_baselines as fb

    got = _captured(monkeypatch, fb, "ferplus_baselines")
    want = _captured(monkeypatch, jfb, "ferplus_baselines")
    csvs = []
    monkeypatch.setattr(ferplus, "parse_ferplus_csvs",
                        lambda *a: csvs.append(a) or "port imdb")
    monkeypatch.setattr(jferplus, "parse_ferplus_csvs",
                        lambda *a: csvs.append(a) or "jax imdb")
    for main, args in ((cli.main, ["ferplus", *argv, "device=cpu"]),
                       (jcli.main, ["ferplus", *argv])):
        with pytest.raises(SystemExit):
            main(args)
    assert to_dict(got[0][0]) == jto_dict(want[0][0])
    assert csvs[0] == csvs[1]
    assert got[0][1] == ("port imdb",) and want[0][1] == ("jax imdb",)
    assert got[0][2] == dict(want[0][2], device="cpu")


def test_cli_ferplus_with_csvs(tmp_path, monkeypatch):
    """The ferplus command end to end on synthetic csvs (dev mode)."""
    pix = " ".join(["120"] * (48 * 48))
    fer, plus = tmp_path / "fer2013.csv", tmp_path / "fer2013new.csv"
    rows_fer = ["emotion,pixels,Usage"]
    rows_plus = ["Usage,Image name,neutral,happiness,surprise,sadness,"
                 "anger,disgust,fear,contempt,unknown,NF"]
    for i in range(30):
        usage = ["Training", "PublicTest", "PrivateTest"][i % 3]
        rows_fer.append(f"0,{pix},{usage}")
        votes = ["0"] * 10
        votes[i % 4] = "8"
        rows_plus.append(f"{usage},fer{i:07d}.png," + ",".join(votes))
    fer.write_text("\n".join(rows_fer))
    plus.write_text("\n".join(rows_plus))
    monkeypatch.chdir(tmp_path)
    args = ["ferplus", f"data.fer_csv={fer}", f"data.ferplus_csv={plus}",
            "tiny_model=true", "input_size=48", "dropout=0.0", "batch_size=8",
            "lr_values=[0.05]", "lr_epochs=[1]", f"out_root={tmp_path}/exps",
            "device=cpu"]
    assert cli.main(args) == 0
    assert list(pathlib.Path(tmp_path, "exps").rglob("net-epoch-1.pt"))
    assert cli.main(args + ["--eval-val"]) == 0


def test_cli_distill_missing_data_errors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        cli.main(["distill", "num_epochs=1", "tiny_model=true",
                  f"data_root={tmp_path}/nonexistent", "device=cpu"])


def test_cli_distill_with_saved_imdb(tmp_path, monkeypatch):
    """The distill command end to end from a saved imdb npz (data_root),
    one the JAX package wrote."""
    from mcncrossmodalemotions_tpu.data.emovox import build_synthetic_imdb

    imdb = build_synthetic_imdb(tmp_path / "wavs", num_speakers=2,
                                tracks_per_speaker=3)
    data_root = tmp_path / "data"
    imdb.save(data_root / "emovoxceleb-imdb.npz")
    monkeypatch.chdir(tmp_path)
    assert cli.main([
        "distill", "num_epochs=1", "batch_size=2", "tiny_model=true",
        "mini_epoch_ratio=1.0", "mini_val=1.0",
        f"data_root={data_root}", f"out_root={tmp_path}/exps", "device=cpu",
    ]) == 0
    assert list(pathlib.Path(tmp_path, "exps").rglob("net-epoch-1.pt"))


def test_cli_fetch_lists_and_fails_cleanly(capsys):
    assert cli.main(["fetch"]) == 0
    out = capsys.readouterr().out
    assert "senet50-ferplus" in out and "vggface2" in out
    assert out.count("absent") == 10
    assert cli.main(["fetch", "no-such-artifact"]) == 1
    assert cli.main(["fetch", "afew-logits"]) == 1  # offline: a clean failure


def test_cli_fetch_resolves_a_placed_release(tmp_path, monkeypatch, capsys):
    from mcncrossmodalemotions_torch.zoo.artifacts import artifact_path

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    path = artifact_path("afew-logits")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"placed by hand")
    assert cli.main(["fetch", "afew-logits"]) == 0
    assert f"afew-logits: {path}" in capsys.readouterr().out
    assert path.with_suffix(".mat.sha256").exists()
    assert cli.main(["fetch"]) == 0
    assert capsys.readouterr().out.count("cached") == 1


def test_cli_analysis_commands_end_to_end(tmp_path, monkeypatch, capsys):
    """fetch-imdb, student-stats, teacher-stats and sample-audio over a
    saved synthetic manifest with the random-model null."""
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb

    imdb = build_synthetic_imdb(tmp_path / "wavs", num_speakers=2,
                                tracks_per_speaker=3)
    npz = tmp_path / "imdb.npz"
    imdb.save(npz)
    monkeypatch.chdir(tmp_path)

    assert cli.main(["fetch-imdb", f"cache={npz}", "device=cpu"]) == 0
    assert "6 wavs; sets" in capsys.readouterr().out
    assert cli.main(["fetch-imdb", "teacher=senet50-ferplus",
                     "chunk_frames=100"]) == 2
    assert "dense_chunked" in capsys.readouterr().out

    assert cli.main(["student-stats", f"imdb={npz}", "model=random",
                     f"cache={tmp_path / 'aucs.json'}",
                     f"fig_dir={tmp_path / 'figs'}", "vis_hist=true",
                     "device=cpu"]) == 0
    assert "meanAuc" in capsys.readouterr().out
    assert (tmp_path / "figs" / "student-pred-hist.jpg").exists()
    assert (tmp_path / "aucs.json").exists()

    assert cli.main(["teacher-stats", f"imdb={npz}",
                     f"fig={tmp_path / 'hist.pdf'}", "device=cpu"]) == 0
    assert "emovoxceleb" in capsys.readouterr().out
    assert (tmp_path / "hist.pdf").exists()

    assert cli.main(["sample-audio", f"imdb={npz}",
                     f"out={tmp_path / 'samples'}", "per_emotion=2",
                     "device=cpu"]) == 0
    assert list((tmp_path / "samples").rglob("meta.txt"))


def test_cli_external_benchmark_commands(tmp_path, monkeypatch, capsys):
    """audio-feats / visual-feats / emo-benchmarks on a synthetic dataset
    with the random-model null."""
    monkeypatch.chdir(tmp_path)
    root = tmp_path / "rml"
    assert cli.main(["audio-feats", "dataset=synthetic", f"root={root}",
                     "model=random", f"feats={tmp_path / 'feats.npz'}",
                     "device=cpu"]) == 0
    assert (tmp_path / "feats.npz").exists()
    assert cli.main(["emo-benchmarks", "dataset=synthetic", f"root={root}",
                     "modality=audio", "model=random",
                     f"feats={tmp_path / 'feats.npz'}", "num_folds=3",
                     f"fig_dir={tmp_path / 'figs'}",
                     f"exp_root={tmp_path / 'exps'}", "device=cpu"]) == 0
    assert "acc" in capsys.readouterr().out
    assert list((tmp_path / "figs").glob("*-confusion.pdf"))
    assert list((tmp_path / "exps").rglob("mnr-params*"))
    assert cli.main(["visual-feats", "dataset=synthetic", f"root={root}",
                     "model=random", f"feats={tmp_path / 'vfeats.npz'}",
                     "device=cpu"]) == 0
    assert (tmp_path / "vfeats.npz").exists()


def test_cli_audio_feats_from_a_release_equals_the_driver(tmp_path,
                                                           monkeypatch):
    """``audio-feats model=<.mat>`` gives compute_audio_feats' logits on
    the released weights, bit for bit."""
    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.data.imdb import float_tracks
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_student

    mat = tmp_path / "student.mat"
    chip_smoke.student_release(mat, fc6=64, fc7=32)
    root = tmp_path / "rml"
    monkeypatch.chdir(tmp_path)
    feats = tmp_path / "feats.npz"
    assert cli.main(["audio-feats", "dataset=synthetic", f"root={root}",
                     f"model={mat}", f"feats={feats}", "batch_size=8",
                     "device=cpu"]) == 0
    got = float_tracks(np.load(feats, allow_pickle=True)["logits"])
    model, state = load_pretrained_student(mat, with_frontend=False,
                                           device="cpu")
    want = compute_audio_feats(build_synthetic_track_imdb(root), model, state,
                               model_name=str(mat), batch_size=8,
                               verbose=False, device="cpu")
    assert len(got) == len(want) == 48
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_cli_refusals_and_the_card_default(tmp_path, capsys):
    assert cli.main(["bench"]) == 2
    assert "ROADMAP.md item 2" in capsys.readouterr().err
    assert cli.split_device(["a=1", "device=cpu", "b=2"]) == (
        "cpu", ["a=1", "b=2"])
    assert cli.split_device(["x=1"]) == ("cuda", ["x=1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["audio-feats", "dataset=synthetic",
                  f"root={tmp_path / 'rml'}", "model=emovoxceleb-student"])
