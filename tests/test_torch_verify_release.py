"""The port's verify-release battery (``exp/verify_release.py``) on the
synthetic stand-in releases of ``tests/test_verify_release.py``: the port's
counterparts of its 11 tests, on the CPU, and one test that holds the two
packages' reports to each other on five trees (good, wrong weights,
corrupt logits, a corrupt artifact, empty): the same verdict with the same
stages executed, failed and unverified, the ``import_forward`` numbers
within 1e-4 relative (both in fp32, JAX at its highest matmul precision),
and the ``released_logits`` counts and magnitudes bit for bit.

No test reaches the network: ``download=False`` everywhere, the cache in
the test's own directory, and ``urllib.request.urlopen`` refusing any URL
but ``file://``.
"""

import json
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.io
import torch

import chip_smoke
from mcncrossmodalemotions_torch.exp import verify_release as tvr
from mcncrossmodalemotions_torch.zoo.artifacts import (
    _file_sha256,
    artifact_path,
)
from mcncrossmodalemotions_torch.zoo.matconvnet import load_mat_params
from tests.test_matconvnet_import import _save_dagnn_mat
from tests.test_verify_release import _write_fer_csvs

PARITY_RTOL = 1e-4


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


def build_release_tree(root, rng):
    """Stand-ins for the released artifacts in the registry's layout
    (``<root>/<kind>/<filename>``), as ``tests/test_verify_release.py``
    writes them: a tiny student (fc6 32, fc7 16) and tiny teachers as
    classic ``.mat`` files (here from the port's seeded writers, with conv
    biases), and a released-logits imdb of three tracks."""
    chip_smoke.student_release(_fresh(artifact_path("emovoxceleb-student",
                                                    root=root)),
                               fc6=32, fc7=16)
    for name, use_se in (("resnet50-ferplus", False),
                         ("senet50-ferplus", True)):
        chip_smoke.teacher_release(_fresh(artifact_path(name, root=root)),
                                   use_se=use_se, stage_sizes=(1, 1),
                                   width=8)
    logits = [rng.randn(f, 8).astype(np.float32) * 3 for f in (4, 2, 5)]
    wav_logits = np.empty(len(logits), dtype=object)
    for i, l in enumerate(logits):
        wav_logits[i] = l
    images = {
        "name": np.asarray(["sp001/a.wav", "sp001/b.wav", "sp002/c.wav"],
                           dtype=object),
        "sp": np.asarray(["sp001", "sp001", "sp002"], dtype=object),
        "set": np.asarray([1, 1, 2], np.float64),
        "denseFrames": np.asarray([f"f{i}.jpg" for i in range(11)],
                                  dtype=object),
        "denseFramesWavIds": np.asarray([1] * 4 + [2] * 2 + [3] * 5,
                                        np.float64),
    }
    scipy.io.savemat(_fresh(artifact_path("emovoxceleb-logits", root=root)),
                     {"images": images, "wavLogits": wav_logits})


def _fresh(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


@pytest.fixture(scope="module")
def built_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("release") / "artifacts"
    build_release_tree(root, np.random.RandomState(7))
    return root


@pytest.fixture()
def release_tree(built_tree, tmp_path):
    """A fresh copy of the stand-in tree (no sidecars yet)."""
    root = tmp_path / "artifacts"
    shutil.copytree(built_tree, root)
    return root


def _run(release_root, tmp_path, **kw):
    kw.setdefault("artifact_root", str(release_root))
    kw.setdefault("download", False)
    kw.setdefault("probe_image_size", 32)
    kw.setdefault("probe_wav_seconds", 1.0)
    kw.setdefault("out_root", str(tmp_path / "out"))
    kw.setdefault("verbose", False)
    kw.setdefault("device", "cpu")
    return tvr.verify_release(**kw)


def _replace(path, write):
    path.unlink()
    path.with_suffix(path.suffix + ".sha256").unlink(missing_ok=True)
    write(path)


def _wrong_weights(root):
    """The JAX test's wrong-weights student: fc7 x 1e9 blows the cap."""
    path = artifact_path("emovoxceleb-student", root=root)
    mat = load_mat_params(path)
    mat["fc7f"] = mat["fc7f"] * 1e9
    _replace(path, lambda p: _save_dagnn_mat(p, mat, container="classic"))


def _nan_logits(root):
    lpath = artifact_path("emovoxceleb-logits", root=root)
    mat = scipy.io.loadmat(lpath, squeeze_me=False)
    bad = mat["wavLogits"].ravel()
    bad[1] = np.full_like(np.asarray(bad[1]), np.nan)
    _replace(lpath, lambda p: scipy.io.savemat(
        p, {"images": mat["images"], "wavLogits": bad}))


def _flip_logits_byte(root):
    lpath = artifact_path("emovoxceleb-logits", root=root)
    blob = bytearray(lpath.read_bytes())
    blob[len(blob) // 2] ^= 0xFF  # same size, other bytes
    lpath.write_bytes(bytes(blob))


def _row(report, stage, name):
    return next(r for r in report["stages"][stage]["rows"]
                if r["name"] == name)


# --- the port's counterparts of tests/test_verify_release.py ----------------

def test_verify_release_passes_on_good_tree(release_tree, tmp_path, capsys):
    report = _run(release_tree, tmp_path, verbose=True)
    assert report["pass"], report
    assert report["executed"] == ["artifacts", "import_forward",
                                  "released_logits"]
    assert report["stages"]["released_logits"]["tracks"] == 3
    assert report["stages"]["ferplus_accuracy"]["status"] == "skip"
    assert report["stages"]["container_agreement"]["status"] == "skip"
    saved = json.loads((tmp_path / "out" / "verify-release.json").read_text())
    assert saved["pass"] and saved["executed"] == report["executed"]
    for row in report["stages"]["artifacts"]["rows"]:
        assert row["sha256"] and len(row["sha256"]) == 64
    assert "verify-release: PASS" in capsys.readouterr().out


def test_verify_release_fails_on_wrong_weights(release_tree, tmp_path):
    _wrong_weights(release_tree)
    report = _run(release_tree, tmp_path)
    assert not report["pass"] and "import_forward" in report["failed"]
    row = _row(report, "import_forward", "emovoxceleb-student")
    assert row["status"] == "fail" and "exceeds" in row["error"]


def test_verify_release_fails_on_corrupt_logits_imdb(release_tree, tmp_path):
    _nan_logits(release_tree)
    report = _run(release_tree, tmp_path)
    assert not report["pass"] and "released_logits" in report["failed"]
    assert any("NaN" in p
               for p in report["stages"]["released_logits"]["problems"])


def test_verify_release_fails_on_corrupt_artifact(release_tree, tmp_path):
    assert _run(release_tree, tmp_path)["pass"]  # pins the sidecars
    _flip_logits_byte(release_tree)
    report = _run(release_tree, tmp_path)
    assert not report["pass"] and "artifacts" in report["failed"]
    assert _row(report, "artifacts", "emovoxceleb-logits")["status"] == \
        "corrupt"


def test_verify_release_container_agreement(release_tree, tmp_path):
    """A ``-v73`` sibling enables the stage: an identical re-save passes,
    one perturbed value fails it naming the parameter, and without the
    pair the stage skips."""
    path = artifact_path("emovoxceleb-student", root=release_tree)
    params = load_mat_params(path)
    alt = path.with_name(path.stem + "-v73" + path.suffix)
    _save_dagnn_mat(alt, params, container="v73")
    report = _run(release_tree, tmp_path)
    assert report["pass"], report
    stage = report["stages"]["container_agreement"]
    assert stage["status"] == "pass"
    assert [r["name"] for r in stage["rows"]] == ["emovoxceleb-student"]
    assert stage["rows"][0]["params"] == len(params)

    k = sorted(params)[0]
    bad = dict(params)
    bad[k] = np.asarray(bad[k]).copy()
    bad[k].flat[0] += 1e-3
    _save_dagnn_mat(alt, bad, container="v73")
    report = _run(release_tree, tmp_path)
    assert not report["pass"] and "container_agreement" in report["failed"]
    row = report["stages"]["container_agreement"]["rows"][0]
    assert row["status"] == "fail" and any(k in p for p in row["problems"])
    alt.unlink()
    report = _run(release_tree, tmp_path)
    assert report["pass"]
    assert report["stages"]["container_agreement"]["status"] == "skip"


def test_verify_release_sha_manifest(release_tree, tmp_path):
    report = _run(release_tree, tmp_path)
    pins = {r["name"]: r["sha256"]
            for r in report["stages"]["artifacts"]["rows"]}
    manifest = tmp_path / "pins.json"
    manifest.write_text(json.dumps(pins))
    report = _run(release_tree, tmp_path, sha_manifest=str(manifest))
    assert report["pass"], report
    assert all(r["manifest"] == "match"
               for r in report["stages"]["artifacts"]["rows"])
    pins["emovoxceleb-student"] = "0" * 64
    manifest.write_text(json.dumps(pins))
    report = _run(release_tree, tmp_path, sha_manifest=str(manifest))
    assert not report["pass"] and "artifacts" in report["failed"]
    row = _row(report, "artifacts", "emovoxceleb-student")
    assert row["status"] == "corrupt" and "manifest" in row["error"]


def test_verify_release_manifest_checked_without_sidecar(release_tree,
                                                         tmp_path):
    path = artifact_path("emovoxceleb-student", root=release_tree)
    manifest = tmp_path / "pins.json"
    for pin, passes in ((_file_sha256(path), True), ("0" * 64, False)):
        manifest.write_text(json.dumps({"emovoxceleb-student": pin}))
        for sidecar in release_tree.rglob("*.sha256"):
            sidecar.unlink()
        report = _run(release_tree, tmp_path, sha_manifest=str(manifest))
        assert report["pass"] is passes, report
    row = _row(report, "artifacts", "emovoxceleb-student")
    assert row["status"] == "corrupt" and "manifest" in row["error"]


def test_verify_release_empty_tree_does_not_pass(tmp_path):
    report = _run(tmp_path / "nothing-here", tmp_path)
    assert not report["pass"]
    assert report["executed"] == []
    assert sorted(report["unverified"]) == sorted(
        tvr.RELEASE_MODELS + ("emovoxceleb-logits",))


def test_verify_release_ferplus_gate(release_tree, tmp_path):
    """The accuracy gate end to end: random tiny weights miss the README
    table (FAIL) and hit their own measured numbers (PASS, from the
    benchmark's cache)."""
    fer_csv, ferplus_csv = _write_fer_csvs(tmp_path, np.random.RandomState(11))
    common = dict(fer_csv=fer_csv, ferplus_csv=ferplus_csv,
                  check_logits_imdb=False, models=("senet50-ferplus",),
                  ferplus_batch_size=8, ferplus_input_size=48)
    report = _run(release_tree, tmp_path, expected_accuracy={
        "senet50-ferplus": {"valAcc": 0.898, "testAcc": 0.888}}, **common)
    assert not report["pass"] and "ferplus_accuracy" in report["failed"]
    measured = report["stages"]["ferplus_accuracy"]["results"][
        "senet50-ferplus"]
    report = _run(release_tree, tmp_path,
                  expected_accuracy={"senet50-ferplus": dict(measured)},
                  **common)
    assert report["pass"], report["stages"]["ferplus_accuracy"]
    assert "ferplus_accuracy" in report["executed"]


def test_verify_release_ferplus_gate_runs_on_available_subset(release_tree,
                                                              tmp_path):
    rpath = artifact_path("resnet50-ferplus", root=release_tree)
    rpath.unlink()
    fer_csv, ferplus_csv = _write_fer_csvs(tmp_path, np.random.RandomState(13))
    report = _run(
        release_tree, tmp_path, fer_csv=fer_csv, ferplus_csv=ferplus_csv,
        check_logits_imdb=False,
        models=("senet50-ferplus", "resnet50-ferplus"),
        ferplus_batch_size=8, ferplus_input_size=48,
        expected_accuracy={
            "senet50-ferplus": {"valAcc": 0.898, "testAcc": 0.888},
            "resnet50-ferplus": {"valAcc": 0.879, "testAcc": 0.871}})
    stage = report["stages"]["ferplus_accuracy"]
    assert stage["status"] in ("pass", "fail")
    assert stage["skipped_models"] == ["resnet50-ferplus"]
    assert list(stage["results"]) == ["senet50-ferplus"]
    assert report["stages"]["artifacts"]["missing"] == ["resnet50-ferplus"]
    assert report["stages"]["artifacts"]["status"] == "pass"
    assert report["unverified"] == ["resnet50-ferplus"]
    assert not report["pass"]


def test_cli_verify_release(release_tree, tmp_path, capsys):
    from mcncrossmodalemotions_torch.cli import main

    args = ["verify-release", f"root={release_tree}", "download=false",
            "check_logits_imdb=true", "probe_image_size=32",
            "probe_wav_seconds=1.0", f"out_root={tmp_path / 'cli-out'}",
            "device=cpu"]
    assert main(args) == 0, capsys.readouterr().out
    assert "verify-release: PASS" in capsys.readouterr().out
    assert (tmp_path / "cli-out" / "verify-release.json").exists()
    _flip_logits_byte(release_tree)
    assert main(args) == 1
    assert "verify-release: FAIL" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        main(args[:-1])


# --- the two packages on the same trees -------------------------------------

def _fp32_loaders(monkeypatch):
    """Both packages' loaders in fp32 (bf16 is their default), JAX at its
    highest matmul precision: the models' logits then differ by rounding
    alone."""
    import jax.numpy as jnp

    from mcncrossmodalemotions_tpu import zoo as jzoo
    from mcncrossmodalemotions_tpu.ops.spectrogram import waveform_to_input
    from mcncrossmodalemotions_torch import zoo

    jstudent, jteacher = jzoo.load_pretrained_student, jzoo.load_pretrained_teacher

    class Fp32Pipeline:
        """The JAX pipeline's apply, its VGG-M in fp32."""

        def __init__(self, path):
            self.net, _ = jstudent(path, with_frontend=False, download=False)
            self.net = self.net.clone(dtype=jnp.float32)

        def apply(self, variables, wav):
            return self.net.apply({k: v["net"] for k, v in variables.items()},
                                  waveform_to_input(wav))

    def jax_student(path, with_frontend=True, **kw):
        _, variables = jstudent(path, with_frontend=True, **kw)
        return Fp32Pipeline(path), variables

    def jax_teacher(path, **kw):
        model, variables = jteacher(path, **kw)
        return model.clone(dtype=jnp.float32), variables

    tstudent, tteacher = zoo.load_pretrained_student, zoo.load_pretrained_teacher

    def port_student(*args, **kw):
        model, state = tstudent(*args, **kw)
        model.net.dtype = torch.float32
        return model, state

    def port_teacher(*args, **kw):
        model, state = tteacher(*args, **kw)
        model.dtype = torch.float32
        return model, state

    monkeypatch.setattr(jzoo, "load_pretrained_student", jax_student)
    monkeypatch.setattr(jzoo, "load_pretrained_teacher", jax_teacher)
    monkeypatch.setattr(zoo, "load_pretrained_student", port_student)
    monkeypatch.setattr(zoo, "load_pretrained_teacher", port_teacher)


TREES = {"good": None, "wrong-weights": _wrong_weights,
         "corrupt-logits": _nan_logits, "corrupt-artifact": _flip_logits_byte,
         "empty": "empty"}


@pytest.mark.parametrize("tree", list(TREES))
def test_both_packages_give_the_same_report(release_tree, tmp_path,
                                            monkeypatch, tree):
    import jax

    from mcncrossmodalemotions_tpu.exp.verify_release import (
        verify_release as jverify,
    )

    _fp32_loaders(monkeypatch)
    root = tmp_path / "nothing-here" if tree == "empty" else release_tree
    if tree == "corrupt-artifact":
        _run(root, tmp_path)  # pins the sidecars, then the byte flips
    if callable(TREES[tree]):
        TREES[tree](root)
    kw = dict(artifact_root=str(root), download=False, probe_image_size=32,
              probe_wav_seconds=1.0, verbose=False)
    with jax.default_matmul_precision("highest"):
        want = jverify(out_root=str(tmp_path / "jax"), **kw)
    got = tvr.verify_release(out_root=str(tmp_path / "port"), device="cpu",
                             **kw)
    for key in ("pass", "executed", "failed", "unverified", "skipped"):
        assert got[key] == want[key], (key, got[key], want[key])
    for stage in want["stages"]:
        assert got["stages"][stage]["status"] == \
            want["stages"][stage]["status"], stage
    assert got["pass"] is (tree == "good")
    rows = {r["name"]: r for r in want["stages"]["import_forward"]["rows"]}
    assert [r["name"] for r in got["stages"]["import_forward"]["rows"]] == \
        list(rows)
    for row in got["stages"]["import_forward"]["rows"]:
        ref = rows[row["name"]]
        assert row["status"] == ref["status"], (row, ref)
        for key in ("logit_std", "logit_absmax"):
            assert abs(row[key] - ref[key]) <= PARITY_RTOL * abs(ref[key]), \
                (row["name"], key, row[key], ref[key])
    glog, jlog = (r["stages"]["released_logits"] for r in (got, want))
    for key in ("tracks", "logit_absmax"):
        assert glog.get(key) == jlog.get(key), key
    assert glog.get("problems") == jlog.get("problems")
    if tree != "empty":
        assert len(rows) == 3
