"""The port's release registry and released-logits reader against the JAX
package's: ``zoo/artifacts.py``, ``data/imdb.emovox_imdb_from_mat``,
``zoo/registry.resolve_release`` and the drivers that resolve through them
(``fetch_emovoxceleb_imdb(download=True)``,
``teacher_stats(download_afew=True)``, ``reproduce_ferplus`` without
``mats``).

No test reaches the network: every test runs with ``MCN_TPU_ARTIFACT_ROOT``
in its own temporary directory and ``urllib.request.urlopen`` refusing any
URL but ``file://``; the download branch is driven through ``file://``
URLs. The port's counterparts of every test of ``tests/test_artifacts.py``
come first, then the download branch, the sidecars both packages share,
and the drivers.
"""

import dataclasses
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import scipy.io

import chip_smoke
from mcncrossmodalemotions_torch.data.imdb import emovox_imdb_from_mat
from mcncrossmodalemotions_torch.zoo import artifacts
from mcncrossmodalemotions_torch.zoo.artifacts import (
    ARTIFACTS,
    ArtifactCorrupt,
    ArtifactUnavailable,
    artifact_path,
    ensure_artifact,
    fetch_artifact,
)
from mcncrossmodalemotions_tpu.data.imdb import (
    emovox_imdb_from_mat as jemovox_imdb_from_mat,
)
from mcncrossmodalemotions_tpu.zoo import artifacts as jartifacts
from tests.test_artifacts import (
    _FRAME_WAV_IDS,
    _FRAMES,
    _NAMES,
    _SETS,
    _SPEAKERS,
    _check_imported,
    _reference_logits,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """A cache of the test's own, and no URL but ``file://`` opens."""
    real = urllib.request.urlopen

    def file_only(url, *args, **kwargs):
        if not str(getattr(url, "full_url", url)).startswith("file:"):
            raise urllib.error.URLError("the tests reach no network")
        return real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", file_only)
    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "cache"))


def write_logits_mat(path, logits, container="classic", names=_NAMES,
                     speakers=_SPEAKERS, sets=_SETS, frames=_FRAMES,
                     frame_wav_ids=_FRAME_WAV_IDS):
    """A released-logits imdb in the reference schema: classic (scipy.io)
    or MATLAB -v7.3 (HDF5: uint16 codepoint strings, object references for
    cells, column-major numerics), as ``tests/test_artifacts.py`` writes
    them. ``frames=None`` leaves the dense frames out."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if container == "classic":
        images = {"name": np.asarray(names, dtype=object),
                  "sp": np.asarray(speakers, dtype=object),
                  "set": np.asarray(sets, np.float64)}
        if frames is not None:
            images["denseFrames"] = np.asarray(frames, dtype=object)
            images["denseFramesWavIds"] = np.asarray(frame_wav_ids,
                                                     np.float64)
        cells = np.empty(len(logits), dtype=object)
        for i, l in enumerate(logits):
            cells[i] = l
        scipy.io.savemat(path, {"images": images, "wavLogits": cells})
        return path
    import h5py

    ref = h5py.special_dtype(ref=h5py.Reference)
    with h5py.File(path, "w") as f:
        refs = f.create_group("#refs#")

        def str_cell(parent, name, strings):
            cell = parent.create_dataset(name, shape=(len(strings), 1),
                                         dtype=ref)
            for i, s in enumerate(strings):
                cell[i, 0] = refs.create_dataset(
                    f"{name}_{i}",
                    data=np.asarray([[ord(c)] for c in s], np.uint16)).ref

        images = f.create_group("images")
        str_cell(images, "name", names)
        str_cell(images, "sp", speakers)
        images.create_dataset("set", data=np.asarray(sets, np.float64)
                              .reshape(1, -1))
        if frames is not None:
            str_cell(images, "denseFrames", frames)
            images.create_dataset(
                "denseFramesWavIds",
                data=np.asarray(frame_wav_ids, np.float64).reshape(1, -1))
        cell = f.create_dataset("wavLogits", shape=(len(logits), 1),
                                dtype=ref)
        for i, l in enumerate(logits):
            cell[i, 0] = refs.create_dataset(f"logits_{i}", data=l.T).ref
    return path


def assert_same_imdb(a, b):
    """Two EmoVoxImdbs bit for bit: every field, every dtype."""
    for key in ("wav_paths", "speaker", "set_id"):
        x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert len(a.wav_logits) == len(b.wav_logits)
    for x, y in zip(a.wav_logits, b.wav_logits):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32))
    assert (a.dense_frames is None) == (b.dense_frames is None)
    for x, y in zip(a.dense_frames or (), b.dense_frames or ()):
        assert x.dtype == y.dtype and list(x) == list(y)
    assert (a.wav_dir, a.frame_dir, tuple(a.classes)) == (
        b.wav_dir, b.frame_dir, tuple(b.classes))


# --- the port's counterparts of tests/test_artifacts.py ---------------------

def test_registry_equals_jax_and_covers_reference_urls():
    """The same 10 names, URLs, files and kinds as the JAX registry, on
    the reference's URL scheme (emoVoxZoo.m:74-102,
    fetch_emovoxceleb_imdb.m:288-324, teacher_stats.m:85-121)."""
    assert len(ARTIFACTS) == 10
    assert {k: dataclasses.astuple(v) for k, v in ARTIFACTS.items()} == {
        k: dataclasses.astuple(v) for k, v in jartifacts.ARTIFACTS.items()}
    for name, tail in (
            ("emovoxceleb-student", "models/emovoxceleb/emovoxceleb-student.mat"),
            ("senet50-ferplus", "models/ferplus/senet50-ferplus.mat"),
            ("resnet50-ferplus", "models/ferplus/resnet50-ferplus.mat"),
            ("voxceleb-imdb", "cross-modal-emotions/voxceleb-imdb.mat"),
            ("emovoxceleb-logits",
             "cross-modal-emotions/senet50-ferplus-logits.mat"),
            ("afew-logits", "cross-modal-emotions/afew-logits.mat")):
        assert ARTIFACTS[name].url.endswith(tail)
    for name in ARTIFACTS:
        assert artifact_path(name, "/r") == jartifacts.artifact_path(name, "/r")


def test_offline_miss_raises_with_instructions(tmp_path):
    with pytest.raises(ArtifactUnavailable) as exc:
        fetch_artifact("senet50-ferplus", root=tmp_path, download=False)
    msg = str(exc.value)
    assert "robots.ox.ac.uk" in msg and "senet50-ferplus" in msg
    assert str(artifact_path("senet50-ferplus", tmp_path)) in msg


def test_ensure_artifact_graceful_none(tmp_path):
    assert ensure_artifact("afew-logits", root=tmp_path,
                           download=False) is None


def test_cache_hit_pins_and_detects_corruption(tmp_path):
    path = artifact_path("senet50-ferplus", root=tmp_path)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"fake release contents")
    assert fetch_artifact("senet50-ferplus", root=tmp_path,
                          download=False) == path
    sidecar = path.with_suffix(path.suffix + ".sha256")
    assert sidecar.read_text() == (f"{artifacts._file_sha256(path)} "
                                   f"{path.stat().st_size}\n")
    fetch_artifact("senet50-ferplus", root=tmp_path, download=False)
    path.write_bytes(b"tampered")
    with pytest.raises(ArtifactCorrupt, match="sha256 changed"):
        fetch_artifact("senet50-ferplus", root=tmp_path, download=False)


def test_truncated_sidecar_recovers(tmp_path):
    path = artifact_path("senet50-ferplus", root=tmp_path)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"fake release contents")
    sidecar = path.with_suffix(path.suffix + ".sha256")
    for garbage in ("", "shorttoken"):
        sidecar.write_text(garbage)
        assert fetch_artifact("senet50-ferplus", root=tmp_path,
                              download=False) == path
        parts = sidecar.read_text().split()
        assert len(parts[0]) == 64 and int(parts[1]) == path.stat().st_size
    # a well-formed hash with a garbled size is a real pin: corruption
    # detection keeps priority over recovery
    sidecar.write_text("a" * 64 + " notanint")
    with pytest.raises(ArtifactUnavailable, match="sha256 changed"):
        fetch_artifact("senet50-ferplus", root=tmp_path, download=False)
    # a hash-only sidecar of the right digest is upgraded with the size
    sidecar.write_text(artifacts._file_sha256(path))
    fetch_artifact("senet50-ferplus", root=tmp_path, download=False)
    assert int(sidecar.read_text().split()[1]) == path.stat().st_size


def test_unknown_artifact_keyerror():
    with pytest.raises(KeyError):
        fetch_artifact("nonexistent-model")


def test_zoo_resolves_registry_names(tmp_path, monkeypatch):
    """The loaders resolve registry names from the cache as the JAX zoo
    does; an absent name with ``download=False`` raises
    ArtifactUnavailable, a missing path that is no name FileNotFoundError."""
    from mcncrossmodalemotions_tpu.zoo import registry as jregistry
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_student,
        load_pretrained_teacher,
        registry,
        resolve_release,
    )

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    for name in ("senet50-ferplus", "emovoxceleb-student"):
        with pytest.raises(ArtifactUnavailable):
            resolve_release(name, download=False)
    teacher = artifact_path("senet50-ferplus")
    teacher.parent.mkdir(parents=True)
    chip_smoke.teacher_release(teacher, stage_sizes=(1, 1), width=8)
    chip_smoke.student_release(artifact_path("emovoxceleb-student"),
                               fc6=64, fc7=32)
    for name in ("senet50-ferplus", "emovoxceleb-student"):
        assert resolve_release(name, download=False) == \
            jregistry.resolve_release(name, download=False) == \
            artifact_path(name)
    assert resolve_release(str(teacher)) == str(teacher)
    assert resolve_release("no/such.mat") == "no/such.mat"
    model, state = load_pretrained_teacher("senet50-ferplus", download=False,
                                           device="cpu")
    assert model.use_se and model.num_outputs == 8
    _, jvars = jregistry.load_pretrained_teacher("senet50-ferplus",
                                                 download=False)
    assert jvars["params"]["conv1"]["kernel"].shape == (7, 7, 3, 8)
    assert registry.release_mean_rgb("senet50-ferplus", download=False) == \
        jregistry.release_mean_rgb("senet50-ferplus", download=False)
    student, _ = load_pretrained_student("emovoxceleb-student",
                                         with_frontend=False, download=False,
                                         device="cpu")
    assert student.fc6.weight.shape[0] == 64
    with pytest.raises(FileNotFoundError, match="ARTIFACTS"):
        load_pretrained_teacher(tmp_path / "no.mat", device="cpu")


@pytest.mark.parametrize("container", ["classic", "v73"])
def test_emovox_imdb_from_mat_bitwise_jax(tmp_path, container):
    """Both containers read to the reference tracks, bitwise the JAX
    package's reader on the same file."""
    logits = _reference_logits(np.random.RandomState(1))
    path = write_logits_mat(tmp_path / "logits.mat", logits, container)
    imdb = emovox_imdb_from_mat(path, wav_dir="/w", frame_dir="/f")
    _check_imported(imdb, logits)
    assert imdb.wav_dir == "/w" and imdb.frame_dir == "/f"
    for with_frames in (True, False):
        assert_same_imdb(
            emovox_imdb_from_mat(path, "/w", "/f", with_frames=with_frames),
            jemovox_imdb_from_mat(path, "/w", "/f", with_frames=with_frames))


def test_emovox_imdb_from_mat_scipy_single_wav(tmp_path):
    """A 1-track classic .mat: squeeze_me collapses the wavLogits cell to
    the bare [F, 8] array; the reader must not explode it into F rows."""
    logits = [np.random.RandomState(5).randn(4, 8).astype(np.float32)]
    path = write_logits_mat(tmp_path / "single.mat", logits, names=_NAMES[:1],
                            speakers=_SPEAKERS[:1], sets=[1], frames=None)
    imdb = emovox_imdb_from_mat(path, with_frames=False)
    assert imdb.num_tracks == 1 and imdb.dense_frames is None
    np.testing.assert_array_equal(imdb.wav_logits[0], logits[0])
    assert_same_imdb(imdb, jemovox_imdb_from_mat(path, with_frames=False))


def test_classic_logits_read_without_h5py(tmp_path):
    """A classic file reads in a fresh interpreter without importing
    h5py (the card's host has none)."""
    path = write_logits_mat(tmp_path / "logits.mat",
                            _reference_logits(np.random.RandomState(4)))
    code = ("import sys\n"
            "from mcncrossmodalemotions_torch.data.imdb import "
            "emovox_imdb_from_mat\n"
            f"imdb = emovox_imdb_from_mat({str(path)!r})\n"
            "assert imdb.num_tracks == 3\n"
            "assert 'h5py' not in sys.modules, 'h5py imported'\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_fetch_driver_uses_released_imdb(tmp_path, monkeypatch):
    """fetch_emovoxceleb_imdb(download=True) resolves the released logits
    from the cache, converts them under root/wavs and root/frames, as the
    JAX driver does, and caches the npz; on a miss it falls through to the
    teacher build."""
    from mcncrossmodalemotions_tpu.exp import fetch_emovoxceleb_imdb as jfetch
    from mcncrossmodalemotions_torch.exp import fetch_emovoxceleb_imdb as tfetch

    logits = _reference_logits(np.random.RandomState(3))
    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="download=True"):
        tfetch.fetch_emovoxceleb_imdb(tmp_path / "data", download=True)
    write_logits_mat(artifact_path("emovoxceleb-logits"), logits)
    cache = tmp_path / "emovox.npz"
    imdb = tfetch.fetch_emovoxceleb_imdb(tmp_path / "data", download=True,
                                         cache_path=str(cache))
    _check_imported(imdb, logits)
    assert imdb.wav_dir == str(tmp_path / "data" / "wavs")
    assert cache.exists()
    jimdb = jfetch.fetch_emovoxceleb_imdb(tmp_path / "data", download=True,
                                          cache_path=str(tmp_path / "j.npz"))
    assert_same_imdb(imdb, jimdb)
    tfetch._MEMORY_CACHE.clear()
    jfetch._MEMORY_CACHE.clear()


def test_sidecar_fast_path_and_size_change(tmp_path):
    """Cache hits take the size fast path; a same-size tamper passes it
    but a full check catches it as ArtifactCorrupt, which skipping callers
    still catch as ArtifactUnavailable."""
    path = artifact_path("afew-logits", root=tmp_path)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"0123456789")
    fetch_artifact("afew-logits", root=tmp_path, download=False)
    sidecar = path.with_suffix(path.suffix + ".sha256")
    assert int(sidecar.read_text().split()[1]) == 10
    path.write_bytes(b"9876543210")
    fetch_artifact("afew-logits", root=tmp_path, download=False)  # fast path
    with pytest.raises(ArtifactCorrupt, match="sha256 changed"):
        artifacts._verify(path, None, full_check=True)
    with pytest.raises(ArtifactCorrupt, match="sha256 changed"):
        fetch_artifact("afew-logits", root=tmp_path, download=False,
                       full_check=True)
    path.write_bytes(b"01234")  # a size change re-hashes without full_check
    with pytest.raises(ArtifactCorrupt):
        fetch_artifact("afew-logits", root=tmp_path, download=False)
    assert issubclass(ArtifactCorrupt, ArtifactUnavailable)


# --- the download branch, through file:// URLs ------------------------------

def _serve(monkeypatch, name, source: Path, sha256=None):
    """Point ``name``'s URL at ``source`` (``file://``)."""
    art = dataclasses.replace(ARTIFACTS[name], url=source.as_uri(),
                              sha256=sha256)
    monkeypatch.setitem(ARTIFACTS, name, art)


def test_file_url_download_publishes_and_pins(tmp_path, monkeypatch):
    src = tmp_path / "upstream.mat"
    src.write_bytes(np.random.RandomState(0).bytes(3 << 20))  # 3 chunks
    _serve(monkeypatch, "afew-logits", src)
    root = tmp_path / "root"
    got = fetch_artifact("afew-logits", root=root)
    assert got == artifact_path("afew-logits", root)
    assert got.read_bytes() == src.read_bytes()
    digest = artifacts._file_sha256(src)
    assert got.with_suffix(".mat.sha256").read_text() == (
        f"{digest} {src.stat().st_size}\n")
    assert sorted(p.name for p in got.parent.iterdir()) == [
        "afew-logits.mat", "afew-logits.mat.sha256"]  # no .part left
    src.unlink()  # a hit reads the cache, not the URL
    assert fetch_artifact("afew-logits", root=root, full_check=True) == got
    # a published digest that the bytes miss: ArtifactCorrupt, and the
    # bad bytes stay for inspection (as the JAX package's)
    src.write_bytes(b"other bytes")
    _serve(monkeypatch, "voxceleb-imdb", src, sha256="0" * 64)
    with pytest.raises(ArtifactCorrupt, match="sha256 mismatch"):
        fetch_artifact("voxceleb-imdb", root=root)


def test_failed_download_raises_and_leaves_no_part(tmp_path, monkeypatch):
    _serve(monkeypatch, "afew-logits", tmp_path / "absent.mat")
    root = tmp_path / "root"
    with pytest.raises(ArtifactUnavailable, match="could not download"):
        fetch_artifact("afew-logits", root=root)
    assert list(artifact_path("afew-logits", root).parent.iterdir()) == []
    assert ensure_artifact("afew-logits", root=root) is None
    # the real URL: refused by the test's guard, the same error
    with pytest.raises(ArtifactUnavailable, match="no network"):
        fetch_artifact("senet50-ferplus", root=root)


# --- one cache for both packages --------------------------------------------

def test_cache_root_is_shared(monkeypatch, tmp_path):
    assert artifacts.cache_root() == jartifacts.cache_root() == tmp_path / "cache"
    monkeypatch.delenv("MCN_TPU_ARTIFACT_ROOT")
    assert artifacts.cache_root() == jartifacts.cache_root()
    assert artifacts.cache_root().name == "mcncrossmodalemotions_tpu"


@pytest.mark.parametrize("pin,check", [(artifacts, jartifacts),
                                       (jartifacts, artifacts)],
                         ids=["port-pins", "jax-pins"])
def test_each_package_verifies_the_others_sidecars(tmp_path, pin, check):
    path = artifact_path("emovoxceleb-student", tmp_path)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"a release placed by hand")
    pin.fetch_artifact("emovoxceleb-student", root=tmp_path, download=False)
    sidecar = path.with_suffix(".mat.sha256").read_text()
    check.fetch_artifact("emovoxceleb-student", root=tmp_path,
                         download=False, full_check=True)
    assert path.with_suffix(".mat.sha256").read_text() == sidecar
    path.write_bytes(b"a release placed by hanD")
    with pytest.raises(check.ArtifactCorrupt, match="sha256 changed"):
        check.fetch_artifact("emovoxceleb-student", root=tmp_path,
                             download=False, full_check=True)


# --- drivers that resolve through the registry ------------------------------

def test_teacher_stats_download_afew(tmp_path, monkeypatch):
    from mcncrossmodalemotions_tpu.exp import teacher_stats as jts
    from mcncrossmodalemotions_torch.exp import teacher_stats as tts

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    imdb = emovox_imdb_from_mat(write_logits_mat(
        tmp_path / "l.mat", _reference_logits(np.random.RandomState(6))))
    assert list(tts.teacher_stats(imdb, download_afew=True)) == ["emovoxceleb"]
    afew = [np.random.RandomState(7).randn(f, 8).astype(np.float32)
            for f in (3, 5)]
    path = artifact_path("afew-logits")
    cells = np.empty(2, dtype=object)
    cells[0], cells[1] = afew
    scipy.io.savemat(path, {"faceLogits": cells})
    for per in ("frame", "wav"):
        got = tts.teacher_stats(imdb, download_afew=True, per=per)
        want = jts.teacher_stats(imdb, download_afew=True, per=per)
        assert list(got) == list(want) == ["emovoxceleb", "AFEW 6.0"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_reproduce_ferplus_resolves_the_teachers(tmp_path, monkeypatch,
                                                 capsys):
    """Without ``mats`` the two teachers resolve through the registry
    (``--no-download``: a miss raises ArtifactUnavailable); a given path
    overrides its name."""
    from mcncrossmodalemotions_torch.exp import reproduce_ferplus as rf
    from tests.test_verify_release import _write_fer_csvs

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "tree"))
    fer, plus = _write_fer_csvs(tmp_path, np.random.RandomState(2), n=12)
    args = ["--fer-csv", fer, "--ferplus-csv", plus, "--batch-size", "4",
            "--input-size", "48", "--device", "cpu",
            "--out-root", str(tmp_path / "out")]
    with pytest.raises(ArtifactUnavailable):
        rf.main(args + ["--no-download"])
    for name, use_se in (("resnet50-ferplus", False),
                         ("senet50-ferplus", True)):
        path = artifact_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        chip_smoke.teacher_release(path, use_se=use_se, stage_sizes=(1, 1),
                                   width=8)
    assert rf.main(args + ["--no-download"]) == 1  # random teachers
    report = json.loads((tmp_path / "out" / "report.json").read_text())
    assert sorted(report["results"]) == ["resnet50-ferplus", "senet50-ferplus"]
    other = tmp_path / "elsewhere.mat"
    chip_smoke.teacher_release(other, use_se=True, stage_sizes=(1, 1),
                               width=8, seed=3)
    artifact_path("senet50-ferplus").unlink()
    report = rf.reproduce_ferplus(fer, plus, {"senet50-ferplus": str(other)},
                                  out_root=str(tmp_path / "out2"),
                                  download=False, batch_size=4,
                                  input_size=48, device="cpu")
    assert len(report["rows"]) == 4
    assert "senet50-ferplus: val" in capsys.readouterr().out
