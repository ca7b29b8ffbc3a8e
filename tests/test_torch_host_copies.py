"""The port's copies of the JAX package's host modules, held equal to
their originals on the same inputs.

- ``data.audio``: ``write_wav`` writes the same bytes; ``wav_info``,
  ``read_wav``, ``float_to_pcm16``, ``pack_pcm16`` and ``resample_to``
  give equal results, over the wav formats the reader accepts;
- ``data.imdb``: ``.npz`` manifests round-trip in both directions, with
  the same keys (``EmoVoxImdb``, ``FerPlusImdb``, ``TrackImdb``);
  ``object_array`` and ``float_tracks`` agree;
- ``data.ferplus`` and the host warp of ``ops.warp``: the synthetic FER+
  imdb and its augmented batches bitwise equal
  (``tests/test_torch_ferplus.py`` and ``tests/test_torch_warp.py`` cover
  every function);
- ``data.external``: ``build_synthetic_track_imdb`` writes the same wavs
  and returns equal manifests; ``get_rml_imdb`` reads a tree alike;
- ``data.native``: where the C++ library loads, the same crops as the JAX
  bindings and as the Python reads; switched off, the extractor reads in
  Python;
- ``utils.config``: ``to_dict`` and ``config_hash`` agree;
- ``utils.logging``: ``MetricsLogger`` and ``Eta`` write the same lines.
"""

import dataclasses
import io
import struct
import time
from typing import Optional, Tuple

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data import audio, external, imdb, native
from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats
from mcncrossmodalemotions_torch.exp.run_distillation import DistillationConfig
from mcncrossmodalemotions_torch.utils import config, logging
from mcncrossmodalemotions_tpu.data import audio as jaudio
from mcncrossmodalemotions_tpu.data import external as jexternal
from mcncrossmodalemotions_tpu.data import imdb as jimdb
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.utils import config as jconfig
from mcncrossmodalemotions_tpu.utils import logging as jlogging


def _wav_bytes(payload: bytes, fmt: int, channels: int, rate: int,
               bits: int, extra_chunk: bool) -> bytes:
    """A RIFF/WAVE file; ``extra_chunk`` puts an odd-sized LIST chunk
    before ``fmt `` (the parser must skip it and its pad byte)."""
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate,
                            rate * channels * bits // 8, channels * bits // 8,
                            bits)
    body = b"WAVE"
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    body += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("dtype,fmt,channels,extra", [
    ("<i2", 1, 1, False), ("<i2", 1, 2, True), ("u1", 1, 1, True),
    ("<i4", 1, 2, False), ("<f4", 3, 1, True)])
def test_wav_info_and_read_wav_equal(tmp_path, dtype, fmt, channels, extra):
    rng = np.random.RandomState(channels)
    n = 1001 * channels
    if dtype == "<f4":
        data = rng.uniform(-1, 1, n).astype(dtype)
    else:
        info = np.iinfo(np.dtype(dtype))
        data = rng.randint(info.min, int(info.max) + 1, n).astype(dtype)
    path = tmp_path / "a.wav"
    path.write_bytes(_wav_bytes(data.tobytes(), fmt, channels, 22050,
                                np.dtype(dtype).itemsize * 8, extra))
    assert (dataclasses.asdict(audio.wav_info(path))
            == dataclasses.asdict(jaudio.wav_info(path)))
    assert audio.wav_info(path).duration == jaudio.wav_info(path).duration
    for start, count in ((0, None), (17, 300), (990, 50)):
        got, rate = audio.read_wav(path, start, count)
        ref, jrate = jaudio.read_wav(path, start, count)
        assert rate == jrate == 22050 and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_write_wav_same_bytes_and_packing_equal(tmp_path):
    rng = np.random.RandomState(0)
    wave = rng.randn(4000).astype(np.float32) * 0.7  # clips past +-1
    audio.write_wav(tmp_path / "t" / "a.wav", wave, 16000)
    jaudio.write_wav(tmp_path / "j" / "a.wav", wave, 16000)
    assert ((tmp_path / "t" / "a.wav").read_bytes()
            == (tmp_path / "j" / "a.wav").read_bytes())
    rows = rng.randn(3, 500).astype(np.float32) * np.array([[0.2], [1.0], [3.0]])
    np.testing.assert_array_equal(audio.float_to_pcm16(rows[0]),
                                  jaudio.float_to_pcm16(rows[0]))
    got, ref = audio.pack_pcm16(rows), jaudio.pack_pcm16(rows)
    assert got.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    assert audio.MULAW_MU == jaudio.MULAW_MU
    for fs in (16000, 22050, 44100, 8000):
        np.testing.assert_array_equal(audio.resample_to(rows[1], fs, 16000),
                                      jaudio.resample_to(rows[1], fs, 16000))


def _emovox(mod, with_frames: bool):
    rng = np.random.RandomState(1)
    return mod.EmoVoxImdb(
        wav_paths=np.asarray(["a/1.wav", "b/2.wav", "c/3.wav"], dtype=object),
        speaker=np.asarray(["a", "b", "c"], dtype=object),
        set_id=np.asarray([1, 2, 3], np.int32),
        wav_logits=[rng.randn(4, 8).astype(np.float32) for _ in range(3)],
        dense_frames=([np.asarray([f"f{i}.jpg"], dtype=object)
                       for i in range(3)] if with_frames else None),
        wav_dir="/w", frame_dir="/f", classes=("x", "y"))


def _track(mod):
    rng = np.random.RandomState(2)
    return mod.TrackImdb(
        track_ids=np.asarray(["t0", "t1"], dtype=object),
        labels=np.asarray([0, 5], np.int32), set_id=np.asarray([1, 2], np.int32),
        wav_paths=np.asarray(["t0.wav", "t1.wav"], dtype=object),
        frame_paths=[np.asarray([], dtype=object),
                     np.asarray(["a.jpg", "b.jpg"], dtype=object)],
        logits=[rng.randn(3, 8).astype(np.float32) for _ in range(2)],
        classes=("p", "q"))


def _ferplus(mod):
    rng = np.random.RandomState(3)
    return mod.FerPlusImdb(
        data=rng.randint(0, 256, (5, 48, 48, 1)).astype(np.uint8),
        hard_labels=np.asarray([0, 3, 7, 1, 1], np.int32),
        votes=rng.randint(0, 6, (5, 10)).astype(np.float32),
        set_id=np.asarray([1, 1, 2, 3, 3], np.int32), classes=("n", "h"))


def _assert_same_imdb(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", ["emovox", "emovox-frames", "track",
                                  "ferplus"])
def test_imdb_npz_round_trips_both_ways(tmp_path, kind):
    make = {"emovox": lambda m: _emovox(m, False),
            "emovox-frames": lambda m: _emovox(m, True),
            "track": _track, "ferplus": _ferplus}[kind]
    ours, theirs = make(imdb), make(jimdb)
    cls = type(ours)
    jcls = type(theirs)
    ours.save(tmp_path / "t.npz")
    theirs.save(tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz", allow_pickle=True) as t, \
            np.load(tmp_path / "j.npz", allow_pickle=True) as j:
        assert sorted(t.files) == sorted(j.files)
        assert str(t["__meta__"]) == str(j["__meta__"])
    _assert_same_imdb(jcls.load(tmp_path / "t.npz"), cls.load(tmp_path / "t.npz"))
    _assert_same_imdb(cls.load(tmp_path / "j.npz"), jcls.load(tmp_path / "j.npz"))
    _assert_same_imdb(cls.load(tmp_path / "j.npz"), ours)


def test_imdb_helpers_and_subsets_equal():
    rows = [np.ones((2, 8), np.float32), np.zeros((2, 8), np.float32)]
    got, ref = imdb.object_array(rows), jimdb.object_array(rows)
    assert got.shape == ref.shape == (2,) and got.dtype == ref.dtype == object
    legacy = np.asarray(rows, dtype=object)  # the collapsing idiom
    for a, b in zip(imdb.float_tracks(legacy), jimdb.float_tracks(legacy)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (imdb.SET_TRAIN, imdb.SET_UNHEARD_VAL, imdb.SET_HEARD_VAL) == (
        jimdb.SET_TRAIN, jimdb.SET_UNHEARD_VAL, jimdb.SET_HEARD_VAL)
    _assert_same_imdb(_emovox(imdb, True).subset([2, 0]),
                      _emovox(jimdb, True).subset([2, 0]))
    _assert_same_imdb(_ferplus(imdb).subset([4, 1]),
                      _ferplus(jimdb).subset([4, 1]))
    assert _ferplus(imdb).num_images == _ferplus(jimdb).num_images == 5


def test_ferplus_and_host_warp_copies_equal():
    """The synthetic FER+ imdb and its host-augmented batches (warp at 48
    and straight to 64), bit for bit."""
    from mcncrossmodalemotions_torch.data import ferplus
    from mcncrossmodalemotions_tpu.data import ferplus as jferplus

    ours, theirs = (m.build_synthetic_ferplus(40, seed=2)
                    for m in (ferplus, jferplus))
    _assert_same_imdb(ours, theirs)
    for out_size in (None, 64):
        kw = dict(subset=1, batch_size=12, shuffle=True, seed=5,
                  augment=True, augment_out_size=out_size)
        for a, b in zip(ferplus.ferplus_batches(ours, **kw),
                        jferplus.ferplus_batches(theirs, **kw)):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("classes", [external.RML_CLASSES, ("calm", "loud")])
def test_synthetic_track_imdb_equal(tmp_path, classes):
    kw = dict(classes=classes, tracks_per_class=2, seed=3, duration=0.3)
    ours = external.build_synthetic_track_imdb(tmp_path / "t", **kw)
    theirs = jexternal.build_synthetic_track_imdb(tmp_path / "j", **kw)
    assert ours.classes == theirs.classes
    for field in ("track_ids", "labels", "set_id"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    assert len(ours.wav_paths) == len(theirs.wav_paths) == 2 * len(classes)
    for a, b in zip(ours.wav_paths, theirs.wav_paths):
        rel = str(a).split("/t/", 1)[1]
        assert rel == str(b).split("/j/", 1)[1]
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    for a, b in zip(ours.frame_paths, theirs.frame_paths):
        np.testing.assert_array_equal(a, b)
    # both scanners read the same tree alike
    _assert_same_imdb(external.get_rml_imdb(tmp_path / "j"),
                      jexternal.get_rml_imdb(tmp_path / "j"))


@pytest.fixture
def tracks(tmp_path):
    return external.build_synthetic_track_imdb(
        tmp_path, classes=("a", "b"), tracks_per_class=2, duration=0.7)


def test_native_reader_equals_the_jax_bindings_and_python(tracks):
    if not (native.available() and jnative.available()):
        pytest.skip("native/libdataservice.so does not load on this host")
    paths = [str(p) for p in tracks.wav_paths]
    starts, n = [0, 100, 5000, 11000], 4000  # the last runs past the end
    got = native.read_crops(paths, starts, n, num_threads=2)
    np.testing.assert_array_equal(got, jnative.read_crops(paths, starts, n, 2))
    for row, path, start in zip(got, paths, starts):
        ref, _ = audio.read_wav(path, start, n)
        np.testing.assert_array_equal(row, np.pad(ref, (0, n - len(ref))))
    assert native.packed_reads_available() == jnative.packed_reads_available()
    if native.packed_reads_available():
        packed = native.read_crops_packed(paths, starts, n, 2)
        np.testing.assert_array_equal(
            packed, jnative.read_crops_packed(paths, starts, n, "int16", 2))
        np.testing.assert_array_equal(packed, audio.pack_pcm16(got))


def test_switched_off_native_reader_falls_back_to_python(tracks, monkeypatch):
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    model = build_student(tiny=True, with_frontend=False, dtype=torch.float32)
    state = student_state_dict_from_flax(
        random_student_variables(seed=1, fc6=64, fc7=32))
    paths = [str(p) for p in tracks.wav_paths]

    def extract():
        ex = tfeats.AudioFeatureExtractor(model, state, batch_size=2,
                                          device="cpu")
        return ex.track_logits(paths, verbose=False), ex.readers

    first, first_readers = extract()
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available() and not native.packed_reads_available()
    with pytest.raises(RuntimeError):
        native.read_crops(paths, [0] * len(paths), 100)
    logits, readers = extract()
    assert readers == {"python"}
    for a, b in zip(logits, first):  # the readers are bit-identical
        np.testing.assert_array_equal(a, b)
    assert first_readers  # whichever reader the host took first


@dataclasses.dataclass(frozen=True)
class _Inner:
    widths: Tuple[int, ...] = (64, 32)
    name: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class _Outer:
    lr: float = 1e-4
    inner: _Inner = _Inner()
    tags: tuple = ("a", 1.5, None)


@pytest.mark.parametrize("cfg", [_Outer(), _Outer(lr=0.5, inner=_Inner((1,), "x")),
                                 DistillationConfig(), ("id", 2.0, True, None)])
def test_config_hash_and_to_dict_equal(cfg):
    assert config.to_dict(cfg) == jconfig.to_dict(cfg)
    assert config.config_hash(cfg) == jconfig.config_hash(cfg)


def test_metrics_logger_and_eta_write_the_same_lines(tmp_path, monkeypatch):
    records = [{"epoch": 1, "loss": np.float32(0.25),
                "train": {"n": 3, "acc": np.float64(0.5)}},
               {"epoch": 2, "arr": [1, 2], "s": "x"}]
    ours = logging.MetricsLogger(tmp_path / "t" / "m.jsonl")
    theirs = jlogging.MetricsLogger(tmp_path / "j" / "m.jsonl")
    for r in records:
        ours.log(r)
        theirs.log(r)
    assert ((tmp_path / "t" / "m.jsonl").read_text()
            == (tmp_path / "j" / "m.jsonl").read_text())

    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
    out = {}
    for key, mod in (("t", logging), ("j", jlogging)):
        buf = io.StringIO()
        eta = mod.Eta(7, "feats", log_every=3, file=buf)
        for _ in range(7):
            eta.tick()
        eta.tick(2)
        out[key] = buf.getvalue()
    assert out["t"] == out["j"] and out["t"].count("\n") == 4
