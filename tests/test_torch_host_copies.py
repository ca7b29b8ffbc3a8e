"""The port's copies of the JAX package's host modules, held equal to
their originals on the same inputs.

- ``data.audio``: ``write_wav`` writes the same bytes; ``wav_info``,
  ``read_wav``, ``float_to_pcm16``, ``pack_pcm16`` and ``resample_to``
  give equal results, over the wav formats the reader accepts;
- ``data.audio`` also: ``pack_mulaw8`` and its table, ``resample_poly``
  and ``speed_perturb`` bitwise;
- ``data.splits``: identity splits generated, applied from a speaker
  mapping, exported and reloaded bitwise alike, leaks refused alike;
- ``data.imdb``: ``.npz`` manifests round-trip in both directions, with
  the same keys (``EmoVoxImdb``, ``FerPlusImdb``, ``TrackImdb``);
  ``object_array`` and ``float_tracks`` agree;
- ``data.ferplus`` and the host warp of ``ops.warp``: the synthetic FER+
  imdb and its augmented batches bitwise equal
  (``tests/test_torch_ferplus.py`` and ``tests/test_torch_warp.py`` cover
  every function);
- ``data.external``: ``build_synthetic_track_imdb`` writes the same wavs
  and returns equal manifests, in AFEW's layout too, and its face frames
  within 10 gray levels; ``get_rml_imdb``, ``get_enterface_imdb`` and
  ``get_afew_imdb`` read a tree alike, and each package's builder's tree
  alike;
- ``data.native``: where the C++ library loads, the same crops as the JAX
  bindings and as the Python reads; switched off, the extractor reads in
  Python;
- ``utils.config``: ``to_dict`` and ``config_hash`` agree;
  ``override``/``parse_overrides`` give equal configs (or the same error)
  and ``struct2str`` the same text, over dotted paths and value tokens
  drawn by hypothesis;
- ``utils.logging``: ``MetricsLogger``, ``Eta`` and ``progress`` write
  the same lines, and ``MetricsLogger.read`` reads them back alike.
"""

import dataclasses
import io
import struct
import time
from typing import Optional, Tuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mcncrossmodalemotions_torch.data import audio, external, imdb, native
from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats
from mcncrossmodalemotions_torch.exp.ferplus_baselines import FerPlusConfig
from mcncrossmodalemotions_torch.exp.run_distillation import DistillationConfig
from mcncrossmodalemotions_torch.utils import config, logging
from mcncrossmodalemotions_tpu.data import audio as jaudio
from mcncrossmodalemotions_tpu.data import external as jexternal
from mcncrossmodalemotions_tpu.data import imdb as jimdb
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.utils import config as jconfig
from mcncrossmodalemotions_tpu.utils import logging as jlogging

FRAME_MAX = 10  # gray levels between the two builders' frames (PIL's file)


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


def test_mulaw_resample_and_speed_perturb_equal():
    rng = np.random.RandomState(1)
    rows = rng.randn(3, 700).astype(np.float32) * np.array([[0.01], [0.5], [4.0]])
    got, ref = audio.pack_mulaw8(rows), jaudio.pack_mulaw8(rows)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(audio._mulaw_lut(), jaudio._mulaw_lut())
    x = np.linspace(-1, 1, 101, dtype=np.float32)
    np.testing.assert_array_equal(audio._mulaw_encode_float(x),
                                  jaudio._mulaw_encode_float(x))
    for up, down in ((1, 1), (2, 3), (147, 160), (160, 147)):
        np.testing.assert_array_equal(audio.resample_poly(rows[1], up, down),
                                      jaudio.resample_poly(rows[1], up, down))
    for factor in (0.95, 0.987654, 1.0, 1.0312, 1.05):
        got = audio.speed_perturb(rows[1], factor)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jaudio.speed_perturb(rows[1], factor))
    np.testing.assert_array_equal(audio.speed_perturb(rows[1], 1.03, 10),
                                  jaudio.speed_perturb(rows[1], 1.03, 10))


def _split_imdb(mod, n_speakers=9, tracks=(3, 7, 12)):
    speakers = [f"id{s:03d}" for s in range(n_speakers)
                for _ in range(tracks[s % len(tracks)])]
    return mod.EmoVoxImdb(
        wav_paths=np.asarray([f"{spk}/{i:04d}.wav"
                              for i, spk in enumerate(speakers)], dtype=object),
        speaker=np.asarray(speakers, dtype=object),
        set_id=np.ones(len(speakers), np.int32),
        wav_logits=[np.zeros((2, 8), np.float32)] * len(speakers))


@pytest.mark.parametrize("seed", [0, 5])
def test_identity_splits_equal(tmp_path, seed):
    from mcncrossmodalemotions_torch.data import splits
    from mcncrossmodalemotions_tpu.data import splits as jsplits

    speakers = list(_split_imdb(imdb).speaker)
    for kw in ({}, dict(unheard_fraction=0.34, heard_val_fraction=0.2)):
        got = splits.generate_identity_splits(speakers, seed=seed, **kw)
        ref = jsplits.generate_identity_splits(speakers, seed=seed, **kw)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    mapping = {f"id{s:03d}": (2 if s in (1, 4) else 1) for s in range(9)}
    for speaker_to_set in (None, mapping):
        t = splits.apply_splits(_split_imdb(imdb), speaker_to_set,
                                heard_val_fraction=0.25, seed=seed)
        j = jsplits.apply_splits(_split_imdb(jimdb), speaker_to_set,
                                 heard_val_fraction=0.25, seed=seed)
        np.testing.assert_array_equal(t.set_id, j.set_id)
        assert {1, 2, 3} <= set(t.set_id.tolist())
    splits.export_split_manifest(t, tmp_path / "t.json")
    jsplits.export_split_manifest(j, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for mod, path in ((splits, "j.json"), (jsplits, "t.json")):
        back = mod.load_split_manifest(_split_imdb(imdb), tmp_path / path)
        np.testing.assert_array_equal(back.set_id, t.set_id)
    leak = _split_imdb(imdb)
    leak.set_id = np.where(np.arange(leak.num_tracks) % 2, 1, 2).astype(np.int32)
    for mod in (splits, jsplits):
        with pytest.raises(AssertionError, match="unheard speakers leak"):
            mod.validate_splits(leak)


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


def _relative(track_imdb, root):
    """The manifest with its wav and frame paths relative to ``root``."""
    cut = len(str(root)) + 1
    return dataclasses.replace(
        track_imdb,
        wav_paths=np.asarray([p[cut:] for p in track_imdb.wav_paths],
                             dtype=object),
        frame_paths=[np.asarray([p[cut:] for p in f], dtype=object)
                     for f in track_imdb.frame_paths])


def _gray(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L")).astype(int)


@pytest.mark.parametrize("with_frames,afew_layout",
                         [(True, False), (False, True), (True, True)])
def test_synthetic_track_imdb_layouts_and_frames_equal(tmp_path, with_frames,
                                                       afew_layout):
    """The builder's AFEW layout and its face frames: the same wavs bitwise,
    equal manifests, and frames whose pixels are within ``FRAME_MAX`` gray
    levels of the JAX builder's (PIL writes those; the port's own writer
    writes its own, as ``tests/test_torch_frames.py`` holds them)."""
    kw = dict(classes=external.AFEW_CLASSES if afew_layout else ("a", "b"),
              tracks_per_class=3, seed=5, duration=0.2,
              with_frames=with_frames, afew_layout=afew_layout)
    ours = external.build_synthetic_track_imdb(tmp_path / "t", **kw)
    theirs = jexternal.build_synthetic_track_imdb(tmp_path / "j", **kw)
    ours, theirs = _relative(ours, tmp_path / "t"), _relative(theirs, tmp_path / "j")
    _assert_same_imdb(ours, theirs)
    if afew_layout:
        assert sorted(set(ours.set_id)) == [1, 2]
    for rel in ours.wav_paths:
        assert ((tmp_path / "t" / rel).read_bytes()
                == (tmp_path / "j" / rel).read_bytes())
    frames = [rel for f in ours.frame_paths for rel in f]
    assert len(frames) == (3 * ours.num_tracks if with_frames else 0)
    worst = max((np.abs(_gray(tmp_path / "t" / rel)
                        - _gray(tmp_path / "j" / rel)).max()
                 for rel in frames), default=0)
    assert worst <= FRAME_MAX


@pytest.mark.parametrize("with_frames", [False, True])
def test_enterface_and_afew_getters_equal(tmp_path, with_frames):
    """The port's eNTERFACE and AFEW scanners read the trees the port's
    builder wrote (AFEW's Train/Val layout, with and without face frames)
    as the JAX scanners read the JAX builder's, and the JAX builder's tree
    as the JAX scanners do: dropping frameless tracks, thinning frame
    lists."""
    for side, build in (("t", external.build_synthetic_track_imdb),
                        ("j", jexternal.build_synthetic_track_imdb)):
        build(tmp_path / side / "afew", classes=external.AFEW_CLASSES,
              tracks_per_class=3, duration=0.2, with_frames=with_frames,
              afew_layout=True)
        build(tmp_path / side / "ent", tracks_per_class=2, duration=0.2)
    assert external.AFEW_CLASSES == jexternal.AFEW_CLASSES
    assert external.ENTERFACE_CLASSES == jexternal.ENTERFACE_CLASSES
    ours, theirs = tmp_path / "t", tmp_path / "j"
    _assert_same_imdb(
        _relative(external.get_enterface_imdb(ours / "ent"), ours / "ent"),
        _relative(jexternal.get_enterface_imdb(theirs / "ent"), theirs / "ent"))
    _assert_same_imdb(external.get_enterface_imdb(theirs / "ent"),
                      jexternal.get_enterface_imdb(theirs / "ent"))
    for kw in ({}, {"subsample_stride": 2}, {"drop_tracks_with_no_dets": False}):
        got = external.get_afew_imdb(ours / "afew", **kw)
        want = jexternal.get_afew_imdb(theirs / "afew", **kw)
        _assert_same_imdb(_relative(got, ours / "afew"),
                          _relative(want, theirs / "afew"))
        _assert_same_imdb(external.get_afew_imdb(theirs / "afew", **kw), want)
        assert sorted(set(got.set_id)) == [1, 2]
        for a, b in zip(got.frame_paths, want.frame_paths):
            stride = kw.get("subsample_stride", 1)
            assert len(a) == len(b) == len(range(0, 3 * with_frames, stride))


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


@dataclasses.dataclass(frozen=True)
class _Leaves:
    flag: bool = False
    count: int = 3
    rate: float = 0.5
    name: str = "x"
    shape: tuple = (1, 2)
    items: list = dataclasses.field(default_factory=lambda: [1])
    maybe_flag: Optional[bool] = None
    maybe_count: Optional[int] = None
    maybe_rate: Optional[float] = None
    maybe_name: Optional[str] = None
    inner: _Inner = _Inner()


_PATHS = ["flag", "count", "rate", "name", "shape", "items", "maybe_flag",
          "maybe_count", "maybe_rate", "maybe_name", "inner", "inner.widths",
          "inner.name", "inner.nope", "flag.deeper", "nope", ""]
_TOKENS = st.one_of(
    st.sampled_from(["true", "False", "YES", "no", "on", "OFF", "1", "0",
                     "[1, 2]", "[]", "[0.5, \"a\"]", "None", "null", "", " 7 ",
                     "1e-3", "-4", "nan", "inf", "x=y"]),
    st.integers(-10**6, 10**6).map(str),
    st.floats(allow_nan=False, width=32).map(repr),
    st.text("abc019.-[], ", max_size=8))


def _outcome(mod, cfg, *args, **kwargs):
    """(config dict, struct2str text) of the overrides as text (a parsed
    'nan' equals itself there), or the error."""
    try:
        out = mod.parse_overrides(cfg, *args, **kwargs)
    except Exception as exc:  # the two copies must raise alike
        return type(exc).__name__, str(exc)
    return repr(mod.to_dict(out)), mod.struct2str(out), repr(out)


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.tuples(st.sampled_from(_PATHS), _TOKENS), max_size=4))
def test_parse_overrides_and_struct2str_equal(pairs):
    args = [f"{path}={token}" for path, token in pairs]
    assert _outcome(config, _Leaves(), *args) == \
        _outcome(jconfig, _Leaves(), *args)
    kwargs = {path.replace(".", "__"): token for path, token in pairs if path}
    assert _outcome(config, _Leaves(), **kwargs) == \
        _outcome(jconfig, _Leaves(), **kwargs)


@settings(max_examples=100, deadline=None, database=None)
@given(st.lists(st.tuples(st.sampled_from(
    ["use_bnorm", "data_type", "pretrained_mat", "lr_values", "augment",
     "input_size", "finetune_lr", "remat_policy", "noise_dir", "noise_num",
     "mulaw_feed", "temperature", "tiny_model"]), _TOKENS), max_size=4))
def test_driver_configs_parse_alike(pairs):
    """The drivers' configs (string annotations under PEP 563, Optional
    fields) from the same CLI tokens: each package's class, equal dicts."""
    from mcncrossmodalemotions_tpu.exp.ferplus_baselines import (
        FerPlusConfig as JFerPlusConfig,
    )
    from mcncrossmodalemotions_tpu.exp.run_distillation import (
        DistillationConfig as JDistillationConfig,
    )

    for ours, theirs in ((FerPlusConfig, JFerPlusConfig),
                         (DistillationConfig, JDistillationConfig)):
        names = {f.name for f in dataclasses.fields(ours)}
        args = [f"{p}={t}" for p, t in pairs if p in names]
        got, want = (_outcome(config, ours(), *args),
                     _outcome(jconfig, theirs(), *args))
        assert got[:2] == want[:2]


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


@pytest.mark.parametrize("total", [None, 11])
def test_progress_yields_and_writes_the_same_lines(monkeypatch, capsys, total):
    """``progress`` over a generator, counted by listing it (no total) or
    given its total: the same items and the same ETA lines on stderr."""
    out = {}
    for key, mod in (("t", logging), ("j", jlogging)):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
        items = list(mod.progress((i * i for i in range(11)), total=total,
                                  name="tracks", log_every=4))
        out[key] = (items, capsys.readouterr().err)
    assert out["t"] == out["j"]
    assert out["t"][0] == [i * i for i in range(11)]
    assert out["t"][1].count("\n") == 3


def test_metrics_logger_reads_back_alike(tmp_path):
    ours = logging.MetricsLogger(tmp_path / "t" / "m.jsonl")
    theirs = jlogging.MetricsLogger(tmp_path / "j" / "m.jsonl")
    assert ours.read() == theirs.read() == []
    for r in ({"epoch": 1, "loss": np.float32(0.5)}, {"epoch": 2, "s": "x"}):
        ours.log(r)
        theirs.log(r)
    with (tmp_path / "t" / "m.jsonl").open("a") as f:  # a blank line
        f.write("\n")
    assert ours.read() == theirs.read() == [{"epoch": 1, "loss": 0.5},
                                            {"epoch": 2, "s": "x"}]


def test_write_run_meta_writes_on_rank_0_only(tmp_path, monkeypatch):
    """Rank 0 (or one process) writes the JAX copy's twin files, the same
    config in both; another rank of a data-parallel job writes nothing and
    returns its stamp, as the JAX copy does off process 0."""
    import json

    from mcncrossmodalemotions_torch.parallel import mesh as pmesh

    cfg = DistillationConfig(seed=3, noise_dir="n")
    stamp = config.write_run_meta(tmp_path / "port", cfg, num_tracks=5)
    jstamp = jconfig.write_run_meta(tmp_path / "jax", cfg, num_tracks=5)
    got, want = ({p.suffix: p for p in (tmp_path / d).iterdir()}
                 for d in ("port", "jax"))
    assert sorted(got) == sorted(want) == [".json", ".txt"]
    assert got[".json"].name == f"meta-{stamp}.json"
    assert got[".txt"].read_text() == want[".txt"].read_text()
    meta, jmeta = (json.loads(m[".json"].read_text()) for m in (got, want))
    assert meta.pop("timestamp") == stamp and jmeta.pop("timestamp") == jstamp
    assert meta.pop("hostname") == jmeta.pop("hostname")
    assert meta == jmeta
    monkeypatch.setattr(pmesh, "process_index", lambda: 1)
    assert isinstance(config.write_run_meta(tmp_path / "rank1", cfg), str)
    assert not (tmp_path / "rank1").exists()

