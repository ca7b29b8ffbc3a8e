"""The port's own wav reader library, ``csrc/dataservice_audio.cc``.

Built here with ``g++`` by ``ops/_build.py``, it is held bit for bit to
the committed ``native/libdataservice.so`` (through the JAX package's
bindings) and to the Python reads, entry point by entry point, over the
wav formats the reader accepts, 44.1 kHz files and files shorter than the
read; a format both refuse fails in both. ``read_crops_packed`` copies the
rows of 16-bit PCM files (mono and stereo, with a ``LIST`` chunk before the
samples or not) and decodes every other file's, with the same bytes, and
counts the rows of each path. A broken source makes the build
raise with the compiler's output, and extraction does not fall back to
Python reads when the port's library cannot be built. Extraction reads
through the port's library, and through Python only where
``MCNCME_DISABLE_NATIVE`` is set, with the same logits.
"""

import struct

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data import audio, native_audio
from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats
from mcncrossmodalemotions_torch.ops import _build
from mcncrossmodalemotions_tpu.data import native as jnative

pytestmark = pytest.mark.skipif(
    not jnative.available(),
    reason="native/libdataservice.so does not load on this host")


# an INFO list of one odd-sized string: the chunk's size is 17, padded to 18
LIST_CHUNK = (b"LIST" + struct.pack("<I", 17) + b"INFO" + b"ISFT"
              + struct.pack("<I", 5) + b"port\x00" + b"\x00")


def _wav(path, data: np.ndarray, fmt: int, channels: int, rate: int,
         extra: bytes = b"") -> str:
    """A RIFF/WAVE file: fmt chunk, ``extra`` chunks, then the samples."""
    bits = data.dtype.itemsize * 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate,
                            rate * channels * bits // 8, channels * bits // 8,
                            bits)
    payload = data.tobytes()
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + extra + b"data" + struct.pack("<I", len(payload)) + payload)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


FORMATS = [  # (dtype, wav format tag, channels, sample rate, LIST chunk)
    ("<i2", 1, 1, 16000, False), ("<i2", 1, 2, 44100, False),
    ("u1", 1, 1, 16000, False), ("<i4", 1, 2, 44100, False),
    ("<f4", 3, 1, 16000, False), ("<i2", 1, 1, 16000, True),
    ("<i2", 1, 2, 16000, True)]


def _data(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if dtype == "<f4":
        return rng.uniform(-1.5, 1.5, n).astype(dtype)  # peaks above 1
    info = np.iinfo(np.dtype(dtype))
    return rng.randint(info.min, int(info.max) + 1, n).astype(dtype)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """One file of each format: 3000 frames, and a short one of 700."""
    root = tmp_path_factory.mktemp("wavs")
    out = []
    for i, (dtype, fmt, channels, rate, listed) in enumerate(FORMATS):
        for frames in (3000, 700):
            out.append(_wav(root / f"{i}-{frames}.wav",
                            _data(dtype, frames * channels, i + frames),
                            fmt, channels, rate,
                            LIST_CHUNK if listed else b""))
    return out


def test_the_port_library_is_built_from_its_source():
    assert native_audio.available()
    so = _build.library_path(native_audio.LIBRARY)
    assert so.exists() and so.parent == _build.BUILD_DIR
    assert _build.source_path(native_audio.LIBRARY).suffix == ".cc"
    assert not _build.source_path("spectrogram").suffix == ".cc"


@pytest.mark.parametrize("i", range(len(FORMATS) * 2))
def test_wav_info_and_read_wav_bitwise(wavs, i):
    path = wavs[i]
    info = native_audio.wav_info(path)
    assert info == jnative.wav_info(path)
    py = audio.wav_info(path)
    assert info == (py.num_samples, py.sample_rate, py.num_channels,
                    py.bits_per_sample)
    for start, n in ((0, -1), (17, 300), (650, 500), (5000, 10)):
        got, rate = native_audio.read_wav(path, start, n)
        ref, jrate = jnative.read_wav(path, start, n)
        assert rate == jrate == info[1]
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
        count = info[0] - start if n < 0 else n
        pyread, _ = audio.read_wav(path, start, count)
        np.testing.assert_array_equal(got, np.pad(pyread, (0, count - len(pyread))))


@pytest.mark.parametrize("threads", [1, 3])
def test_read_crops_and_packed_bitwise(wavs, threads):
    starts = [(37 * k) % 900 for k in range(len(wavs))]
    n = 2500  # past the end of every short file and some long ones
    got = native_audio.read_crops(wavs, starts, n, threads)
    ref = jnative.read_crops(wavs, starts, n, threads)
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    for row, path, start in zip(got, wavs, starts):
        pyread, _ = audio.read_wav(path, start, n)
        np.testing.assert_array_equal(row, np.pad(pyread, (0, n - len(pyread))))
    packed = native_audio.read_crops_packed(wavs, starts, n, threads)
    np.testing.assert_array_equal(
        packed, jnative.read_crops_packed(wavs, starts, n, "int16", threads))
    np.testing.assert_array_equal(packed, audio.pack_pcm16(got))
    assert packed.dtype == np.int16


@pytest.mark.parametrize("fmt", sorted(native_audio.PACKED_FORMATS))
@pytest.mark.parametrize("i", range(len(FORMATS) * 2))
def test_packed_rows_bitwise_and_counted_by_path(wavs, i, fmt):
    """Rows from the start, mid-file, one sample before the end and past
    it, and one that ends exactly at the end: bitwise the committed
    library's and the pack of the float read; a 16-bit PCM file's rows are
    counted as copied, any other file's as decoded."""
    path = wavs[i]
    frames = native_audio.wav_info(path)[0]
    starts = [0, frames // 2, frames - 1, frames + 5, 0, 100]
    for n in (2500, frames - 100):  # the second fills the last row exactly
        native_audio.reset_rows()
        got = native_audio.read_crops_packed([path] * len(starts), starts, n,
                                             3, fmt=fmt)
        want = jnative.read_crops_packed([path] * len(starts), starts, n,
                                         fmt, 3)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        floats = native_audio.read_crops([path] * len(starts), starts, n, 3)
        pack = audio.pack_mulaw8 if fmt == "mulaw8" else audio.pack_pcm16
        np.testing.assert_array_equal(got, pack(floats))
        dtype, tag, _, _, _ = FORMATS[i // 2]
        raw = len(starts) if (dtype, tag) == ("<i2", 1) else 0
        assert (native_audio.read_crops_packed.raw_rows,
                native_audio.read_crops_packed.decoded_rows) == (
                    raw, len(starts) - raw)
    native_audio.reset_rows()
    assert native_audio.read_crops_packed.raw_rows == 0
    assert native_audio.read_crops_packed.decoded_rows == 0


@pytest.mark.parametrize("threads", [1, 3])
def test_wav_infos_is_wav_info_of_each_file(tmp_path, wavs, threads):
    """The batched header read gives each file's ``wav_info`` row, in
    order; a missing file fails the call, naming it."""
    got = native_audio.wav_infos(wavs + wavs[:2], threads)
    assert got.dtype == np.int64 and got.shape == (len(wavs) + 2, 4)
    assert [tuple(r) for r in got.tolist()] == [
        native_audio.wav_info(p) for p in wavs + wavs[:2]]
    missing = str(tmp_path / "missing.wav")
    with pytest.raises(IOError, match="missing.wav"):
        native_audio.wav_infos([wavs[0], missing], threads)


def test_a_format_both_refuse_fails_in_both(tmp_path, wavs):
    bad = tmp_path / "pcm24.wav"
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 48000, 3, 24)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data"
            + struct.pack("<I", 30) + bytes(30))
    bad.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    for lib in (native_audio, jnative):
        with pytest.raises(IOError):
            lib.read_crops([wavs[0], str(bad)], [0, 0], 100, 2)
        with pytest.raises(IOError):
            lib.read_wav(str(tmp_path / "missing.wav"), 0, 10)


def test_a_broken_source_makes_the_build_raise(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    text = _build.source_path(native_audio.LIBRARY).read_text()
    (src / "broken_reader.cc").write_text(
        text.replace("int ds_wav_info(", "int ds_wav_info(undeclared_t x, "))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken_reader.cc"
                       "(.|\n)*undeclared_t"):
        _build.load("broken_reader")
    assert not _build.library_path("broken_reader").exists()
    assert _build.library_path("broken_reader").with_suffix(".log").exists()


def _extractor_inputs(tmp_path):
    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    tracks = build_synthetic_track_imdb(tmp_path, classes=("a", "b"),
                                        tracks_per_class=2, duration=0.9)
    model = build_student(tiny=True, with_frontend=False, dtype=torch.float32)
    state = student_state_dict_from_flax(
        random_student_variables(seed=3, fc6=64, fc7=32))
    return [str(p) for p in tracks.wav_paths], model, state


def test_extraction_reads_through_the_port_library(tmp_path, monkeypatch):
    paths, model, state = _extractor_inputs(tmp_path)

    def extract():
        ex = tfeats.AudioFeatureExtractor(model, state, batch_size=2,
                                          device="cpu")
        return ex.track_logits(paths, verbose=False), ex.readers

    assert tfeats.wav_reader() is native_audio
    port, readers = extract()
    assert readers == {"native-packed"}
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native_audio.LIB, "cdll", None)
    assert tfeats.wav_reader() is None
    python, readers = extract()
    assert readers == {"python"}
    for a, b in zip(port, python):
        np.testing.assert_array_equal(a, b)


def test_a_failed_build_does_not_fall_back_to_python(tmp_path, monkeypatch):
    paths, model, state = _extractor_inputs(tmp_path)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / f"{native_audio.LIBRARY}.cc").write_text("#error no reader here\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native_audio.LIB, "cdll", None)
    ex = tfeats.AudioFeatureExtractor(model, state, batch_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="no reader here"):
        ex.track_logits(paths, verbose=False)
    assert not ex.readers
