"""The batcher's feed options and the driver's experiment names, on the CPU.

- Batches of the port's ``EmoVoxBatcher`` bitwise equal to the JAX
  batcher's (``data``, targets), over two epochs, for each option the
  driver wires: speed augmentation, the noise corpus (numbered wavs, one
  of them off-rate) and the corpus-free noise mix, fixedSegments
  (``time_offsets``: pinned crops, whole-track targets), the mu-law feed,
  float rows, and the loss types' target sets. The JAX batcher reads
  through the committed C++ library where it loads, the port through its
  own (``data/native_audio.py``) where speed and noise are off.
- The port's library batches bitwise equal to its Python reads
  (``MCNCME_DISABLE_NATIVE``), int16 and mu-law, with an off-rate track
  in the set (read apart and resampled on the host); the library's
  ``read_crops_packed(fmt="mulaw8")`` rows are ``pack_mulaw8`` of its float
  reads, and the JAX bindings', bit for bit.
- The library path's array code over a batch (crop draws, windows,
  targets) on batches that mix tracks shorter than the crop, which draw
  nothing, with drawing ones, and an off-rate track amid on-rate ones:
  bitwise the JAX batcher's and the Python reads'; each window against
  ``target_logit_window`` where it ends on a track's last logit; the
  ``feed.batch`` span of each batch while spans record.
- ``DistillationConfig.exp_name()`` letter for letter the JAX package's
  for each option, and the fixedSegments directory suffix the JAX
  driver's.
"""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data import audio, emovox, native_audio
from mcncrossmodalemotions_torch.exp import run_distillation as rd
from mcncrossmodalemotions_torch.utils import trace
from mcncrossmodalemotions_tpu.data import emovox as jemovox
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.exp import run_distillation as jrd

CROP = dict(num_seconds=1.0, batch_size=4)


@pytest.fixture(scope="module")
def imdb(tmp_path_factory):
    """12 tracks straddling the 1 s crop; track 5 rewritten at 22.05 kHz
    (an off-rate file the batchers resample on the host)."""
    root = tmp_path_factory.mktemp("feed")
    imdb = jemovox.build_synthetic_imdb(root / "wav", num_speakers=3,
                                        tracks_per_speaker=4,
                                        duration_range=(0.8, 2.5))
    path = root / "wav" / imdb.wav_paths[5]
    samples, fs = audio.read_wav(path)
    audio.write_wav(path, audio.resample_to(samples, fs, 22050), 22050)
    return imdb


@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    """A corpus of three numbered noise wavs; 02.wav is at 8 kHz."""
    root = tmp_path_factory.mktemp("noise")
    for i, (n, fs) in enumerate(((21000, 16000), (9000, 8000),
                                 (30000, 16000)), start=1):
        rng = np.random.RandomState(i)
        audio.write_wav(root / f"{i:02d}.wav",
                        (rng.randn(n) * 0.2).astype(np.float32), fs)
    return str(root)


def _options(noise_dir):
    return {
        "default": {},
        "speed": dict(speed_aug=True),
        "corpus": dict(noise=(noise_dir, 3)),
        "corpus-and-speed": dict(speed_aug=True, noise=(noise_dir, 3, 0.5)),
        "noise-fallback": dict(noise_aug=True),
        "mulaw": dict(emit_mulaw=True),
        "float": dict(emit_int16=False),
        "euclidean-mean": dict(loss_type="euclidean", logit_aggregator="mean"),
    }


def _cfg(mod, option):
    option = dict(option)
    if "noise" in option:
        option["noise"] = mod.NoiseConfig(*option["noise"])
    return mod.BatchConfig(**CROP, **option)


def _batches(mod, imdb, option, train, offsets=None):
    batcher = mod.EmoVoxBatcher(imdb, _cfg(mod, option), train=train, seed=3,
                                time_offsets=offsets)
    return [b for epoch in (1, 2) for b in batcher.batches(epoch)]


def _assert_equal(got, want):
    assert len(got) == len(want) == 6  # 12 tracks in batches of 4, 2 epochs
    for t, j in zip(got, want):
        assert sorted(t) == sorted(j)
        for key in j:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


@pytest.mark.parametrize("name", ["default", "speed", "corpus",
                                  "corpus-and-speed", "noise-fallback",
                                  "mulaw", "float", "euclidean-mean"])
@pytest.mark.parametrize("train", [True, False])
def test_batches_bitwise_equal_to_jax(imdb, noise_dir, name, train):
    option = _options(noise_dir)[name]
    got = _batches(emovox, imdb, option, train)
    _assert_equal(got, _batches(jemovox, imdb, option, train))
    dtype = {"mulaw": np.uint8, "float": np.float32}.get(name, np.int16)
    assert all(b["data"].dtype == dtype for b in got)
    if train and name != "default":  # the option changed the batches
        base = _batches(emovox, imdb, {}, train)
        assert any(not np.array_equal(a["data"].astype(np.float64),
                                      b["data"].astype(np.float64))
                   or not np.array_equal(a["max_label"], b["max_label"])
                   or a.keys() != b.keys()
                   for a, b in zip(got, base)), name


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("augment", [False, True])
def test_fixed_segments_bitwise_equal_to_jax(imdb, train, augment):
    """Pinned starts (one past the end of its track, one negative) and
    whole-track targets; speed augmentation skips pinned crops and draws
    nothing for them."""
    offsets = np.linspace(-0.2, 2.6, imdb.num_tracks)
    option = dict(speed_aug=True) if augment else {}
    got = _batches(emovox, imdb, option, train, offsets)
    _assert_equal(got, _batches(jemovox, imdb, option, train, offsets))
    free = _batches(emovox, imdb, option, train)
    assert not all(np.array_equal(a["data"], b["data"])
                   for a, b in zip(got, free))
    whole = [emovox.aggregate_logits(l, 0.0, 1e6, "max")[:8]
             for l in imdb.wav_logits]
    first = emovox.EmoVoxBatcher(imdb, _cfg(emovox, option), train=False,
                                 time_offsets=offsets)
    batch = next(iter(first.batches(1)))
    np.testing.assert_array_equal(batch["logit_target"], np.stack(whole[:4]))


@pytest.mark.parametrize("fmt_option", [{}, dict(emit_mulaw=True),
                                        dict(emit_int16=False)])
@pytest.mark.parametrize("offsets", [False, True])
def test_library_batches_bitwise_equal_to_python_reads(imdb, monkeypatch,
                                                      fmt_option, offsets):
    """The library path (one threaded read a batch; the off-rate track read
    apart) against the Python reads, which ``MCNCME_DISABLE_NATIVE``
    selects; the train stream draws alike on both."""
    times = np.linspace(0.0, 1.5, imdb.num_tracks) if offsets else None
    batcher = emovox.EmoVoxBatcher(imdb, _cfg(emovox, fmt_option),
                                   train=True, seed=5, time_offsets=times)
    assert batcher.uses_library()
    lib = [b for e in (1, 2) for b in batcher.batches(e)]
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")
    assert not batcher.uses_library()
    _assert_equal(lib, [b for e in (1, 2) for b in batcher.batches(e)])


SHORT, OFF_RATE = (1, 3, 6), 4  # the mixed set's short and off-rate tracks


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """8 tracks of 1.6-2.5 s; tracks ``SHORT`` cut below the 1 s crop
    (no crop-start draw, their logits cut to match) and track ``OFF_RATE``
    rewritten at 22.05 kHz."""
    root = tmp_path_factory.mktemp("mixed") / "wav"
    imdb = jemovox.build_synthetic_imdb(root, num_speakers=2,
                                        tracks_per_speaker=4, seed=1,
                                        duration_range=(1.6, 2.5))
    for k, seconds in zip(SHORT, (0.6, 0.9, 0.75)):
        path = root / imdb.wav_paths[k]
        samples, fs = audio.read_wav(path)
        audio.write_wav(path, samples[:int(seconds * fs)], fs)
        imdb.wav_logits[k] = imdb.wav_logits[k][:max(int(seconds * 25 / 6), 1)]
    path = root / imdb.wav_paths[OFF_RATE]
    samples, fs = audio.read_wav(path)
    audio.write_wav(path, audio.resample_to(samples, fs, 22050), 22050)
    return imdb


def _mixed_batches(mod, imdb, option, batch_size, seed):
    cfg = dataclasses.replace(_cfg(mod, option), batch_size=batch_size)
    batcher = mod.EmoVoxBatcher(imdb, cfg, train=True, seed=seed)
    return batcher, [b for e in (1, 2) for b in batcher.batches(e)]


@pytest.mark.parametrize("fmt_option", [{}, dict(emit_mulaw=True),
                                        dict(emit_int16=False)])
@pytest.mark.parametrize("batch_size,seed", [(8, 11), (4, 2)])
def test_mixed_library_batches_bitwise_equal_to_jax_and_python(
        mixed, monkeypatch, fmt_option, batch_size, seed):
    """Short tracks (no draw) between drawing ones, and the off-rate track
    (its draw taken by ``load_crop`` in its place) inside a batch, not at
    its ends: two epochs of the library path bitwise the JAX batcher's and
    the Python reads'."""
    batcher, got = _mixed_batches(emovox, mixed, fmt_option, batch_size, seed)
    assert batcher.uses_library()
    between = off_inside = False
    for e in (1, 2):
        idx = batcher.epoch_indices(e)
        for i in range(0, len(idx), batch_size):
            chunk = list(idx[i:i + batch_size])
            short = [j in SHORT for j in chunk]
            between |= any(short[p] and not short[p - 1] and not short[p + 1]
                           for p in range(1, len(chunk) - 1))
            off_inside |= OFF_RATE in chunk[1:-1]
    assert between and off_inside
    want = _mixed_batches(jemovox, mixed, fmt_option, batch_size, seed)[1]
    assert len(got) == len(want) == 2 * 8 // batch_size
    for t, j in zip(got, want):
        assert sorted(t) == sorted(j)
        for key in j:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")
    assert not batcher.uses_library()
    python = [b for e in (1, 2) for b in batcher.batches(e)]
    for t, p in zip(got, python):
        assert sorted(t) == sorted(p)
        for key in p:
            np.testing.assert_array_equal(t[key], p[key], err_msg=key)


@pytest.mark.parametrize("aggregator", ["max", "mean"])
@pytest.mark.parametrize("offsets", [False, True])
def test_batch_windows_and_targets_are_each_rows(mixed, aggregator, offsets):
    """The batch's windows and targets against ``target_logit_window`` and
    ``make_targets`` of each row, at crop starts whose windows end on the
    track's last logit (by the index arithmetic and by the clip), or just
    before it, and at 0."""
    cfg = dataclasses.replace(_cfg(emovox, dict(loss_type="euclidean")),
                              logit_aggregator=aggregator)
    times = np.linspace(0.0, 1.5, mixed.num_tracks) if offsets else None
    batcher = emovox.EmoVoxBatcher(mixed, cfg, train=True, time_offsets=times)
    chunk = np.arange(mixed.num_tracks)
    lengths = np.array([len(x) for x in mixed.wav_logits])
    t0 = np.zeros(len(chunk))
    ends = 0
    for shift in (0.0, -1 / 16000, 1 / 16000, -0.1, 0.3):
        # t0 + 1 s on the first time of the last logit's frame, shifted
        t0 = np.maximum((6 * (lengths - 1) + 1) / 25 - 1.0 + shift, 0.0)
        windows = batcher._windows(chunk, t0)
        targets = emovox.batch_targets(windows, cfg)
        for k, j in enumerate(chunk):
            want = emovox.target_logit_window(
                mixed.wav_logits[j], None if offsets else float(t0[k]), cfg)
            np.testing.assert_array_equal(windows[k], want)
            row = emovox.make_targets(want, cfg)
            assert sorted(row) == sorted(targets)
            for key, value in row.items():
                assert targets[key].dtype == value.dtype
                np.testing.assert_array_equal(targets[key][k], value)
            i1 = max(emovox.time_to_logit_idx(float(t0[k]) + 1.0, lengths[k])
                     + 1, 1)
            ends += i1 == lengths[k]
    assert ends >= len(chunk)


def test_feed_batch_spans_while_recording(mixed):
    """Each library batch is one ``feed.batch`` span with its ``rows`` and
    the ``raw_rows`` the library copied: every row of an all-on-rate int16
    batch, none of the batch with the off-rate track (read apart, then
    packed on the host); nothing while spans do not record."""
    batcher = emovox.EmoVoxBatcher(mixed, _cfg(emovox, {}),
                                   train=True, seed=2)
    trace.reset()
    list(batcher.batches(1))
    assert trace.snapshot()["spans"] == []
    trace.enable()
    try:
        list(batcher.batches(1))
    finally:
        trace.disable()
    spans = [s for s in trace.snapshot()["spans"] if s[trace.NAME] == "feed.batch"]
    trace.reset()
    idx = batcher.epoch_indices(1)
    want = [{"rows": 4, "raw_rows": 0 if OFF_RATE in idx[i:i + 4] else 4}
            for i in range(0, len(idx), 4)]
    assert [s[trace.ATTRS] for s in spans] == want
    assert all(s[trace.END] >= s[trace.START] for s in spans)
    assert {s[trace.TID] for s in spans} == {threading.get_native_id()}


def test_augmented_train_batches_read_in_python(imdb, noise_dir):
    for option in ({"speed_aug": True}, {"noise_aug": True},
                   {"noise": (noise_dir, 3)}):
        cfg = _cfg(emovox, option)
        assert not emovox.EmoVoxBatcher(imdb, cfg, train=True).uses_library()
        assert emovox.EmoVoxBatcher(imdb, cfg, train=False).uses_library()


def test_mulaw_packed_reads_bitwise(imdb):
    paths = [str(Path(imdb.wav_dir) / p) for i, p in enumerate(imdb.wav_paths)
             if i != 5]  # 16 kHz only
    starts = [(53 * k) % 700 for k in range(len(paths))]
    n = 20000  # past the end of every file
    floats = native_audio.read_crops(paths, starts, n, 3)
    got = native_audio.read_crops_packed(paths, starts, n, 3, fmt="mulaw8")
    assert got.dtype == np.uint8 and got.shape == (len(paths), n)
    np.testing.assert_array_equal(got, audio.pack_mulaw8(floats))
    np.testing.assert_array_equal(
        got, jnative.read_crops_packed(paths, starts, n, "mulaw8", 3))
    np.testing.assert_array_equal(
        native_audio.read_crops_packed(paths, starts, n, 3),
        audio.pack_pcm16(floats))
    with pytest.raises(ValueError, match="feed format"):
        native_audio.read_crops_packed(paths, starts, n, fmt="mulaw16")


def test_noise_config_and_helpers_equal_jax(noise_dir):
    tfields = {f.name: f.default for f in dataclasses.fields(emovox.NoiseConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(jemovox.NoiseConfig)}
    assert tfields == jfields
    assert (emovox.NoiseConfig(noise_dir, 3).file_path(2)
            == jemovox.NoiseConfig(noise_dir, 3).file_path(2))
    for seconds, fs, n in ((0.5, 16000, 20000), (-1.0, 16000, 100),
                           (9.0, 8000, 4000), (0.0, 16000, 0)):
        assert (emovox.pinned_start(seconds, fs, n)
                == jemovox.pinned_start(seconds, fs, n))
    samples = np.random.RandomState(0).randn(16384).astype(np.float32)
    for seed in range(4):
        ncfg = (emovox.NoiseConfig(noise_dir, 3, noise_len=12000)
                if seed % 2 else emovox.NoiseConfig(noise_dir, 3))
        jcfg = jemovox.NoiseConfig(noise_dir, 3, noise_len=ncfg.noise_len)
        got = emovox.mix_corpus_noise(samples, ncfg,
                                      np.random.RandomState(seed), 16000)
        want = jemovox.mix_corpus_noise(samples, jcfg,
                                        np.random.RandomState(seed), 16000)
        np.testing.assert_array_equal(got, want)


EXP_OPTIONS = {
    "default": {},
    "online": dict(online_teacher=True, frames_per_crop=2, frame_size=48),
    "remat": dict(remat_policy="save_pools"),
    "mulaw": dict(mulaw_feed=True),
    "speed": dict(speed_aug=True),
    "noise": dict(noise_num=3, noise_dir="/corpus", noise_vol=0.25),
    "speed-and-noise": dict(speed_aug=True, noise_num=2, noise_dir="/n"),
    "from-release": dict(from_scratch=False, pretrained_student="/r.mat"),
    "dropout-seed": dict(dropout=0.5, seed=3, tiny_model=True),
    "euclidean-mean": dict(loss_type="euclidean", logit_aggregator="mean",
                           temperature=1.0, num_seconds=3.0),
    "all": dict(online_teacher=True, mulaw_feed=True, speed_aug=True,
                noise_num=3, noise_dir="/n", remat_policy="nothing"),
}


@pytest.mark.parametrize("name", sorted(EXP_OPTIONS))
def test_exp_name_equals_jax_for_each_option(name):
    option = EXP_OPTIONS[name]
    assert (rd.DistillationConfig(**option).exp_name()
            == jrd.DistillationConfig(**option).exp_name())


def test_fixed_segments_exp_dir_equals_jax(imdb, tmp_path, monkeypatch):
    """Both drivers, 0 epochs, the same offsets: the same
    ``-fixedseg-<hash>`` directory, apart from the plain run's. The JAX
    driver's trainer is stubbed out (its epochs are not under test and its
    init compiles for seconds)."""

    class NoTrainer:
        def __init__(self, *args, **kwargs):
            pass

        def fit(self, *args, **kwargs):
            return None, []

    monkeypatch.setattr(jrd, "Trainer", NoTrainer)
    torch.set_num_threads(2)
    offsets = np.linspace(0.0, 1.0, imdb.num_tracks)
    kw = dict(num_epochs=0, tiny_model=True, mini_epoch_ratio=1.0, **CROP)
    _, history, got = rd.run_distillation(
        rd.DistillationConfig(out_root=str(tmp_path / "t"), **kw), imdb,
        time_offsets=offsets, device="cpu")
    _, _, want = jrd.run_distillation(
        jrd.DistillationConfig(out_root=str(tmp_path / "j"), **kw), imdb,
        mesh=None, time_offsets=offsets)
    assert history == [] and got.name == want.name
    assert got.name.startswith(rd.DistillationConfig(**kw).exp_name()
                               + "-fixedseg-")
