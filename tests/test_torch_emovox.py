"""Port parity: the jax-free EmoVoxCeleb batcher against the JAX one.

Both read the same ``build_synthetic_imdb`` tree. Where the native C++
reader loads, the JAX batcher takes it (its rows are bit-identical to the
Python path's); the test turns it off on the JAX side so that the
restated Python logic is what is compared against the port's own wav
library. Batches must be bitwise equal:
train (shuffled, random crops) and val (in order, start-anchored), two
epochs, seed 0, keys ``data`` (int16), ``logit_target``, ``max_label``.
"""

import dataclasses

import numpy as np
import pytest

from mcncrossmodalemotions_tpu.data import emovox as jemovox
from mcncrossmodalemotions_tpu.data import imdb as jimdb
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_torch.data import emovox


@pytest.fixture(scope="module")
def imdb(tmp_path_factory):
    # durations straddle the 1 s crop: short clips exercise the zero pad
    return jemovox.build_synthetic_imdb(
        tmp_path_factory.mktemp("emovox") / "wav", num_speakers=3,
        tracks_per_speaker=4, duration_range=(0.8, 2.5))


def _batches(batcher, epochs=(1, 2), **kw):
    return [b for e in epochs for b in batcher.batches(e, **kw)]


@pytest.mark.parametrize("loss_type", ["hot-cross-ent", "euclidean"])
@pytest.mark.parametrize("train", [True, False])
def test_batches_bitwise_equal_to_jax(imdb, monkeypatch, train, loss_type):
    monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(num_seconds=1.0, batch_size=5, loss_type=loss_type)
    jb = _batches(jemovox.EmoVoxBatcher(imdb, jemovox.BatchConfig(**kw),
                                        train=train, seed=0))
    tb = _batches(emovox.EmoVoxBatcher(imdb, emovox.BatchConfig(**kw),
                                       train=train, seed=0))
    assert len(tb) == len(jb) == 2 * 3  # 12 tracks in batches of 5, 2 epochs
    for j, t in zip(jb, tb):
        assert sorted(t) == sorted(j)
        assert t["data"].dtype == np.int16 and t["data"].shape[1] == 16384
        for key in j:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key])
    if train:  # epochs shuffle differently
        assert not np.array_equal(tb[0]["max_label"], tb[3]["max_label"])


def test_epoch_size_and_drop_remainder_match_jax(imdb, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(num_seconds=1.0, batch_size=4, emit_int16=False)
    jb = _batches(jemovox.EmoVoxBatcher(imdb, jemovox.BatchConfig(**kw)),
                  epochs=(3,), epoch_size=10, drop_remainder=True)
    tb = _batches(emovox.EmoVoxBatcher(imdb, emovox.BatchConfig(**kw)),
                  epochs=(3,), epoch_size=10, drop_remainder=True)
    assert len(tb) == len(jb) == 2
    for j, t in zip(jb, tb):
        assert t["data"].dtype == np.float32
        for key in j:
            np.testing.assert_array_equal(t[key], j[key])


def test_synthetic_imdb_equals_jax(tmp_path):
    j = jemovox.build_synthetic_imdb(tmp_path / "j", num_speakers=2,
                                     tracks_per_speaker=3, seed=4)
    t = emovox.build_synthetic_imdb(tmp_path / "t", num_speakers=2,
                                    tracks_per_speaker=3, seed=4)
    for field in ("wav_paths", "speaker", "set_id"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert t.classes == j.classes and t.dense_frames is None
    for a, b in zip(t.wav_logits, j.wav_logits):
        np.testing.assert_array_equal(a, b)
    for rel in j.wav_paths:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


def test_restated_constants_equal_jax():
    assert emovox.MAX_CLIP_SECONDS == jemovox.MAX_CLIP_SECONDS
    assert emovox.LOGIT_FPS == jemovox.LOGIT_FPS
    assert emovox.LOGIT_STRIDE == jemovox.LOGIT_STRIDE
    assert (emovox.SET_TRAIN, emovox.SET_UNHEARD_VAL, emovox.SET_HEARD_VAL) == (
        jimdb.SET_TRAIN, jimdb.SET_UNHEARD_VAL, jimdb.SET_HEARD_VAL)
    jfields = {f.name: f.default for f in dataclasses.fields(jemovox.BatchConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(emovox.BatchConfig)}
    assert sorted(tfields) == sorted(jfields)
    for name, default in jfields.items():
        if name != "spec":  # the restated SpecConfig, held equal elsewhere
            assert tfields[name] == default, name
    assert emovox.BatchConfig().crop_samples == jemovox.BatchConfig().crop_samples


@pytest.mark.parametrize("seconds", [0.0, 0.23, 0.24, 0.25, 1.0, 3.99, 100.0])
def test_time_to_logit_idx_and_aggregation_match_jax(seconds):
    assert (emovox.time_to_logit_idx(seconds, 17)
            == jemovox.time_to_logit_idx(seconds, 17))
    logits = np.random.RandomState(0).randn(17, 8).astype(np.float32)
    for agg in ("max", "mean"):
        np.testing.assert_array_equal(
            emovox.aggregate_logits(logits, seconds, seconds + 4.0, agg),
            jemovox.aggregate_logits(logits, seconds, seconds + 4.0, agg))


@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 32])
def test_stream_rng_matches_jax(seed):
    for stream in ("shuffle", "augment"):
        a = emovox._stream_rng(seed, 2, stream).randint(0, 1 << 30, 8)
        b = jemovox._stream_rng(seed, 2, stream).randint(0, 1 << 30, 8)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("option", [dict(speed_aug=True), dict(noise_aug=True),
                                    dict(noise=("/corpus", 3)),
                                    dict(frames_per_crop=4),
                                    dict(emit_mulaw=True)])
def test_feed_options_configure_as_jax(imdb, option):
    """Each feed option gives the JAX batcher's config; a batcher on a set
    without face frames refuses ``frames_per_crop`` up front, and the
    others change the train batches (``tests/test_torch_feed_options.py``
    holds them bitwise to JAX's)."""
    t_opt, j_opt = dict(option), dict(option)
    if "noise" in option:
        t_opt["noise"] = emovox.NoiseConfig(*option["noise"])
        j_opt["noise"] = jemovox.NoiseConfig(*option["noise"])
    cfg = emovox.BatchConfig(num_seconds=1.0, batch_size=5, **t_opt)
    jcfg = jemovox.BatchConfig(num_seconds=1.0, batch_size=5, **j_opt)
    assert cfg.noise_enabled == jcfg.noise_enabled
    for field in dataclasses.fields(jcfg):
        if field.name not in ("spec", "noise"):
            assert getattr(cfg, field.name) == getattr(jcfg, field.name)
    if "frames_per_crop" in option:
        with pytest.raises(ValueError, match="dense_frames"):
            emovox.EmoVoxBatcher(imdb, cfg)
        return
    if "noise" in option:
        return  # no corpus here: the feed-option tests read one
    base = next(iter(emovox.EmoVoxBatcher(
        imdb, emovox.BatchConfig(num_seconds=1.0, batch_size=5)).batches(1)))
    got = next(iter(emovox.EmoVoxBatcher(imdb, cfg).batches(1)))
    assert got["data"].dtype == (np.uint8 if cfg.emit_mulaw else np.int16)
    assert not np.array_equal(got["data"].astype(np.int32),
                              base["data"].astype(np.int32))


def test_unported_batcher_and_imdb_options_raise(imdb, tmp_path):
    """fixedSegments and face frames, once refused, are ported; a
    ``time_offsets`` of the wrong length raises."""
    with pytest.raises(ValueError, match="offsets"):
        emovox.EmoVoxBatcher(imdb, emovox.BatchConfig(),
                             time_offsets=np.zeros(imdb.num_tracks - 1))
    pinned = emovox.EmoVoxBatcher(imdb, emovox.BatchConfig(num_seconds=1.0),
                                  time_offsets=np.zeros(imdb.num_tracks))
    assert pinned.time_offsets.dtype == np.float64
    framed = emovox.build_synthetic_imdb(tmp_path / "wav", num_speakers=1,
                                         tracks_per_speaker=2,
                                         duration_range=(1.0, 1.2),
                                         with_frames=True)
    assert len(framed.dense_frames) == 2
    assert all((tmp_path / "frames" / f).is_file()
               for track in framed.dense_frames for f in track)
