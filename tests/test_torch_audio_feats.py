"""The extraction slice as a whole: the port's AudioFeatureExtractor against
the JAX one, on the same wav files and the same seeded weights.

The JAX side runs its jnp frontend (its default off the TPU) with an fp32
student at HIGHEST matmul precision; the port runs its CPU path, which is
the kernels' plain versions.
"""

import jax
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.data.external import build_synthetic_track_imdb
from mcncrossmodalemotions_tpu.data.imdb import TrackImdb
from mcncrossmodalemotions_tpu.exp import compute_audio_feats as jfeats
from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    random_student_variables,
    student_state_dict_from_flax,
)


def _two_bucket_imdb(root):
    """Tracks of 1.5 s (bucket 100) and 2.6 s (bucket 200)."""
    parts = [build_synthetic_track_imdb(root / f"d{i}", classes=("a", "b"),
                                        tracks_per_class=2, seed=i,
                                        duration=d)
             for i, d in enumerate((1.5, 2.6))]
    return TrackImdb(
        track_ids=np.concatenate([p.track_ids for p in parts]),
        labels=np.concatenate([p.labels for p in parts]),
        set_id=np.concatenate([p.set_id for p in parts]),
        wav_paths=np.concatenate([p.wav_paths for p in parts]))


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    imdb = _two_bucket_imdb(tmp_path_factory.mktemp("tracks"))
    variables = random_student_variables(seed=5, fc6=64, fc7=32)
    model = build_student(tiny=True, with_frontend=False, dtype=torch.float32)
    state = student_state_dict_from_flax(variables)
    return imdb, variables, model, state


def test_bucketing_matches_jax():
    for t in list(range(1, 2100, 7)) + [100, 1000, 1990, 2000]:
        assert tfeats.bucket_for(t) == jfeats.bucket_for(t)
        assert tfeats.pad_frames_shape(t) == jfeats.pad_frames_shape(t)


# the three feeds of both extractors: (emit_* flags, the rows' dtype)
FEEDS = {"int16": (dict(emit_int16=True, emit_mulaw=False), torch.int16),
         "mulaw8": (dict(emit_mulaw=True), torch.uint8),
         "float": (dict(emit_int16=False, emit_mulaw=False), torch.float32)}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_extractor_matches_jax(slice_setup, feed):
    """Each feed against the JAX extractor fed the same way."""
    imdb, variables, model, state = slice_setup
    emit = FEEDS[feed][0]
    paths = [str(p) for p in imdb.wav_paths]
    jm = JaxVGGM(fc6_features=64, fc7_features=32, dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jfeats.AudioFeatureExtractor(jm, variables, batch_size=3,
                                           use_pallas=False,
                                           **emit).track_logits(
            paths, verbose=False)
    extractor = tfeats.AudioFeatureExtractor(model, state, batch_size=3,
                                             device="cpu", **emit)
    got = extractor.track_logits(paths, verbose=False)
    assert len({tfeats.AudioFeatureExtractor(model, state)._meta(p)[1]
                for p in paths}) == 2
    assert extractor.readers
    scale = max(np.abs(r).max() for r in ref)
    assert scale > 0.1
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (1, 8)
        assert np.abs(g - r).max() <= 1e-4 * scale


def test_extractor_plain_and_wrapper_paths_agree_on_cpu(slice_setup):
    """On the CPU, use_kernels=True reaches the wrappers, which take the
    plain versions: identical logits, and no launch is counted."""
    from mcncrossmodalemotions_torch.ops.pool import max_pool_3x3s2_cuda
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    imdb, _, model, state = slice_setup
    paths = [str(p) for p in imdb.wav_paths]
    counts = (spectrogram_cuda.launches, max_pool_3x3s2_cuda.launches)
    a = tfeats.AudioFeatureExtractor(model, state, batch_size=4,
                                     device="cpu").track_logits(
        paths, verbose=False)
    b = tfeats.AudioFeatureExtractor(model, state, batch_size=4,
                                     use_kernels=False,
                                     device="cpu").track_logits(
        paths, verbose=False)
    assert (spectrogram_cuda.launches, max_pool_3x3s2_cuda.launches) == counts
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("feed", list(FEEDS))
def test_extractor_feeds_the_frontend_its_format(slice_setup, monkeypatch,
                                                 feed):
    """Every chunk reaches the frontend in the feed's dtype (uint8 mu-law,
    int16 PCM or float32), whichever reader took it."""
    imdb, _, model, state = slice_setup
    emit, dtype = FEEDS[feed]
    dtypes = []

    def spy(x, cfg):
        dtypes.append(x.dtype)
        return tfeats.spectrogram(x, cfg)

    monkeypatch.setattr(tfeats, "spectrogram_cuda", spy)
    extractor = tfeats.AudioFeatureExtractor(model, state, batch_size=3,
                                             device="cpu", **emit)
    extractor.track_logits([str(p) for p in imdb.wav_paths], verbose=False)
    assert dtypes and set(dtypes) == {dtype}
    assert extractor.readers


def test_feature_cache_roundtrip_and_identity(slice_setup, tmp_path):
    imdb, _, model, state = slice_setup
    feat_path = str(tmp_path / "feats.npz")
    a = tfeats.compute_audio_feats(imdb, model, state, feat_path=feat_path,
                                   batch_size=4, verbose=False, device="cpu")
    # a second call returns the cache, even with another model's weights
    other = {k: torch.zeros_like(v) for k, v in state.items()}
    b = tfeats.compute_audio_feats(imdb, model, other, feat_path=feat_path,
                                   verbose=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the JAX package reads the port's cache and vice versa
    c = jfeats._load_feat_cache(feat_path, len(imdb.wav_paths),
                                "emovoxceleb-student")
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="cached features are from model"):
        tfeats.compute_audio_feats(imdb, model_name="random",
                                   feat_path=feat_path)
    with pytest.raises(ValueError, match="needs a model"):
        tfeats.compute_audio_feats(imdb, feat_path=None)


def test_compute_audio_feats_on_the_cpu_when_asked(slice_setup):
    """device="cpu": the extractor's logits bit for bit, and the JAX
    package's within the parity tolerance."""
    imdb, variables, model, state = slice_setup
    paths = [str(p) for p in imdb.wav_paths]
    got = tfeats.compute_audio_feats(imdb, model, state, batch_size=3,
                                     verbose=False, device="cpu")
    direct = tfeats.AudioFeatureExtractor(model, state, batch_size=3,
                                          device="cpu").track_logits(
        paths, verbose=False)
    jm = JaxVGGM(fc6_features=64, fc7_features=32, dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jfeats.AudioFeatureExtractor(jm, variables, batch_size=3,
                                           use_pallas=False).track_logits(
            paths, verbose=False)
    scale = max(np.abs(r).max() for r in ref)
    for g, d, r in zip(got, direct, ref):
        np.testing.assert_array_equal(g, d)
        assert np.abs(g - r).max() <= 1e-4 * scale


def test_extractor_reads_only_the_state(slice_setup):
    """The forward takes every tensor from ``state``: a model whose own
    tensors have no data gives the same logits, and is not moved."""
    imdb, _, model, state = slice_setup
    paths = [str(p) for p in imdb.wav_paths]
    hollow = build_student(tiny=True, with_frontend=False,
                           dtype=torch.float32).to("meta")
    got = tfeats.AudioFeatureExtractor(hollow, state, batch_size=3,
                                       device="cpu").track_logits(
        paths, verbose=False)
    ref = tfeats.AudioFeatureExtractor(model, state, batch_size=3,
                                       device="cpu").track_logits(
        paths, verbose=False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert all(p.device.type == "meta" for p in hollow.parameters())


def test_extraction_defaults_to_the_card(slice_setup, monkeypatch):
    """The default device is CUDA; without a card it raises instead of
    running on the CPU."""
    import inspect

    imdb, _, model, state = slice_setup
    assert inspect.signature(tfeats.compute_audio_feats).parameters[
        "device"].default == "cuda"
    assert tfeats.AudioFeatureExtractor(model, state).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tfeats.compute_audio_feats(imdb, model, state, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfeats.AudioFeatureExtractor(model, state).track_logits(
            [str(p) for p in imdb.wav_paths], verbose=False)
