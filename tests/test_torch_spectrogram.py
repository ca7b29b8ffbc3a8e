"""Port parity: the PyTorch spectrogram frontend against the JAX package.

The same numpy inputs (from a seed) go through both packages. On the CPU
the K1 wrapper runs its plain version; the JAX Pallas kernel runs in
interpret mode, as tests/test_spectrogram.py runs it. The frontend's
helpers (``frame_signal``, ``dft_matrices`` with and without the window,
``spectrogram_frames``) are held to JAX's too.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.ops.pallas_spectrogram import spectrogram_pallas
from mcncrossmodalemotions_torch.ops import spectrogram_kernel
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    decode_pcm,
    dft_matrices,
    frame_signal,
    hamming,
    instance_norm,
    spectrogram,
    spectrogram_frames,
    waveform_to_input,
)

jspec = importlib.import_module("mcncrossmodalemotions_tpu.ops.spectrogram")


def golden_spectrogram(x: np.ndarray, cfg=DEFAULT_SPEC) -> np.ndarray:
    """float64 runSpec: preemphasis, frames, Hamming, |fft(., 512)|."""
    xe = np.concatenate([x[..., :1], x[..., 1:] - cfg.preemph * x[..., :-1]],
                        axis=-1).astype(np.float64)
    t = cfg.num_frames(x.shape[-1])
    frames = np.stack([xe[..., i * cfg.hop_length:
                          i * cfg.hop_length + cfg.win_length]
                       for i in range(t)], axis=-2)
    mag = np.abs(np.fft.fft(frames * hamming(cfg.win_length, np.float64),
                            cfg.nfft, axis=-1))
    return np.swapaxes(mag, -1, -2)


@pytest.mark.parametrize("frames", [256, 150, 33])
def test_spectrogram_matches_jax_and_pallas(frames):
    """T=256 is a whole number of Pallas tiles, T=150 is not; T=33 is one
    frame past two tiles of the CUDA kernel (16 frames). On a CPU tensor
    the kernel's wrapper runs the plain frontend."""
    rng = np.random.RandomState(frames)
    x = rng.randn(1, DEFAULT_SPEC.crop_samples(frames)).astype(np.float32)
    got = spectrogram_kernel.spectrogram_cuda(torch.from_numpy(x)).numpy()
    pallas = np.asarray(spectrogram_pallas(jnp.asarray(x), interpret=True))
    plain = np.asarray(jspec.spectrogram(jnp.asarray(x)))
    assert got.shape == pallas.shape == plain.shape == (1, 512, frames)
    np.testing.assert_allclose(got, pallas, atol=5e-4)
    np.testing.assert_allclose(got, plain, atol=5e-4)


@pytest.mark.parametrize("shape,win,hop", [((2, 3, 1600), 400, 160),
                                           ((1999,), 400, 160),
                                           ((2, 560), 400, 160),
                                           ((3, 17), 5, 3),
                                           ((2, 399), 400, 160),
                                           ((2, 100), 400, 160)])
def test_frame_signal_matches_jax(shape, win, hop):
    """Floor framing bitwise, down to no frame at all (N < win)."""
    x = np.random.RandomState(len(shape) + shape[-1]).randn(*shape).astype(
        np.float32)
    got = frame_signal(torch.from_numpy(x), win, hop).numpy()
    ref = np.asarray(jspec.frame_signal(jnp.asarray(x), win, hop))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("win,nfft", [(400, 512), (256, 256), (7, 16)])
def test_dft_matrices_match_jax(windowed, win, nfft):
    """Built in float64 and cast once in both packages: bitwise equal."""
    got = dft_matrices(win, nfft, windowed=windowed, device="cpu")
    ref = jspec.dft_matrices(win, nfft, windowed=windowed)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (win, nfft // 2 + 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if windowed:  # the window folded in: row i scaled by hamming(win)[i]
        plain = dft_matrices(win, nfft, windowed=False, device="cpu")
        np.testing.assert_allclose(
            got[0].numpy(), plain[0].numpy() * hamming(win)[:, None],
            rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        dft_matrices(nfft + 1, nfft, windowed=windowed, device="cpu")


@pytest.mark.parametrize("frames", [150, 33])
def test_spectrogram_frames_matches_jax(frames):
    """Time-major magnitudes [..., T, nfft], two leading axes."""
    rng = np.random.RandomState(frames + 1)
    x = rng.randn(2, 1, DEFAULT_SPEC.crop_samples(frames)).astype(np.float32)
    got = spectrogram_frames(torch.from_numpy(x)).numpy()
    ref = np.asarray(jspec.spectrogram_frames(jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 1, frames, 512)
    np.testing.assert_allclose(got, ref, atol=5e-4)


@pytest.mark.parametrize("frames", [400, 150])
def test_spectrogram_matches_float64_golden(frames):
    rng = np.random.RandomState(7)
    x = rng.randn(2, DEFAULT_SPEC.crop_samples(frames)).astype(np.float32)
    got = spectrogram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, golden_spectrogram(x), atol=5e-4)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
def test_decode_pcm_matches_jax(dtype):
    info = np.iinfo(dtype)
    x = np.random.RandomState(1).randint(info.min, info.max + 1, (3, 257),
                                         dtype=np.int64).astype(dtype)
    x[0, :4] = [info.min, info.max, 0, 1]
    got = decode_pcm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jspec.decode_pcm(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
def test_packed_feed_spectrogram_matches_jax(dtype):
    """The compact feeds decode inside the frontend in both packages."""
    info = np.iinfo(dtype)
    x = np.random.RandomState(2).randint(
        info.min, info.max + 1, (1, DEFAULT_SPEC.crop_samples(120)),
        dtype=np.int64).astype(dtype)
    got = spectrogram(torch.from_numpy(x)).numpy()
    ref = np.asarray(jspec.spectrogram(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_instance_norm_masked_matches_jax():
    rng = np.random.RandomState(3)
    spec = (rng.rand(3, 16, 50) * 10).astype(np.float32)
    valid = np.array([50, 30, 1], np.int32)
    for vf in (None, valid):
        got = instance_norm(torch.from_numpy(spec), valid_frames=(
            None if vf is None else torch.from_numpy(vf))).numpy()
        ref = np.asarray(jspec.instance_norm(jnp.asarray(spec), valid_frames=vf))
        np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(got[1, :, 30:] == 0)


def test_waveform_to_input_matches_jax():
    """Max abs error <= 1e-3, the bench's frontend numerics gate."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, DEFAULT_SPEC.crop_samples(200)).astype(np.float32)
    valid = np.array([200, 130], np.int32)
    for vf in (None, valid):
        got = waveform_to_input(torch.from_numpy(x), valid_frames=(
            None if vf is None else torch.from_numpy(vf))).numpy()
        ref = np.asarray(jspec.waveform_to_input(jnp.asarray(x),
                                                 valid_frames=vf))
        assert got.shape == ref.shape == (2, 512, 200, 1)
        assert np.abs(got - ref).max() <= 1e-3


def test_config_constants_match_jax():
    from mcncrossmodalemotions_tpu import EMOTIONS, NUM_EMOTIONS
    from mcncrossmodalemotions_tpu.data.emovox import MAX_CLIP_SECONDS
    from mcncrossmodalemotions_tpu.exp import compute_audio_feats as jfeats
    import mcncrossmodalemotions_torch as port
    from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats

    cfg, ref = DEFAULT_SPEC, jspec.DEFAULT_SPEC
    for field in ("sample_rate", "window_ms", "hop_ms", "preemph", "nfft"):
        assert getattr(cfg, field) == getattr(ref, field)
    for prop in ("win_length", "hop_length", "num_rbins"):
        assert getattr(cfg, prop) == getattr(ref, prop)
    for n in (0, 399, 400, 64384, 176384):
        assert cfg.num_frames(n) == ref.num_frames(n)
    for t in (100, 400, 1000, 2000):
        assert cfg.crop_samples(t) == ref.crop_samples(t)
    np.testing.assert_array_equal(hamming(400), jspec.hamming(400))
    with pytest.raises(ValueError):
        SpecConfig(nfft=256)
    assert tfeats.MAX_CLIP_SECONDS == MAX_CLIP_SECONDS
    assert tfeats.BUCKET_WIDTHS == jfeats.BUCKET_WIDTHS
    assert tfeats.MAX_EVAL_FRAMES == jfeats.MAX_EVAL_FRAMES
    assert port.EMOTIONS == EMOTIONS and port.NUM_EMOTIONS == NUM_EMOTIONS


def test_spectrogram_cuda_wrapper_takes_plain_path_on_cpu():
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, DEFAULT_SPEC.crop_samples(130)).astype(np.float32))
    before = spectrogram_kernel.spectrogram_cuda.launches
    got = spectrogram_kernel.spectrogram_cuda(x)
    assert spectrogram_kernel.spectrogram_cuda.launches == before
    torch.testing.assert_close(got, spectrogram(x), rtol=0, atol=0)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        spectrogram_kernel.spectrogram_cuda(x.to("meta"))
