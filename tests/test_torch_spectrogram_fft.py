"""K1's FFT schedule, rendered in numpy on the CPU.

``csrc/spectrogram.cu`` cannot run here, so ``render_k1`` repeats its
schedule in float32 with its own host tables (``fft_tables_np``): the
tile of FT frames and its zero-filled span, the packing of a frame into
z[n] = v[2n] + j v[2n+1] lane by lane, the two 16-point DFTs with the
kernel's radix-4 x 4 order and digit transpose, the W256 twiddles, the
exchange buffer's row stride, the post-processing pass over bin pairs
(k, 256 - k) and the mirrored store. An index fault in that schedule
shows here as a disagreement with the plain frontend (within 1e-5 of its
max: fp32 order only) or with the float64 FFT (atol 5e-4, as
tests/test_torch_spectrogram.py holds the plain frontend).
"""

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    hamming,
    spectrogram,
)
from mcncrossmodalemotions_torch.ops.spectrogram_kernel import fft_tables_np
from tests.test_torch_spectrogram import golden_spectrogram

FT, R, ROW = 16, 16, 17  # frames per block, 256 = R x R, exchange row stride
HALF = 256


def rev4(k):
    """Where dft16 leaves X[k]."""
    return 4 * (k & 3) + (k >> 2)


def dft4(a0, a1, a2, a3):
    s02, d02, s13, d13 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    mj = np.complex64(-1j)
    return s02 + s13, d02 + mj * d13, s02 - s13, d02 - mj * d13


def dft16(v, w16):
    """The kernel's dft16 over the last axis: X[k] left at [..., rev4(k)]."""
    v = v.copy()
    for b in range(4):
        (v[..., b], v[..., 4 + b], v[..., 8 + b],
         v[..., 12 + b]) = dft4(v[..., b], v[..., 4 + b], v[..., 8 + b],
                                v[..., 12 + b])
    for c in range(1, 4):
        for b in range(1, 4):
            v[..., 4 * c + b] *= w16[b * c]
    for c in range(4):
        q = slice(4 * c, 4 * c + 4)
        v[..., q] = np.stack(dft4(*np.moveaxis(v[..., q], -1, 0)), axis=-1)
    return v


def complex_table(pairs):
    return (pairs[:, 0] + np.complex64(1j) * pairs[:, 1]).astype(np.complex64)


def render_k1(x, cfg=DEFAULT_SPEC):
    """[B, N] float32 or int16 rows -> [B, 512, T], as the kernel runs."""
    window, tw, post = fft_tables_np(cfg.win_length, cfg.nfft)
    tw, post = complex_table(tw), complex_table(post)
    w16 = tw[R * np.arange(10)]
    win, hop, alpha = cfg.win_length, cfg.hop_length, np.float32(cfg.preemph)
    if x.dtype == np.int16:
        x = x.astype(np.float32) * np.float32(1.0 / 32768.0)
    bsz, n = x.shape
    t_frames = cfg.num_frames(n)
    span = (FT - 1) * hop + win
    out = np.full((bsz, cfg.nfft, t_frames), np.nan, np.float32)
    lane = np.arange(R)
    k = np.arange(R)
    for t0 in range(0, t_frames, FT):
        # the span, pre-emphasised as it is loaded; zeros past the end
        s = t0 * hop + np.arange(span)
        cur = np.where(s < n, x[:, np.minimum(s, n - 1)], 0).astype(np.float32)
        prev = x[:, np.clip(s - 1, 0, n - 1)]
        ys = np.where((s > 0) & (s < n), cur - alpha * prev, cur).astype(np.float32)
        # step 1: lane l of frame f holds z[16 n1 + l] = v[i] + j v[i + 1]
        i = 2 * (R * np.arange(R)[None, :] + lane[:, None])      # [l, n1]
        inside = i < win
        ic = np.where(inside, i, 0)
        at = np.arange(FT)[:, None, None] * hop + ic              # [f, l, n1]
        re = np.where(inside, ys[:, at] * window[ic], 0).astype(np.float32)
        im = np.where(inside, ys[:, at + 1] * window[ic + 1], 0).astype(np.float32)
        v = dft16((re + np.complex64(1j) * im).astype(np.complex64), w16)
        y1 = v[..., rev4(k)]                                       # [B, f, l, k1]
        y1[..., 1:] *= tw[lane[:, None] * k[None, 1:]]
        xf = np.zeros((bsz, FT, R * ROW), np.complex64)
        xf[..., k[None, :] * ROW + lane[:, None]] = y1
        # step 2: lane l reads row l of the exchange buffer
        v = dft16(xf[..., lane[:, None] * ROW + k[None, :]], w16)
        zb = np.zeros((bsz, FT, HALF), np.complex64)
        zb[..., lane[:, None] + R * k[None, :]] = v[..., rev4(k)]
        # post-processing: lane l takes the pairs k = l + 16 m, m < 8, and
        # lane 0 bin 128: X[k] = E + O, X[256 - k] = conj(E - O)
        kk = np.arange(HALF // 2 + 1)
        a, c = zb[..., kk], zb[..., (HALF - kk) & (HALF - 1)]
        e = np.float32(0.5) * (a + np.conj(c))
        o = np.complex64(-1j) * (np.float32(0.5) * (a - np.conj(c))) * post
        mag = np.empty((bsz, FT, HALF + 1), np.float32)
        mag[..., HALF - kk] = np.abs(e - o)
        mag[..., kk] = np.abs(e + o)
        # the store: row r from staging row r or 512 - r, frames < T only
        rows = np.arange(cfg.nfft)
        src = np.where(rows <= HALF, rows, cfg.nfft - rows)
        valid = min(FT, t_frames - t0)
        out[:, :, t0:t0 + valid] = np.swapaxes(mag, 1, 2)[:, src, :valid]
    return out


def _rows(frames, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, DEFAULT_SPEC.crop_samples(frames)).astype(np.float32) * 0.3
    if dtype == np.int16:
        return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
    return x


def test_fft_tables_are_float64_cast_to_float32():
    window, tw, post = fft_tables_np(400, 512)
    assert window.dtype == tw.dtype == post.dtype == np.float32
    assert window.shape == (400,) and tw.shape == (256, 2) and post.shape == (129, 2)
    np.testing.assert_array_equal(window, hamming(400))
    m = np.arange(256)
    np.testing.assert_array_equal(
        tw, np.stack([np.cos(-2 * np.pi * m / 256),
                      np.sin(-2 * np.pi * m / 256)], -1).astype(np.float32))
    np.testing.assert_array_equal(tw[R * np.arange(5)], post[::32])  # W16^m
    assert post[0].tolist() == [1.0, 0.0] and post[128, 1] == -1.0


def test_dft16_is_a_16_point_dft():
    """The radix-4 x 4 order and its digit transpose, on random values."""
    _, tw, _ = fft_tables_np(400, 512)
    rng = np.random.RandomState(0)
    z = (rng.randn(5, 16) + 1j * rng.randn(5, 16)).astype(np.complex64)
    got = dft16(z, complex_table(tw)[R * np.arange(10)])[:, rev4(np.arange(16))]
    np.testing.assert_allclose(got, np.fft.fft(z.astype(np.complex128)),
                               atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("frames", [1, 31, 32, 33, 400])
def test_kernel_schedule_matches_plain_and_golden(frames, dtype):
    """One frame, two tiles but one, two tiles, one frame past them, and
    the train crop (25 tiles)."""
    x = _rows(frames, dtype, frames)
    got = render_k1(x)
    plain = spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == plain.shape == (2, 512, frames)
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()
    xf = x.astype(np.float32) / 32768.0 if dtype == np.int16 else x
    np.testing.assert_allclose(got, golden_spectrogram(xf), atol=5e-4)
