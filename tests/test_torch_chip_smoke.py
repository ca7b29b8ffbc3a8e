"""What of ``chip_smoke.py`` and the extraction profiler a CPU can check.

- The pool shapes chip_smoke holds K2 at are the inputs the student hands
  pool1 and pool2 at each of the smoke's buckets.
- Without a CUDA device, in the repo or alone in a directory, chip_smoke
  exits non-zero and prints no result.
- The profiler's device busy time is the union of the device intervals.
- ``data.synthetic_track_imdb``'s defaults (the smoke's traffic) span the
  100-, 400- and 1000-frame buckets.
- The library call timed beside K1 (``torch.stft``) frames K1's samples
  and gives the plain frontend's magnitudes; the bound and the probes'
  byte counts are what the shapes say.
"""

import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import chip_smoke
from mcncrossmodalemotions_torch.data import synthetic_track_imdb
from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
    AudioFeatureExtractor,
)
from mcncrossmodalemotions_torch.exp.profile_extraction import busy_us
from mcncrossmodalemotions_torch.models import vggm
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    preemphasis,
    spectrogram,
)
from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2

REPO = Path(__file__).resolve().parent.parent


class _Stop(Exception):
    pass


@pytest.mark.parametrize("bucket", [100, 400, 1000])
def test_pool_inputs_are_the_students(monkeypatch, bucket):
    seen = []

    def spy(x):
        seen.append(tuple(x.shape))
        if len(seen) == 2:
            raise _Stop  # pool2 reached: the rest of the net is not needed
        return vggm.max_pool_3x3s2(x)

    monkeypatch.setattr(vggm, "max_pool_3x3s2_cuda", spy)
    model = vggm.VGGMStudent(fc6_features=8, fc7_features=4,
                             dtype=torch.float32).eval()
    with torch.inference_mode(), pytest.raises(_Stop):
        model(torch.zeros(3, 512, bucket, 1))
    want = chip_smoke.pool_inputs(3, bucket, 512)
    assert seen == [want["pool1"], want["pool2"]]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_cuda_device(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_busy_us_is_the_union_of_device_intervals():
    def ev(start, end, device_type=DeviceType.CUDA):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                               device_type=device_type)

    events = [ev(20, 25), ev(0, 10), ev(5, 12), ev(21, 22),
              ev(0, 100, DeviceType.CPU)]
    assert busy_us(events) == 12 + 5
    assert busy_us([]) == 0


def test_synthetic_imdb_defaults_span_the_smoke_buckets(tmp_path):
    imdb = synthetic_track_imdb(tmp_path, tracks_per_class=1)
    probe = AudioFeatureExtractor(None, {})
    assert len(imdb.wav_paths) == 6 * 3
    assert sorted({probe._meta(str(p))[1:3] for p in imdb.wav_paths}) == [
        (100, 200), (400, 500), (1000, 1100)]


@pytest.mark.parametrize("frames", [1, 37, 400])
def test_stft_call_gives_the_plain_frontends_magnitudes(frames):
    """Misframed by the window's centring (56 samples), the magnitudes
    would differ by far more than fp32 order."""
    cfg = DEFAULT_SPEC
    gen = torch.Generator().manual_seed(frames)
    x = (torch.randn(2, cfg.crop_samples(frames), generator=gen) * 8000).round()
    x = x.to(torch.int16)
    mag = chip_smoke.stft_call(preemphasis(x, cfg.preemph), cfg)()
    ref = spectrogram(x, cfg)[:, :cfg.num_rbins]
    assert mag.shape == ref.shape == (2, cfg.num_rbins, frames)
    assert (mag - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_bound_is_the_larger_of_bytes_and_operations():
    assert chip_smoke.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert chip_smoke.bound_ms(3.35e9, 134e9) == (2.0, "operations")


def test_k1_bound_counts_an_ffts_operations():
    """K1's least work is an FFT a frame, so at the train crop its bound
    is the bytes it moves; a DFT computed as a product would be bound by
    its operations instead."""
    cfg = DEFAULT_SPEC
    rows, frames = 128, 400
    fft, dft = chip_smoke.spectrogram_ops(rows * frames, cfg)
    assert fft == rows * frames * 5 * 512 * 9
    assert dft == rows * frames * 2 * 400 * 2 * 257
    nbytes = 2 * rows * cfg.crop_samples(frames) + 4 * rows * 512 * frames
    assert chip_smoke.bound_ms(nbytes, fft)[1] == "bytes"
    assert chip_smoke.bound_ms(nbytes, dft)[1] == "operations"


def test_probe_work_counts_the_probes_bytes():
    cpu = torch.device("cpu")
    work = {p.name.split()[0]: chip_smoke.probe_work(p)
            for p in probe_mosaic.make_probes(cpu) + probe_mosaic2.make_probes(cpu)}
    # P1: half of x2's 256 columns read, 256 int32 indices, [16, 256] out
    assert work["P1"] == (4 * 16 * 128 + 4 * 256 + 4 * 16 * 256, 0)
    assert work["P9"] == (4 * (16 * 128 + 128 * 256 + 16 * 256),
                          2 * 16 * 128 * 256)
    # P4b reads bf16, 2 bytes an element, in 99 of the 100 candidate
    # columns: the repeat cut to 197 drops the last
    assert work["P4b"] == (2 * 16 * 99 * 96 + 4 * 197 + 4 * 16 * 197 * 96, 0)
    assert work["P12"] == (4 * (2 * 16 * 197 * 96 + 2 * 16 * 100 * 96),
                           5 * 16 * 197 * 96)
