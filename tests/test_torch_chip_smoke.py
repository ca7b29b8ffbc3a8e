"""What of ``chip_smoke.py`` and the extraction profiler a CPU can check.

- The pool shapes chip_smoke holds K2 at are the inputs the student hands
  pool1 and pool2 at each of the smoke's buckets.
- Without a CUDA device, in the repo or alone in a directory, chip_smoke
  exits non-zero and prints no result.
- The profiler's device busy time is the union of the device intervals.
- ``data.synthetic_track_imdb``'s defaults (the smoke's traffic) span the
  100-, 400- and 1000-frame buckets.
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
