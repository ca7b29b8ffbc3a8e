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
- The teacher release chip_smoke writes (conv biases, BN means moved by
  them, the VGGFace2 mean) loads to what its seeded weights compute, its
  dense tree gives every smoke track its fixture frames, and its teacher
  phase rehearses on the CPU: the golden gates at full width, the dense
  build, its resume and an epoch at tiny sizes.
- The teacher-train phase rehearses on the CPU: ``ferplus_baselines``,
  its resume, eval-only and benchmark at tiny width, a classic vgg-m-face-bn
  base written by ``classic_release`` (full width at 48x48) imported to its
  seeded weights and fine-tuned, the profiled epoch and the train steps of
  the four timed teachers with their FLOP count (the golden gates run on
  the CPU in ``test_torch_teacher_train.py``); it runs after ``teacher``.
- The online phase rehearses on the CPU at tiny sizes on the teacher
  phase's outputs; it runs after ``teacher-train``, its counts join the
  kernel line's, and the script's last line is the device line alone.
- The verify phase rehearses on the CPU on tiny releases and a dense imdb
  (the release tree, ``verify_release`` against the README table and the
  measured accuracies, the probe on both devices, the three broken trees,
  the CLI in a subprocess and ``audio-feats`` in process); it runs after
  ``online`` and before ``probes``, its counts join the kernel line's, and
  a failed gate in it ends the run (no phase is wrapped in a handler).
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
    # within a window: the intervals clipped to it, those outside dropped
    assert busy_us(events, window=(8, 24)) == 4 + 4
    assert busy_us(events, window=(13, 19)) == 0


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


@pytest.mark.parametrize("use_se", [False, True])
def test_teacher_release_loads_to_its_seeded_weights(tmp_path, use_se):
    import numpy as np

    from mcncrossmodalemotions_torch.models.resnet import ResNet
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        VGGFACE2_MEAN_RGB,
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_teacher,
        teacher_state_dict_from_flax,
    )

    v = chip_smoke.teacher_release(tmp_path / "t.mat", use_se=use_se,
                                   stage_sizes=(2, 1), width=8)
    model, state = load_pretrained_teacher(tmp_path / "t.mat",
                                           with_pipeline=True, input_size=48,
                                           device="cpu")
    model.teacher.dtype = torch.float32  # bf16 compute by default
    np.testing.assert_allclose(model.mean_rgb, VGGFACE2_MEAN_RGB, rtol=1e-6)
    plain = FaceTeacherPipeline(ResNet(use_se=use_se, stage_sizes=(2, 1),
                                       width=8, dtype=torch.float32),
                                input_size=48, mean_rgb=model.mean_rgb)
    plain.load_state_dict(teacher_state_dict_from_flax(
        {"params": {"teacher": v["params"]},
         "batch_stats": {"teacher": v["batch_stats"]}}))
    x = torch.randint(0, 256, (3, 40, 40, 1), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, ref = model(x), plain.eval()(x)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_dense_tree_gives_every_track_its_frames(tmp_path):
    imdb = synthetic_track_imdb(tmp_path / "tracks", durations=(1.0,),
                                tracks_per_class=3)
    wavs = chip_smoke.imdb_paths(imdb)
    speakers = chip_smoke.dense_tree(tmp_path / "vox", wavs, 5)
    assert speakers == [f"spk{i:03d}" for i in range(8)]
    frames = sorted((tmp_path / "vox" / "frames").rglob("*.jpg"))
    assert len(frames) == 5 * len(wavs)
    assert len(list((tmp_path / "vox" / "wavs").rglob("*.wav"))) == len(wavs)
    assert {f.resolve().parent for f in frames} == {chip_smoke.FACES.resolve()}


def test_teacher_phase_rehearses_on_the_cpu(tmp_path):
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    imdb = synthetic_track_imdb(tmp_path / "tracks", durations=(1.5, 4.1),
                                tracks_per_class=2)
    wrappers = {"spectrogram": spectrogram_cuda,
                "max_pool_3x3s2_idx": pool.max_pool_3x3s2_idx_cuda}
    counts, dense = chip_smoke.teacher_phase("cpu", tmp_path,
                                             chip_smoke.imdb_paths(imdb),
                                             wrappers, dev="cpu")
    assert counts == {"spectrogram": 0, "max_pool_3x3s2_idx": 0}  # CPU tensors
    assert len(dense.dense_frames) == len(imdb.wav_paths)
    assert (tmp_path / "dense.mat").is_file()  # the online phase's teacher


def test_online_phase_rehearses_on_the_cpu(tmp_path):
    """The online phase on the teacher phase's outputs at tiny sizes: a
    tiny SENet ``dense.mat``, its dense imdb over the fixture frames, the
    distill phase's synthetic imdb; the fused step against the offline
    one, the online driver with its resume and frame check, the three feed
    options with the library-vs-Python check, two remat policies."""
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.data.imdb import SET_UNHEARD_VAL
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    torch.set_num_threads(2)
    tracks = synthetic_track_imdb(tmp_path / "tracks", durations=(1.5,),
                                  tracks_per_class=2)
    chip_smoke.teacher_release(tmp_path / "dense.mat", stage_sizes=(1, 1),
                               width=8)
    model, state = load_pretrained_teacher(tmp_path / "dense.mat",
                                           with_pipeline=True, device="cpu")
    speakers = chip_smoke.dense_tree(tmp_path / "vox",
                                     chip_smoke.imdb_paths(tracks), 3)
    dense = build_imdb(tmp_path / "vox", model, state, batch_size=8,
                       set_assignment={speakers[-1]: SET_UNHEARD_VAL},
                       verbose=False, device="cpu")
    distill = build_synthetic_imdb(tmp_path / "wav", num_speakers=3,
                                   tracks_per_speaker=4,
                                   duration_range=(1.2, 2.0))
    wrappers = {"spectrogram": spectrogram_cuda,
                "max_pool_3x3s2_idx": pool.max_pool_3x3s2_idx_cuda}
    counts = chip_smoke.online_phase("cpu", tmp_path, dense, distill,
                                     wrappers, dev="cpu")
    assert counts == {"spectrogram": 0, "max_pool_3x3s2_idx": 0}



def test_teacher_train_phase_rehearses_on_the_cpu(tmp_path):
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    torch.set_num_threads(2)
    wrappers = {"spectrogram": spectrogram_cuda,
                "max_pool_3x3s2_idx": pool.max_pool_3x3s2_idx_cuda}
    counts = chip_smoke.teacher_train_phase("cpu", tmp_path, wrappers,
                                            dev="cpu")
    assert counts == {"spectrogram": 0, "max_pool_3x3s2_idx": 0}


def _verify_inputs(tmp_path):
    """Tiny stand-ins for what the verify phase takes from earlier phases:
    the release phase's student, the teacher phase's two teachers and its
    dense imdb."""
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    torch.set_num_threads(2)
    tracks = synthetic_track_imdb(tmp_path / "tracks", durations=(1.5, 4.1),
                                  tracks_per_class=1)
    student = tmp_path / "emovoxceleb-student.mat"
    chip_smoke.student_release(student, fc6=64, fc7=32)
    teachers = {}
    for arch, use_se in (("senet50", True), ("resnet50", False)):
        teachers[f"{arch}-ferplus"] = tmp_path / f"{arch}-release.mat"
        chip_smoke.teacher_release(teachers[f"{arch}-ferplus"], use_se=use_se,
                                   stage_sizes=(1, 1), width=8)
    model, state = load_pretrained_teacher(teachers["senet50-ferplus"],
                                           with_pipeline=True, device="cpu")
    chip_smoke.dense_tree(tmp_path / "vox", chip_smoke.imdb_paths(tracks), 2)
    dense = build_imdb(tmp_path / "vox", model, state, batch_size=8,
                       verbose=False, device="cpu")
    return dense, student, teachers


def _wrappers():
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    return {"spectrogram": spectrogram_cuda,
            "max_pool_3x3s2": pool.max_pool_3x3s2_cuda}


def test_verify_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "cache"))
    dense, student, teachers = _verify_inputs(tmp_path)
    counts = chip_smoke.verify_phase("cpu", tmp_path, dense, _wrappers(),
                                     student, teachers, dev="cpu")
    assert counts == {"spectrogram": 0, "max_pool_3x3s2": 0}  # CPU tensors
    assert (tmp_path / "verify-measured" / "verify-release.json").is_file()
    assert (tmp_path / "release-tree" / "model" /
            "senet50-ferplus.mat").samefile(teachers["senet50-ferplus"])


def test_verify_phase_failures_propagate(tmp_path, monkeypatch):
    """A failed gate in the verify phase raises SmokeFailure out of it."""
    from mcncrossmodalemotions_torch.exp import verify_release

    dense, student, teachers = _verify_inputs(tmp_path)
    monkeypatch.setattr(verify_release, "verify_release",
                        lambda **kw: {"pass": False, "failed": ["artifacts"],
                                      "stages": {"ferplus_accuracy": {}}})
    with pytest.raises(chip_smoke.SmokeFailure, match="README table"):
        chip_smoke.verify_phase("cpu", tmp_path, dense, _wrappers(), student,
                                teachers, dev="cpu")


def test_phases_in_order_and_the_last_line():
    """teacher-train runs after teacher, online after it, verify after
    online and before probes, their counts join the kernel line's
    launches, no phase runs inside an exception handler, and the device
    line is printed last."""
    import ast

    src = (REPO / "chip_smoke.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [c.args[0].value for c in ast.walk(main)
              if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "phase"]
    assert phases == ["device", "build", "data", "k1", "k2", "slice",
                      "k2-backward", "train", "distill", "reader", "release",
                      "analysis", "teacher", "teacher-train", "online",
                      "verify", "probes"]
    for counts in ("teacher_train_counts", "online_counts", "verify_counts"):
        assert f"{counts}[name]" in ast.get_source_segment(src, main)
    assert not [n for n in ast.walk(main) if isinstance(n, ast.Try)]
    last = ast.get_source_segment(src, main).rstrip().splitlines()[-5:]
    assert 'json.dumps({"ok": True, "device": {' in "\n".join(last)
