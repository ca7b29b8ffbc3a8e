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
- The ddp phase rehearses on the CPU at tiny sizes, its ranks being the
  script itself started as workers; it runs after ``verify`` and before
  ``probes``, and its counts join the kernel line's.
- The dense-chunked phase rehearses on the CPU at tiny sizes (the
  bounded-worker build bitwise one process's, the soak's three builds);
  it runs after ``ddp`` and before ``probes``, and its counts join the
  kernel line's.
- The teacher-epilogue phase rehearses on the CPU at small shapes (the
  plain versions against themselves, the byte counts of its bounds); it
  runs after ``probes``.
- The bench phase passes a bench run whose details hold every key of the
  JAX bench's ``--full`` run with ``numerics_ok`` true, and fails one that
  exits non-zero, lacks a key or fails its numerics (the bench itself is
  tested in ``test_torch_bench.py``); the demo phase rehearses on the CPU
  at tiny sizes. Both run after ``dense-chunked`` and before ``probes``,
  and the demo's counts join the kernel line's.
- The studies phase rehearses on the CPU at small sizes, its
  one-form-a-process studies run in this process in place of their
  processes, and fails a study process that exits non-zero; the step
  studies' launches on the card are those of their steps. The workflow
  phase holds the worked example's run (``test_torch_full_workflow.py``)
  to its gates. Both run after ``demo`` and before ``probes``, and their
  counts join the kernel line's.
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
from mcncrossmodalemotions_torch.ops import probes
from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2, time_probes

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
    work = {p.name.split()[0]: time_probes.probe_work(p)
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


def test_probe_path_cases_take_the_paths_they_name():
    """The probes phase's extra gates: on the CPU the wrappers take their
    plain versions, and each case's own pointers and shapes give the path
    the gate expects of the card (the misaligned views are one element
    into their buffers)."""
    cases = chip_smoke.probe_path_cases(torch.device("cpu"))
    for label, kernel, plain, args, want in cases:
        if kernel is probes.probe_gather:
            x, index, axis = args
            outer, inner = probes.gather_dims(x.shape, axis)
            got = probes.gather_route(x.data_ptr(), 0, x.element_size(), outer,
                                      index.n_in, index.values.numel(), inner)
        else:
            x, y, dy = args
            got = probes.col_candidates_route(
                x.data_ptr(), y.data_ptr(), dy.data_ptr(), 0, *x.shape[:2],
                y.shape[1], x.shape[2])
            assert (x.shape[1] + 1) // 2 + 1 <= y.shape[1], label
        assert got == want, label
        assert torch.equal(kernel(*args), plain(*args)), label
    assert [want.vec for *_, want in cases] == [1, 1, 1, 1, 4, 4, 1, 1, 1]


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


def test_ddp_phase_rehearses_on_the_cpu(tmp_path):
    """The ddp phase at tiny sizes on a tiny teacher release and its dense
    imdb: the one-process student steps, then two gloo ranks of the script
    itself (``--ddp-worker``): student and online steps bitwise equal on
    the ranks and within the loss gate of one process, the dense logits
    gathered to both ranks, and the 1-rank group (gloo on the CPU)."""
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    torch.set_num_threads(2)
    tracks = synthetic_track_imdb(tmp_path / "tracks", durations=(1.5,),
                                  tracks_per_class=1)
    chip_smoke.teacher_release(tmp_path / "dense.mat", stage_sizes=(1, 1),
                               width=8)
    model, state = load_pretrained_teacher(tmp_path / "dense.mat",
                                           with_pipeline=True, device="cpu")
    chip_smoke.dense_tree(tmp_path / "vox", chip_smoke.imdb_paths(tracks), 3)
    dense = build_imdb(tmp_path / "vox", model, state, batch_size=8,
                       verbose=False, device="cpu")
    wrappers = chip_smoke.KERNEL_NAMES
    counts = chip_smoke.ddp_phase("cpu", tmp_path, dense, wrappers, dev="cpu")
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    assert len(list(tmp_path.glob("ddp-gloo-2-*.json"))) == 2


def test_dense_chunked_phase_rehearses_on_the_cpu(tmp_path):
    """The dense-chunked phase at tiny sizes on a tiny teacher release and
    its dense imdb: the bounded-worker build in 2 worker processes bitwise
    the one-process imdb, then the soak with a tiny SENet at batch 1 (640
    batches: the kill at batch 200 lands well inside the run), its resume
    bitwise the clean build."""
    from mcncrossmodalemotions_torch.data.imdb import SET_UNHEARD_VAL
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    torch.set_num_threads(2)
    tracks = synthetic_track_imdb(tmp_path / "tracks", durations=(1.5,),
                                  tracks_per_class=1)
    chip_smoke.teacher_release(tmp_path / "dense.mat", stage_sizes=(1, 1),
                               width=8)
    model, state = load_pretrained_teacher(tmp_path / "dense.mat",
                                           with_pipeline=True, device="cpu")
    speakers = chip_smoke.dense_tree(tmp_path / "vox",
                                     chip_smoke.imdb_paths(tracks), 3)
    dense = build_imdb(tmp_path / "vox", model, state, batch_size=8,
                       set_assignment={speakers[-1]: SET_UNHEARD_VAL},
                       verbose=False, device="cpu")
    assert sum(len(f) for f in dense.dense_frames) == 18  # 2 workers: 16, 2
    wrappers = chip_smoke.KERNEL_NAMES
    counts = chip_smoke.dense_chunked_phase("cpu", tmp_path, dense, wrappers,
                                            dev="cpu")
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    assert not list(tmp_path.glob("chunked.partial*"))
    assert (tmp_path / "soak" / "imdb_soak.npz").is_file()


def test_phases_in_order_and_the_last_line():
    """teacher-train runs after teacher, online after it, verify after
    online, ddp after verify, dense-chunked after ddp, bench and demo after
    it, studies, workflow and graft after demo and before probes, the
    teacher epilogues after probes, the student's train BatchNorm last,
    their counts join the kernel line's launches, no phase runs inside an
    exception handler, and the device line is printed last."""
    import ast

    src = (REPO / "chip_smoke.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [c.args[0].value for c in ast.walk(main)
              if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "phase"]
    assert phases == ["device", "build", "data", "k1", "k2", "slice",
                      "k2-backward", "train", "distill", "reader", "release",
                      "analysis", "teacher", "teacher-train", "online",
                      "verify", "ddp", "dense-chunked", "bench", "demo",
                      "studies", "workflow", "graft", "probes",
                      "teacher-epilogue", "train-bn"]
    for counts in ("teacher_train_counts", "online_counts", "verify_counts",
                   "ddp_counts", "dense_chunked_counts", "demo_counts",
                   "studies_counts", "workflow_counts", "graft_counts"):
        assert f"{counts}[name]" in ast.get_source_segment(src, main)
    assert not [n for n in ast.walk(main) if isinstance(n, ast.Try)]
    last = ast.get_source_segment(src, main).rstrip().splitlines()[-5:]
    assert 'json.dumps({"ok": True, "device": {' in "\n".join(last)


def test_epilogue_phase_rehearses_on_the_cpu(capsys):
    """The epilogue phase at small shapes on the CPU (plain versions, no
    times): affine_relu checked at the stem's and each stage's shape, the
    squeeze and the four tails at each stage's, affine_relu_pool2x2 at
    each block end (even and odd sizes); its byte counts, over the timed
    shapes and every block end, are each input and output moved once."""
    rows = chip_smoke.epilogue_phase(
        "cpu", dev="cpu", batch=2,
        shapes={"stem": (9, 16, None), "tiny": (5, 16, 64),
                "untimed": (3, 32, 128)}, timed=("tiny",),
        pool_shapes={"block a": (6, 16), "block b": (5, 32)})
    assert sorted(rows) == ["affine_gate_add_relu", "affine_relu",
                            "affine_relu_pool2x2", "affine_squeeze"]
    act = 2 * 5 * 5 * 64 * 2
    assert rows["affine_relu"][3] == 2 * act // 4  # at the inner width
    assert rows["affine_squeeze"][3] == act + 2 * 64 * 2
    assert rows["affine_gate_add_relu"][3] == 3 * act + 2 * 64 * 2
    pool_in = (2 * 6 * 6 * 16 + 2 * 5 * 5 * 32) * 2
    assert rows["affine_relu_pool2x2"][3] == pool_in + (
        2 * 6 * 6 * 16 * 2 // 4 + 2 * 5 * 5 * 32 * 2 // 4)
    assert all(r[:3] == [0.0, 0.0, 0.0] for r in rows.values())
    out = capsys.readouterr().out
    assert "affine_relu stem [2, 9, 9, 16]" in out
    for label, hw, c in (("tiny", 5, 64), ("untimed", 3, 128)):
        assert f"affine_squeeze {label} [2, {hw}, {hw}, {c}]" in out
        for tail in ("gated, identity", "gated, projection",
                     "no gate, identity", "no gate, projection"):
            assert (f"affine_gate_add_relu ({tail}) {label} "
                    f"[2, {hw}, {hw}, {c}]") in out
    for label, hw, c in (("block a", 6, 16), ("block b", 5, 32)):
        assert f"affine_relu_pool2x2 {label} [2, {hw}, {hw}, {c}]" in out


def test_train_bn_phase_rehearses_on_the_cpu(capsys):
    """The train-bn phase at small shapes on the CPU (the dispatch, which
    runs the eager code on the CPU, against the eager code; no times):
    every layer checked, the least bytes summed over the layers (4 an
    element forward, 6 backward), and the tiny student's step counting no
    fused call and no launch on the CPU."""
    shapes = {"a": (16, 7, 5), "b": (32, 3, 2)}
    rows = chip_smoke.train_bn_phase("cpu", dev="cpu", batch=3, shapes=shapes)
    elems = 3 * (16 * 7 * 5 + 32 * 3 * 2)
    assert rows["train_bn_forward"][3] == 4 * elems
    assert rows["train_bn_backward"][3] == 6 * elems
    for row in rows.values():
        assert row[:3] == [0.0, 0.0, 0.0]
        assert 0.0 <= row[4] <= 1.0
    out = capsys.readouterr().out
    for label, (c, h, w) in shapes.items():
        assert f"train-bn {label} [3, {c}, {h}, {w}] bf16 against" in out
    assert ("one student step at batch 3: train-mode BatchNorm launches "
            "{'stats': 0, 'finalize': 0, 'apply': 0, 'backward_reduce': 0, "
            "'backward_finalize': 0, 'backward_apply': 0}, calls {'fused': 0, "
            "'fused_backward': 0, 'plain': 0}") in out


def test_count_train_bn_holds_the_counts_since_the_reset():
    """``count_train_bn`` reads the six wrappers' launches and the
    engagement counts since ``reset_counts`` of the six, adds the launches
    to the total, and fails the phase on any other count: the kernels
    line's train-mode BatchNorm launches are those the runs made."""
    from mcncrossmodalemotions_torch.ops import train_bn

    chip_smoke.reset_counts(chip_smoke.TRAIN_BN_NAMES)
    for name in chip_smoke.TRAIN_BN_NAMES:
        getattr(train_bn, name).launches += 12
    train_bn.calls.update(fused=12, fused_backward=12)
    total = {"stats": 6}
    got = chip_smoke.count_train_bn("two steps", 12, 0, total)
    assert got == dict.fromkeys(chip_smoke.TRAIN_BN_NAMES, 12)
    assert total == {"stats": 18} | dict.fromkeys(
        chip_smoke.TRAIN_BN_NAMES[1:], 12)
    for fused, plain in ((6, 0), (12, 6)):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.count_train_bn("two steps", fused, plain)
    train_bn.backward_apply.launches -= 1  # a backward without its dx
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.count_train_bn("two steps", 12, 0)
    chip_smoke.reset_counts(chip_smoke.TRAIN_BN_NAMES)
    assert chip_smoke.count_train_bn("nothing", 0, 0) == dict.fromkeys(
        chip_smoke.TRAIN_BN_NAMES, 0)


def test_train_bn_shapes_are_the_students(monkeypatch):
    """chip_smoke's six BatchNorm shapes are the full-width student's at 4 s
    crops (a [1, 512, 400, 1] spectrogram): the inputs of bn1 to bn6 in a
    train forward."""
    from mcncrossmodalemotions_torch.models import vggm

    seen = []

    def spy(x, bn, *args, **kwargs):
        seen.append(tuple(x.shape[1:]))
        return x

    monkeypatch.setattr(vggm, "batch_norm_train", spy)
    with torch.no_grad():
        vggm.VGGMStudent(dtype=torch.float32)(torch.zeros(1, 512, 400, 1),
                                              train=True)
    assert seen == list(chip_smoke.TRAIN_BN_SHAPES.values())


def test_teacher_epilogue_launches_are_counted_a_forward():
    """chip_smoke's count of a full-width forward's epilogue launches: 33
    / 16 / 16 / 0 for SENet50, 33 / 0 / 16 / 0 for ResNet50, 10 / 0 / 0 /
    5 for VGG-VD-16, and a wrong count fails the phase."""
    assert chip_smoke.teacher_epilogue_launches("senet50", 2) == {
        "affine_relu": 66, "affine_squeeze": 32, "affine_gate_add_relu": 32,
        "affine_relu_pool2x2": 0}
    assert chip_smoke.teacher_epilogue_launches("resnet50", 1) == {
        "affine_relu": 33, "affine_squeeze": 0, "affine_gate_add_relu": 16,
        "affine_relu_pool2x2": 0}
    assert chip_smoke.teacher_epilogue_launches("vgg16", 3) == {
        "affine_relu": 30, "affine_squeeze": 0, "affine_gate_add_relu": 0,
        "affine_relu_pool2x2": 15}
    total = {}
    chip_smoke.reset_counts(chip_smoke.EPILOGUE_NAMES)
    chip_smoke.count_epilogues("cpu", "senet50", False, total)  # nothing launched
    assert total == dict.fromkeys(chip_smoke.EPILOGUE_NAMES, 0)
    for kind in ("senet50", "vgg16"):
        with pytest.raises(chip_smoke.SmokeFailure, match="epilogue launches"):
            chip_smoke.count_epilogues("card", kind, True, total)


def _fake_bench(monkeypatch, rc=0, drop=(), numerics_ok=True):
    """chip_smoke's bench process replaced by one that writes a details
    file of every ``BENCH_KEYS`` key but ``drop`` and the headline."""
    import json as _json

    def run(cmd, cwd, stdout, stderr, timeout):
        assert cmd[1:4] == ["-m", "mcncrossmodalemotions_torch.bench", "--full"]
        out = Path(cmd[cmd.index("--out-dir") + 1])
        out.mkdir(parents=True)
        details = {k: 1.0 for k in chip_smoke.BENCH_KEYS if k not in drop}
        details["numerics_ok"] = numerics_ok
        (out / "bench_details.json").write_text(_json.dumps(details))
        stdout.write("running ...\n" + _json.dumps(
            {"metric": "distillation_train_throughput", "value": 1880.5,
             "unit": "utts/sec/chip"}) + "\n")
        return SimpleNamespace(returncode=rc)

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)


def _jax_full_keys() -> set:
    """Every details key the JAX package's ``bench.py --full`` writes,
    read from its source: the ``details[...]`` stores, the
    ``details.update`` literals, the end-to-end keymaps and the frontend's
    under the port's names, but the host-link health, which the port's
    bench does not write."""
    import ast

    tree = ast.parse((REPO / "bench.py").read_text())
    keys, link = set(), ()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and getattr(node.value, "id", None) == "details"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "update"
              and getattr(node.func.value, "id", None) == "details"
              and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
        elif (isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", None) == "keymaps"):
            keys |= {v.value for d in node.value.values for v in d.values}
        elif (isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", None) == "_LINK_BOUND_KEYS"):
            link = tuple(e.value for e in node.value.elts)
    keys |= {"frontend_plain_ms", "frontend_kernel_ms"}  # jnp, pallas
    # the host-link health and the fields the JAX bench derives from it
    # for the ``_LINK_BOUND_KEYS`` are the JAX bench's alone
    assert link and "link_put_mb_per_sec" in keys
    return keys - {"link_put_mb_per_sec"}


def test_bench_phase_holds_the_bench_to_the_jax_keys(tmp_path, monkeypatch):
    keys = chip_smoke.BENCH_KEYS
    assert len(set(keys)) == len(keys)
    assert set(keys) == _jax_full_keys()
    _fake_bench(monkeypatch)
    chip_smoke.bench_phase("cpu", tmp_path)
    for i, bad in enumerate((dict(rc=1), dict(drop=("mfu_estimate",)),
                             dict(drop=("online_epoch_frames_per_crop",)),
                             dict(numerics_ok=False))):
        _fake_bench(monkeypatch, **bad)
        (tmp_path / str(i)).mkdir()
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.bench_phase("cpu", tmp_path / str(i))


def test_demo_phase_rehearses_on_the_cpu(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        wrappers = chip_smoke.KERNEL_NAMES
        counts = chip_smoke.demo_phase("cpu", tmp_path, wrappers, dev="cpu",
                                       speakers=4, tracks=8, tiny=True)
    finally:
        torch.set_num_threads(threads)
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    assert (tmp_path / "demo" / "demo_result.json").is_file()


def test_graft_phase_rehearses_on_the_cpu(capsys):
    """The integration entry's phase at ``dev="cpu"``: ``entry()`` at full
    width, then the dry run over one and over two gloo ranks, every check
    of the phase passing with no launch (CPU tensors); the dry runs' shards
    are of 1 and 2 rows whatever the card count."""
    wrappers = chip_smoke.KERNEL_NAMES
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        counts = chip_smoke.graft_phase("cpu", wrappers, dev="cpu")
    finally:
        torch.set_num_threads(threads)
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    printed = capsys.readouterr().out
    for n in (1, chip_smoke.GRAFT_GLOO_RANKS):
        assert f"dryrun_multichip({n}): checkpoint resume -> epoch 3 ok" \
            in printed
    assert chip_smoke.graft_rows(1) == chip_smoke.graft_rows(8) == [1, 2]


def _study_in_process(monkeypatch, rc=0):
    """chip_smoke's study processes replaced by the study's ``main`` run in
    this process at small sizes on the CPU (``rc`` the exit code)."""
    import importlib
    import json as _json

    def run(cmd, cwd, capture_output, text, timeout):
        assert cmd[1:3] == ["-m", cmd[2]] and "--iters" in cmd
        assert cmd[-2:] == ["--device", "cpu"]
        module = importlib.import_module(cmd[2])
        name, form = cmd[2].rsplit(".", 1)[1], cmd[3]
        if name == "probe_remat":
            rec = module.main(form, 2, "cpu", iters=1, num_frames=100,
                              tiny=True)
        else:
            rec = module.main(form, "cpu", iters=1, batch_size=2,
                              num_frames=100, tiny=True)
        return SimpleNamespace(returncode=rc, stdout=_json.dumps(rec) + "\n",
                               stderr="")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)


def test_studies_phase_rehearses_on_the_cpu(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        wrappers = chip_smoke.KERNEL_NAMES
        _study_in_process(monkeypatch)
        counts = chip_smoke.studies_phase("cpu", wrappers, 80.0, dev="cpu",
                                          small=True)
        assert counts == {k: 0 for k in wrappers}  # CPU: plain versions
        _study_in_process(monkeypatch, rc=1)
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.studies_phase("cpu", wrappers, 80.0, dev="cpu",
                                     small=True)
    finally:
        torch.set_num_threads(threads)


def test_step_study_launches_are_their_steps():
    """2 + 3 x STUDY_ITERS steps a process: K1 once a step, the with-index
    K2 twice plus the pools a remat policy recomputes, the backward twice;
    probe_remat's memory forward adds K1 once and the with-index K2 twice."""
    wrappers = chip_smoke.KERNEL_NAMES
    steps = 2 + 3 * chip_smoke.STUDY_ITERS
    base = chip_smoke.step_study_launches(wrappers)
    assert base == {k: 0 for k in wrappers} | {
        "spectrogram": steps, "max_pool_3x3s2_idx": 2 * steps,
        "max_pool_3x3s2_bwd": 2 * steps}
    none = chip_smoke.step_study_launches(wrappers, "none")
    nothing = chip_smoke.step_study_launches(wrappers, "nothing")
    assert none["spectrogram"] == nothing["spectrogram"] == steps + 1
    assert none["max_pool_3x3s2_idx"] == 2 * steps + 2
    assert nothing["max_pool_3x3s2_idx"] == 4 * steps + 2
    assert {m for m, _ in chip_smoke.STEP_STUDIES} == {
        "probe_masked_bn", "ab_step_conv1", "probe_remat"}
