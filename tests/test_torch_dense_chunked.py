"""The port's bounded-worker dense build and its soak, on the CPU.

- ``chunked_frame_logits`` over 12 frames in 3 worker processes (5 frames
  a chunk, batch 2: a worker takes 4) gives the in-process
  ``frame_logits`` bit for bit and the JAX extractor's logits on the same
  weights within the teacher tolerance (1e-4 x max|ref| + 1e-5), and
  leaves neither the partial nor the job directory;
- the cycle rule counts the frames a worker really takes: 81 cycles for
  10,000 frames at chunk 200 and batch 128, where the JAX module allows 52
  (a healthy run needs 79);
- the supervisor's loop with a stand-in for ``subprocess.run``: progress
  read from the partial, the result and the clean-up, the job file (the
  state bitwise in bf16 and fp32, device, threads, backend switches), the
  child's ``PYTHONPATH``; a cycle without progress aborts, a failed worker
  raises with the tail of its output;
- ``compute_visual_feats(max_frames_per_process=)`` and ``build_imdb(
  max_frames_per_process=, teacher_spec=)`` equal their unbounded runs bit
  for bit, and refuse a missing feat_path, spec, state or partial, and a
  mesh of two ranks;
- the soak's JPEG writer (decoded by PIL and by the port's decoder, every
  frame its own pixels), its RSS summary, and one clean tiny build with
  its report (no kill here: a kill racing a loaded CPU is the card's
  phase's to show).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data import images
from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
from mcncrossmodalemotions_torch.data.images import save_synthetic_frame
from mcncrossmodalemotions_torch.data.imdb import EmoVoxImdb, TrackImdb
from mcncrossmodalemotions_torch.exp import compute_visual_feats as tvf
from mcncrossmodalemotions_torch.exp import dense_chunked
from mcncrossmodalemotions_torch.exp import fetch_emovoxceleb_imdb as tfetch
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh
from mcncrossmodalemotions_torch.tools import soak_dense_genesis as soak
from mcncrossmodalemotions_torch.zoo import (
    random_teacher_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.exp import compute_visual_feats as jvf
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)

TINY = dict(stage_sizes=(1, 1), width=8, use_se=True)
SPEC = {"teacher": {"name": "senet50-ferplus", "tiny": True},
        "input_size": 48, "dtype": "float32"}
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_visual_feats.py's teacher gate
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The tiny SENet's weights: the port's state and the Flax tree."""
    v = random_teacher_variables(seed=7, **TINY)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    return teacher_state_dict_from_flax(nested), nested


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    paths = []
    for i in range(12):
        p = root / f"f{i:02d}.jpg"
        save_synthetic_frame(p, i % 4, seed=i)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 speakers x 2 tracks of wavs, 3 frames a track."""
    root = tmp_path_factory.mktemp("vox")
    build_synthetic_imdb(root / "wavs", num_speakers=2, tracks_per_speaker=2,
                         duration_range=(1.2, 1.4))
    for k, wav in enumerate(sorted((root / "wavs").rglob("*.wav"))):
        track = wav.relative_to(root / "wavs").with_suffix("")
        for f in range(3):
            save_synthetic_frame(root / "frames" / track / f"{f:05d}.jpg",
                                 (k + f) % 7, seed=10 * k + f)
    return root


def _model():
    model, state = dense_chunked.build_worker_model(SPEC, "cpu")
    assert state is None and model.teacher.dtype == torch.float32
    return model


def _track_imdb(tree) -> TrackImdb:
    dirs = sorted((tree / "frames").glob("spk*/track*"))
    paths = [np.asarray(sorted(str(p.relative_to(tree / "frames"))
                               for p in d.glob("*.jpg")), dtype=object)
             for d in dirs]
    n = len(paths)
    return TrackImdb(track_ids=np.arange(n), labels=np.zeros(n, np.int32),
                     set_id=np.ones(n, np.int32), frame_paths=paths)


@pytest.mark.skipif(not jnative.available(),
                    reason="native/libdataservice.so does not load on this host")
def test_chunked_frame_logits_match_in_process_and_jax(frames, weights,
                                                       tmp_path, capsys):
    state, nested = weights
    clean = tvf.VisualFeatureExtractor(_model(), state, batch_size=BATCH,
                                       input_size=48, device="cpu"
                                       ).frame_logits(frames, verbose=False)
    partial = tmp_path / "dense.partial.npz"
    got = dense_chunked.chunked_frame_logits(
        SPEC, state, frames, str(partial), chunk_frames=5, batch_size=BATCH,
        input_size=48, device="cpu")
    cycles = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[dense-chunked] cycle")]
    assert [ln.split(":")[1].split(",")[0].strip() for ln in cycles] == [
        "4/12 frames", "8/12 frames", "12/12 frames"]
    np.testing.assert_array_equal(got, clean)
    assert not partial.exists() and not partial.with_suffix(".job").exists()

    jmodel = JPipeline(teacher=JResNet(dtype=jnp.float32, **TINY),
                       input_size=48, augment=False)
    with jax.default_matmul_precision("highest"):
        ref = jvf.VisualFeatureExtractor(jmodel, nested, batch_size=BATCH,
                                         input_size=48).frame_logits(
            frames, verbose=False)
    scale = float(np.abs(ref).max())
    assert got.shape == ref.shape == (12, 8)
    assert float(np.abs(got - ref).max()) <= RTOL * scale + ATOL


@pytest.mark.parametrize("n, chunk, batch, port, jax_cycles", [
    (10000, 200, 128, 81, 52),  # 79 workers of 128 frames
    (12, 5, 2, 5, 5),
    (2016, 512, 128, 6, 6),
    (7, 100, 128, 3, 3),
])
def test_cycle_rule_counts_whole_batches(n, chunk, batch, port, jax_cycles):
    assert dense_chunked.max_worker_cycles(n, chunk, batch) == port
    assert -(-n // chunk) + 2 == jax_cycles  # the JAX module's budget


def test_a_bounded_call_takes_the_rules_frames(frames, weights, tmp_path):
    """frame_logits(max_frames=5) at batch 2 scores 4 frames a call, so 12
    frames take 3 calls: the cycle rule's count, less its two spare."""
    state, _ = weights
    ex = tvf.VisualFeatureExtractor(_model(), state, batch_size=BATCH,
                                    input_size=48, device="cpu")
    partial = tmp_path / "p.npz"
    calls, done = 0, []
    while True:
        calls += 1
        out = ex.frame_logits(frames, verbose=False, partial_path=str(partial),
                              max_frames=5)
        if out is not None:
            break
        with np.load(partial) as data:
            done.append(data["logits"].shape[0])
    assert done == [4, 8]
    assert dense_chunked.worker_frames(5, BATCH) == 4
    assert calls == dense_chunked.max_worker_cycles(12, 5, BATCH) - 2


def _fake_worker(script):
    """A stand-in for subprocess.run: call k does ``script[k](job)`` and
    returns its (exit code, output)."""
    calls = []

    def run(cmd, **kw):
        job = json.loads(Path(cmd[-1]).read_text())
        calls.append((cmd, kw, job))
        code, out = script[len(calls) - 1](job)
        return subprocess.CompletedProcess(cmd, code, stdout=out)

    return run, calls


def _progress(rows):
    def step(job):
        np.savez(job["partial_path"], logits=np.zeros((rows, 8), np.float32),
                 key="k")
        return 0, json.dumps({"chunk_worker": "progress"}) + "\n"
    return step


def test_the_supervisor_loop_and_its_job(tmp_path, monkeypatch, capsys):
    result = np.arange(48, dtype=np.float32).reshape(6, 8)

    def finish(job):
        np.savez(job["out_path"], logits=result)
        return 0, "done\n"

    run, calls = _fake_worker([_progress(2), _progress(4), finish])
    monkeypatch.setattr(dense_chunked.subprocess, "run", run)
    state = {"a": torch.randn(3, 5).to(torch.bfloat16),
             "b": torch.randn(4), "n": torch.tensor(7)}
    partial = tmp_path / "dense.partial.npz"
    got = dense_chunked.chunked_frame_logits(
        SPEC, state, [f"f{i}.jpg" for i in range(6)], str(partial),
        chunk_frames=2, batch_size=2, env={"PYTHONPATH": "/elsewhere"},
        device="cpu")
    np.testing.assert_array_equal(got, result)
    assert len(calls) == 3 and not partial.with_suffix(".job").exists()
    out = capsys.readouterr().out
    assert "[dense-chunked] cycle 2: 4/6 frames" in out and "done" in out
    cmd, kw, job = calls[0]
    assert cmd[1:4] == ["-m", dense_chunked.WORKER_MODULE, "--worker"]
    assert kw["env"]["PYTHONPATH"] == os.pathsep.join(
        [dense_chunked.PACKAGE_PARENT, "/elsewhere"])
    assert (job["device"], job["num_threads"], job["chunk_frames"],
            job["model_spec"]) == ("cpu", torch.get_num_threads(), 2, SPEC)
    assert job["backends"] == dense_chunked.backend_switches()


def test_a_cycle_without_progress_aborts_and_a_failure_raises(tmp_path,
                                                              monkeypatch):
    state = {"a": torch.randn(3, 5).to(torch.bfloat16), "b": torch.randn(4)}
    paths = [f"f{i}.jpg" for i in range(6)]
    partial = tmp_path / "dense.partial.npz"
    run, calls = _fake_worker([_progress(2), _progress(2)])
    monkeypatch.setattr(dense_chunked.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="no progress .stuck at 2/6"):
        dense_chunked.chunked_frame_logits(SPEC, state, paths, str(partial),
                                           chunk_frames=2, batch_size=2,
                                           verbose=False, device="cpu")
    assert len(calls) == 2
    # the state the workers read: every tensor bit for bit, bf16 included
    back = torch.load(calls[0][2]["state_file"], weights_only=True)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    assert partial.exists()  # kept for a later call to resume

    tail = "\n".join(f"line {i}" for i in range(20)) + "\nRuntimeError: boom\n"
    run, calls = _fake_worker([lambda job: (3, tail)])
    monkeypatch.setattr(dense_chunked.subprocess, "run", run)
    with pytest.raises(RuntimeError, match=r"cycle 1, exit 3\): line 13 .*"
                                           r"RuntimeError: boom"):
        dense_chunked.chunked_frame_logits(SPEC, state, paths, str(partial),
                                           chunk_frames=2, batch_size=2,
                                           verbose=False, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        dense_chunked.chunked_frame_logits(SPEC, state, paths, str(partial),
                                           chunk_frames=0, device="cpu")


def test_chunked_entry_points_equal_their_unbounded_runs(tree, weights, tmp_path):
    state, _ = weights
    model = _model()
    imdb = _track_imdb(tree)
    kw = dict(batch_size=BATCH, frame_root=str(tree / "frames"),
              input_size=48, verbose=False, device="cpu")
    whole = tvf.compute_visual_feats(imdb, model, state,
                                     feat_path=str(tmp_path / "a.npz"), **kw)
    chunked = tvf.compute_visual_feats(imdb, None, state,
                                       feat_path=str(tmp_path / "b.npz"),
                                       max_frames_per_process=8,
                                       model_spec=SPEC, **kw)
    assert len(chunked) == len(whole) == 4
    for a, b in zip(chunked, whole):
        np.testing.assert_array_equal(a, b)
    assert not (tmp_path / "b.npz.partial.npz").exists()

    spec = dict(SPEC, input_size=224)  # build_imdb decodes to 224
    model224 = dense_chunked.build_worker_model(spec, "cpu")[0]
    sets = {"spk001": 3}
    ref = tfetch.build_imdb(tree, model224, state, set_assignment=sets,
                            batch_size=BATCH, verbose=False, device="cpu")
    partial = tmp_path / "imdb.partial.npz"
    got = tfetch.build_imdb(tree, None, state, set_assignment=sets,
                            batch_size=BATCH, partial_path=str(partial),
                            max_frames_per_process=7, teacher_spec=spec,
                            verbose=False, device="cpu")
    assert list(got.wav_paths) == list(ref.wav_paths)
    np.testing.assert_array_equal(got.set_id, ref.set_id)
    for a, b in zip(got.wav_logits, ref.wav_logits):
        np.testing.assert_array_equal(a, b)
    assert not partial.exists() and not partial.with_suffix(".job").exists()


def test_chunked_refusals(tree, weights, tmp_path):
    state, _ = weights
    imdb = _track_imdb(tree)
    model = _model()
    kw = dict(device="cpu", max_frames_per_process=4, verbose=False)
    need = "requires feat_path, model_spec and state"
    feat = str(tmp_path / "f.npz")
    for args in (dict(model_spec=SPEC), dict(feat_path=feat),
                 dict(feat_path=feat, model_spec=SPEC, state=None)):
        with pytest.raises(ValueError, match=need):
            tvf.compute_visual_feats(imdb, model, **({"state": state} | args),
                                     **kw)
    for args in (dict(teacher_spec=SPEC), dict(partial_path=feat)):
        with pytest.raises(ValueError,
                           match="requires partial_path and teacher_spec"):
            tfetch.build_imdb(tree, model, state, **args, **kw)
    mesh = DataMesh(rank=0, world_size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        tvf.compute_visual_feats(imdb, model, state, feat_path=feat,
                                 model_spec=SPEC, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        tfetch.build_imdb(tree, model, state, partial_path=feat,
                          teacher_spec=SPEC, mesh=mesh, **kw)


def test_soak_frames_decode_to_their_own_pixels(tmp_path):
    from PIL import Image

    from mcncrossmodalemotions_torch.data import native_faces

    data = soak.track_frames(5, 3 * soak.VARIANTS // 2)
    paths = []
    for i, b in enumerate(data):
        paths.append(tmp_path / f"{i:03d}.jpg")
        paths[-1].write_bytes(b)
    pil = np.stack([np.asarray(Image.open(io.BytesIO(b))) for b in data])
    assert pil.shape == (96, 96, 96) and pil.dtype == np.uint8
    assert len({p.tobytes() for p in pil}) == len(pil)
    port = native_faces.decode_faces([str(p) for p in paths], 96, 1.0)
    assert np.abs(port[..., 0].astype(int) - pil.astype(int)).max() <= 1
    # frame 0: its base's coefficients dequantised by 13, inverse DCT
    zz = images.zigzag_coefficients(soak._base_image(5 * 100003), 16)
    coef = np.zeros_like(zz)
    coef[:, images.ZIGZAG] = zz * 13
    pix = images.DCT.T @ coef.reshape(-1, 8, 8).astype(float) @ images.DCT
    img = np.clip(np.round(pix + 128), 0, 255).reshape(12, 12, 8, 8)
    img = img.transpose(0, 2, 1, 3).reshape(96, 96)
    assert np.abs(img - pil[0]).max() <= 1


def test_rss_summary_reads_the_build_after_warm():
    res = {"init_sec": 1.0, "build_sec": 6.0, "batches": 40,
           "rss_mb": [(0.0, 100.0), (1.0, 180.0), (3.0, 160.0), (5.0, 170.0),
                      (7.0, 171.0), (9.0, 300.0)]}
    got = soak.rss_summary(res)
    assert (got["rss_warm_mb"], got["rss_growth_after_warm_mb"],
            got["rss_max_mb"]) == (160.0, 11.0, 300.0)
    assert got["rss_growth_per_batch_mb"] == pytest.approx(11.0 / 30)


def test_soak_dataset_and_a_clean_tiny_build(tmp_path):
    root = tmp_path / "data"
    assert soak.generate_dataset(root, 2 * soak.TRACKS, verbose=False) == 64
    jpgs = sorted((root / "frames").rglob("*.jpg"))
    assert len(jpgs) == 64 and len(list((root / "wavs").rglob("*.wav"))) == 32
    assert len({p.read_bytes() for p in jpgs}) == 64
    report = soak.clean_build(root, tmp_path, batch_size=4, tiny=True)
    assert (report["frames"], report["tracks"], report["batches"]) == (64, 32,
                                                                        16)
    assert report["imgs_per_sec"] > 0 and report["rss_max_mb"] > 0
    assert report["rss_trace_mb"]
    imdb = EmoVoxImdb.load(str(tmp_path / "imdb_clean.npz"))
    assert len(imdb.wav_logits) == 32
    assert all(w.shape == (2, 8) and np.isfinite(w).all()
               for w in imdb.wav_logits)
    assert not (tmp_path / "clean.partial.npz").exists()
