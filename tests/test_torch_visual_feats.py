"""The port's dense teacher inference against the JAX package's, on the CPU.

On one synthetic VoxCeleb-style tree (``wavs/<speaker>/<track>.wav``,
``frames/<speaker>/<track>/*.jpg``, one track without frames, one frame
directory without a wav) and a tiny fp32 teacher with the same weights in
both packages:

- ``compute_visual_feats`` and ``build_imdb`` give the JAX package's
  frames bit for bit (its committed decoder library against the port's
  own), logits within 1e-4 x max|ref| + 1e-5, and imdb fields equal;
- a ``max_frames``-bounded run and its resume give an uninterrupted run's
  logits bit for bit; the feature cache is the JAX package's format both
  ways; ``fetch_emovoxceleb_imdb``'s caches;
- ``run_distillation`` trains an epoch on the port-built imdb;
- the refusals (``mesh="auto"`` under a world size that does not split
  the batch, ``max_frames_per_process`` without what its workers need,
  ``download``, no CUDA device without ``device="cpu"``) raise.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
from mcncrossmodalemotions_torch.data.images import save_synthetic_frame
from mcncrossmodalemotions_torch.data.imdb import TrackImdb
from mcncrossmodalemotions_torch.exp import compute_visual_feats as tvf
from mcncrossmodalemotions_torch.exp import fetch_emovoxceleb_imdb as tfetch
from mcncrossmodalemotions_torch.models.resnet import ResNet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.zoo import (
    random_teacher_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.exp import compute_audio_feats as jaf
from mcncrossmodalemotions_tpu.exp import compute_visual_feats as jvf
from mcncrossmodalemotions_tpu.exp import fetch_emovoxceleb_imdb as jfetch
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)

pytestmark = pytest.mark.skipif(
    not jnative.available(),
    reason="native/libdataservice.so does not load on this host")

TINY = dict(stage_sizes=(1, 1), width=8, use_se=True)
RTOL, ATOL = 1e-4, 1e-5
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 speakers x 3 tracks of wavs; frames (3-6 a track, 64x64 and
    48x80) for all but spk001/track001, and frames of a wav-less track."""
    root = tmp_path_factory.mktemp("vox")
    build_synthetic_imdb(root / "wavs", num_speakers=3, tracks_per_speaker=3,
                         duration_range=(1.2, 1.6))
    rng = np.random.RandomState(0)
    k = 0
    for s in range(3):
        for t in range(3):
            if (s, t) == (1, 1):
                continue
            for f in range(int(rng.randint(3, 7))):
                save_synthetic_frame(
                    root / "frames" / f"spk{s:03d}" / f"track{t:03d}"
                    / f"{f:05d}.jpg", k % 7, size=64 if k % 2 else 80, seed=k)
                k += 1
    save_synthetic_frame(root / "frames" / "spk009" / "track000" / "00000.jpg",
                         1)
    return root


@pytest.fixture(scope="module")
def teacher():
    v = random_teacher_variables(seed=7, **TINY)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    port = FaceTeacherPipeline(ResNet(dtype=torch.float32, **TINY),
                               input_size=64)
    state = teacher_state_dict_from_flax(nested)
    port.load_state_dict(state, strict=True)
    jmodel = JPipeline(teacher=JResNet(dtype=jnp.float32, **TINY),
                       input_size=64, augment=False)
    return port, state, jmodel, nested


def _close(got, ref, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"{what}: max abs diff {err:.3e}, max |ref| {scale:.3f}")
    assert got.shape == ref.shape and err <= RTOL * scale + ATOL, what


def _track_imdb(tree) -> TrackImdb:
    frames = sorted((tree / "frames").glob("spk00*/track*"))
    paths = [np.asarray(sorted(str(p.relative_to(tree / "frames"))
                               for p in d.glob("*.jpg")), dtype=object)
             for d in frames]
    n = len(paths)
    return TrackImdb(track_ids=np.arange(n), labels=np.zeros(n, np.int32),
                     set_id=np.ones(n, np.int32), frame_paths=paths)


def _frame_list(tree):
    return [str(tree / "frames" / p) for t in _track_imdb(tree).frame_paths
            for p in t]


def test_frames_are_the_jax_packages(tree):
    """The port's decoder gives the JAX loader's frames (its committed
    library), at both crops, so the logits below differ by arithmetic
    only."""
    from mcncrossmodalemotions_torch.data.images import load_frame_batch
    from mcncrossmodalemotions_tpu.data.images import (
        load_frame_batch as jload_frame_batch,
    )

    paths = _frame_list(tree)
    for crop in (1.0, 1.0 / 1.6):
        np.testing.assert_array_equal(load_frame_batch(paths, 64, 2, crop),
                                      jload_frame_batch(paths, 64, 2, crop))


def test_compute_visual_feats_matches_jax(tree, teacher, tmp_path):
    port, state, jmodel, jvars = teacher
    imdb = _track_imdb(tree)
    kw = dict(batch_size=BATCH, frame_root=str(tree / "frames"),
              input_size=64, verbose=False)
    got = tvf.compute_visual_feats(imdb, port, state, device="cpu",
                                   feat_path=str(tmp_path / "port.npz"), **kw)
    with jax.default_matmul_precision("highest"):
        ref = jvf.compute_visual_feats(imdb, jmodel, jvars,
                                       feat_path=str(tmp_path / "jax.npz"),
                                       **kw)
    assert [g.shape for g in got] == [r.shape for r in ref]
    _close(np.concatenate(got), np.concatenate(ref), "compute_visual_feats")
    # each package reads the other's cache
    crossed = tvf.compute_visual_feats(imdb, port, state, device="cpu",
                                       feat_path=str(tmp_path / "jax.npz"), **kw)
    for a, b in zip(crossed, ref):
        np.testing.assert_array_equal(a, b)
    jread = jaf._load_feat_cache(str(tmp_path / "port.npz"), len(got),
                                 "senet50-ferplus")
    for a, b in zip(jread, got):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="model"):
        tvf.compute_visual_feats(imdb, port, state, device="cpu",
                                 model_name="other",
                                 feat_path=str(tmp_path / "port.npz"), **kw)


def test_random_baseline_matches_jax(tree):
    imdb = _track_imdb(tree)
    got = tvf.compute_visual_feats(imdb, model_name="random", seed=3)
    ref = jvf.compute_visual_feats(imdb, model_name="random", seed=3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_build_imdb_matches_jax(tree, teacher):
    port, state, jmodel, jvars = teacher
    sets = {"spk002": 3}
    got = tfetch.build_imdb(tree, port, state, set_assignment=sets,
                            batch_size=BATCH, verbose=False, device="cpu")
    # the JAX build resizes to its extractor's default 224
    jmodel224 = jmodel.clone(input_size=224)
    port224 = FaceTeacherPipeline(port.teacher, input_size=224)
    got224 = tfetch.build_imdb(tree, port224, state, set_assignment=sets,
                               batch_size=BATCH, verbose=False, device="cpu")
    with jax.default_matmul_precision("highest"):
        ref = jfetch.build_imdb(tree, jmodel224, jvars, set_assignment=sets,
                                batch_size=BATCH, verbose=False)
    for a in (got, got224):
        assert list(a.wav_paths) == list(ref.wav_paths)
        assert list(a.speaker) == list(ref.speaker)
        np.testing.assert_array_equal(a.set_id, ref.set_id)
        assert [list(f) for f in a.dense_frames] == [list(f)
                                                     for f in ref.dense_frames]
        assert (a.wav_dir, a.frame_dir) == (ref.wav_dir, ref.frame_dir)
        assert tuple(a.classes) == tuple(ref.classes)
    assert "spk001/track001.wav" not in list(got.wav_paths)  # frameless
    assert len(got.wav_paths) == 8
    _close(np.concatenate(got224.wav_logits), np.concatenate(ref.wav_logits),
           "build_imdb")
    assert all(w.dtype == np.float32 for w in got.wav_logits)


def test_register_frames_matches_jax(tree):
    wavs = sorted(str(p.relative_to(tree / "wavs"))
                  for p in (tree / "wavs").rglob("*.wav"))
    kept, frames = tfetch.register_frames(wavs, tree / "frames")
    jkept, jframes = jfetch.register_frames(wavs, tree / "frames")
    np.testing.assert_array_equal(kept, jkept)
    assert [list(f) for f in frames] == [list(f) for f in jframes]
    assert len(kept) == 8 and all(f.dtype == object for f in frames)


def test_bounded_runs_resume_to_one_pass_bitwise(tree, teacher, tmp_path):
    port, state, _, _ = teacher
    paths = _frame_list(tree)
    ex = tvf.VisualFeatureExtractor(port, state, batch_size=BATCH,
                                    input_size=64, device="cpu")
    full = ex.frame_logits(paths, verbose=False)
    partial = str(tmp_path / "dense.partial.npz")
    assert ex.frame_logits(paths, verbose=False, partial_path=partial,
                           max_frames=2 * BATCH) is None
    assert np.load(partial)["logits"].shape[0] == 2 * BATCH
    assert ex.frame_logits(paths, verbose=False, partial_path=partial,
                           max_frames=1) is None  # at least one batch
    resumed = ex.frame_logits(paths, verbose=False, partial_path=partial)
    np.testing.assert_array_equal(resumed, full)
    assert not Path(partial).exists()  # a finished job drops its partial
    # a partial of another job (other weights) is not resumed
    ex.frame_logits(paths, verbose=False, partial_path=partial,
                    max_frames=BATCH)
    other = {k: v + 1 if v.is_floating_point() else v for k, v in state.items()}
    ex2 = tvf.VisualFeatureExtractor(port, other, batch_size=BATCH,
                                     input_size=64, device="cpu")
    assert ex2._job_key(paths) != ex._job_key(paths)
    np.testing.assert_array_equal(
        ex2.frame_logits(paths, verbose=False, partial_path=partial),
        ex2.frame_logits(paths, verbose=False))
    with pytest.raises(ValueError, match="partial_path"):
        ex.frame_logits(paths, max_frames=4)


def test_build_imdb_bounded_and_resumed_is_one_pass(tree, teacher, tmp_path):
    port, state, _, _ = teacher
    kw = dict(batch_size=BATCH, verbose=False, device="cpu")
    one = tfetch.build_imdb(tree, port, state, **kw)
    partial = str(tmp_path / "imdb.partial.npz")
    assert tfetch.build_imdb(tree, port, state, partial_path=partial,
                             max_frames=BATCH, **kw) is None
    two = tfetch.build_imdb(tree, port, state, partial_path=partial, **kw)
    for a, b in zip(one.wav_logits, two.wav_logits):
        np.testing.assert_array_equal(a, b)


def test_fetch_caches_and_refusals(tree, teacher, tmp_path, monkeypatch):
    port, state, _, _ = teacher
    cache = str(tmp_path / "imdb.npz")
    imdb = tfetch.fetch_emovoxceleb_imdb(tree, port, state, cache_path=cache,
                                         batch_size=BATCH, verbose=False,
                                         device="cpu")
    assert Path(cache).exists()
    assert tfetch.fetch_emovoxceleb_imdb(tree, cache_path=cache) is imdb
    tfetch._MEMORY_CACHE.clear()
    again = tfetch.fetch_emovoxceleb_imdb(tree, cache_path=cache)
    for a, b in zip(again.wav_logits, imdb.wav_logits):
        np.testing.assert_array_equal(a, b)
    jread = jfetch.EmoVoxImdb.load(cache)  # the JAX package reads it
    assert list(jread.wav_paths) == list(imdb.wav_paths)
    tfetch._MEMORY_CACHE.clear()
    with pytest.raises(FileNotFoundError, match="teacher"):
        tfetch.fetch_emovoxceleb_imdb(tree, cache_path=str(tmp_path / "no.npz"))
    # download=True resolves the released logits through the registry (a
    # release placed by hand here; no URL opens), as the JAX driver does
    import urllib.error
    import urllib.request

    import chip_smoke
    from mcncrossmodalemotions_torch.zoo.artifacts import artifact_path

    def no_network(*args, **kwargs):
        raise urllib.error.URLError("the tests reach no network")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "artifacts"))
    release = artifact_path("emovoxceleb-logits")
    release.parent.mkdir(parents=True)
    chip_smoke.logits_release(release, imdb)
    got = tfetch.fetch_emovoxceleb_imdb(tree, download=True)
    assert got.wav_dir == str(Path(tree) / "wavs")
    assert list(got.wav_paths) == list(imdb.wav_paths)
    for a, b in zip(got.wav_logits, imdb.wav_logits):
        np.testing.assert_array_equal(a, b)
    tfetch._MEMORY_CACHE.clear()


def test_refusals(tree, teacher, monkeypatch):
    from mcncrossmodalemotions_torch.parallel import mesh as pmesh

    port, state, _, _ = teacher
    imdb = _track_imdb(tree)
    with monkeypatch.context() as m:
        m.setattr(pmesh, "world_size", lambda: 3)
        with pytest.raises(ValueError, match="does not split over 3 ranks"):
            tvf.compute_visual_feats(imdb, port, state, device="cpu")
        with pytest.raises(ValueError, match="does not split over 3 ranks"):
            tfetch.build_imdb(tree, port, state, device="cpu")
    # bounded worker processes need what a worker rebuilds the job from
    with pytest.raises(ValueError, match="requires feat_path, model_spec"):
        tvf.compute_visual_feats(imdb, port, state, device="cpu",
                                 max_frames_per_process=100)
    with pytest.raises(ValueError, match="requires partial_path and "
                                         "teacher_spec"):
        tfetch.build_imdb(tree, port, state, max_frames_per_process=9,
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tvf.compute_visual_feats(imdb, port, state),
                 lambda: tfetch.build_imdb(tree, port, state),
                 lambda: tvf.VisualFeatureExtractor(port, state)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_run_distillation_trains_on_the_port_built_imdb(tree, teacher,
                                                        tmp_path):
    from mcncrossmodalemotions_torch.exp import run_distillation as rd

    port, state, _, _ = teacher
    imdb = tfetch.build_imdb(tree, port, state, set_assignment={"spk002": 3},
                             batch_size=BATCH, verbose=False, device="cpu")
    cfg = rd.DistillationConfig(num_epochs=1, out_root=str(tmp_path),
                                batch_size=2, num_seconds=1.0, tiny_model=True,
                                mini_epoch_ratio=1.0)
    _, history, exp_dir = rd.run_distillation(cfg, imdb, device="cpu")
    assert (Path(exp_dir) / "net-epoch-1.pt").exists()
    assert np.isfinite(history[-1]["train"]["loss"])
