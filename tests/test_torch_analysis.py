"""The student's analysis entry points in the port, held to the JAX originals.

Given the same logits, ``utils/roc.py``, ``utils/mnr.py`` (also against
``tests/fixtures/mnr_golden.npz``), ``exp/run_cross_val.py``,
``exp/emo_benchmarks.py``, ``exp/student_stats.py``,
``exp/teacher_stats.py`` and ``exp/sample_audio.py`` return bit for bit
what the originals return. End to end on a tiny synthetic imdb and a
tiny external set, JAX extraction + the JAX analysis and the port's
extraction + the port's analysis give AUCs within 1e-6 and equal fold
accuracies.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.data.emovox import (
    build_synthetic_imdb as jbuild_synthetic_imdb,
)
from mcncrossmodalemotions_tpu.exp import compute_audio_feats as jfeats
from mcncrossmodalemotions_tpu.exp import emo_benchmarks as jbench
from mcncrossmodalemotions_tpu.exp import run_cross_val as jcv
from mcncrossmodalemotions_tpu.exp import sample_audio as jsample
from mcncrossmodalemotions_tpu.exp import student_stats as jstats
from mcncrossmodalemotions_tpu.exp import teacher_stats as jteacher
from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_tpu.utils import mnr as jmnr
from mcncrossmodalemotions_tpu.utils import roc as jroc
from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
from mcncrossmodalemotions_torch.data.external import build_synthetic_track_imdb
from mcncrossmodalemotions_torch.exp import compute_audio_feats as tfeats
from mcncrossmodalemotions_torch.exp import emo_benchmarks as bench
from mcncrossmodalemotions_torch.exp import run_cross_val as cv
from mcncrossmodalemotions_torch.exp import sample_audio
from mcncrossmodalemotions_torch.exp import student_stats as stats
from mcncrossmodalemotions_torch.exp import teacher_stats as teacher
from mcncrossmodalemotions_torch.utils import mnr, roc
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    random_student_variables,
    student_state_dict_from_flax,
)

FIXTURES = Path(__file__).parent / "fixtures"


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_results(a, b) -> bool:
    """Equal nested results; floats (NaN too) and arrays bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_results(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_results(x, y) for x, y in zip(a, b)))
    if isinstance(a, float):
        return isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, (np.ndarray, np.generic)):
        return bits_equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def emovox(tmp_path_factory):
    return build_synthetic_imdb(tmp_path_factory.mktemp("emovox") / "wav",
                                num_speakers=3, tracks_per_speaker=5,
                                duration_range=(1.1, 1.9), seed=3)


# -- roc, mnr ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_roc_bitwise(seed):
    rng = np.random.RandomState(seed)
    n = 40
    labels = np.where(rng.rand(n) > 0.6, 1, -1)
    scores = np.round(rng.randn(n), 1 if seed % 2 else 6)  # ties when rounded
    got, ref = roc.roc_curve(labels, scores), jroc.roc_curve(labels, scores)
    assert all(bits_equal(x, y) for x, y in zip(got[:2], ref[:2]))
    assert same_results(got[2], ref[2])
    assert same_results(roc.auc_score(labels > 0, scores),
                        jroc.auc_score(labels > 0, scores))
    one_class = np.ones(5)
    assert same_results(roc.roc_curve(one_class, scores[:5])[2],
                        jroc.roc_curve(one_class, scores[:5])[2])


@pytest.mark.parametrize("seed,t,d", [(0, 3, 4), (1, 6, 8), (2, 2, 1)])
def test_mnr_bitwise(seed, t, d):
    rng = np.random.RandomState(seed)
    x = rng.randn(60, d)
    y = rng.randint(0, t, 60)
    x[:, 0] += y  # some signal
    beta, jbeta = mnr.mnrfit(x, y, num_classes=t), jmnr.mnrfit(x, y, num_classes=t)
    assert bits_equal(beta, jbeta)
    xt = rng.randn(9, d)
    assert bits_equal(mnr.mnrval(beta, xt), jmnr.mnrval(jbeta, xt))


def test_mnr_golden():
    fx = np.load(FIXTURES / "mnr_golden.npz")
    beta = mnr.mnrfit(fx["X"], fx["y"], num_classes=3)
    assert bits_equal(beta, jmnr.mnrfit(fx["X"], fx["y"], num_classes=3))
    np.testing.assert_allclose(mnr.mnrval(beta, fx["Xtest"]), fx["probs"],
                               atol=2e-4)


# -- run_cross_val, emo_benchmarks -------------------------------------------

def _track_logits(seed, labels, frames=(1, 4), s=8, signal=1.0):
    rng = np.random.RandomState(seed)
    out = []
    for lab in labels:
        f = rng.randint(frames[0], frames[1] + 1)
        x = rng.randn(f, s).astype(np.float32)
        x[:, lab % s] += signal
        out.append(x)
    return out


@pytest.mark.parametrize("how", ["max", "mean", "mean1", "peak"])
def test_aggregation_and_folds_bitwise(how):
    labels = np.repeat(np.arange(4), 6)
    logits = _track_logits(0, labels)
    for t in logits:
        assert bits_equal(cv.aggregate_track(t, how), jcv.aggregate_track(t, how))
    for n, k in ((24, 5), (10, 3), (7, 7)):
        assert same_results(cv.kfold_splits(n, k, seed=2),
                            jcv.kfold_splits(n, k, seed=2))


@pytest.mark.parametrize("val_idx", [None, np.arange(0, 36, 4)])
def test_run_cross_val_bitwise(tmp_path, val_idx):
    labels = np.repeat(np.arange(6), 6)
    logits = _track_logits(1, labels)
    got = cv.run_cross_val(logits, labels, num_folds=4, aggregator="max",
                           existing_val_idx=val_idx, seed=1,
                           exp_dir=str(tmp_path / "t"))
    ref = jcv.run_cross_val(logits, labels, num_folds=4, aggregator="max",
                            existing_val_idx=val_idx, seed=1,
                            exp_dir=str(tmp_path / "j"))
    for field in ("labels", "fused_logits", "val_idx_sets", "betas"):
        assert same_results(getattr(got, field), getattr(ref, field)), field
    saved = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert saved == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in saved:
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert all(bits_equal(a[k], b[k]) for k in ("beta", "val_idx"))


def _benchmark_sets():
    labels = np.repeat(np.arange(6), 7)
    afew_labels = np.repeat(np.arange(3), 10)
    return {
        "rml": dict(track_logits=_track_logits(2, labels), labels=labels,
                    classes=["angry", "Disgusted", "fear", "happy", "sad",
                             "surprise"]),
        "enterface": dict(track_logits=_track_logits(3, labels, signal=0.3),
                          labels=labels),
        "afew": dict(track_logits=_track_logits(4, afew_labels),
                     labels=afew_labels, classes=["anger", "joy", "neutral"],
                     val_idx=np.arange(0, 30, 3)),
    }


@pytest.mark.parametrize("aggregator", ["max", "peak"])
def test_emo_benchmarks_bitwise(tmp_path, capsys, aggregator):
    got = bench.emo_benchmarks(_benchmark_sets(), num_folds=5,
                               aggregator=aggregator, seed=3,
                               exp_root=str(tmp_path / "t"))
    out = capsys.readouterr().out
    ref = jbench.emo_benchmarks(_benchmark_sets(), num_folds=5,
                                aggregator=aggregator, seed=3,
                                exp_root=str(tmp_path / "j"))
    assert out == capsys.readouterr().out
    assert list(got) == list(ref) == ["rml", "enterface", "afew"]
    for name in got:
        a, b = got[name], ref[name]
        for field in ("dataset", "fold_accuracies", "mean_accuracy",
                      "std_accuracy", "confusion", "classes"):
            assert same_results(getattr(a, field), getattr(b, field)), (name, field)
    assert got["afew"].classes == ["anger", "happiness", "neutral"]
    assert len(got["rml"].fold_accuracies) == 5
    assert bench.canonical_labels(["Surprised", "x"]) == jbench.canonical_labels(
        ["Surprised", "x"])


# -- student_stats, teacher_stats, sample_audio ------------------------------

def _student_logits(seed, imdb, c=8):
    rng = np.random.RandomState(seed)
    labels = jstats.teacher_labels(imdb)
    out = []
    for lab in labels:
        row = rng.randn(1, c).astype(np.float32)
        row[0, lab] += rng.uniform(0, 2)
        out.append(row)
    return out


@pytest.mark.parametrize("partition,temperature,ignore", [
    ("all", 1.0, stats.IGNORE_EMOTIONS), ("all", 2.0, ()),
    ("train", 1.0, ("neutral",)), ("heardVal", 0.5, stats.IGNORE_EMOTIONS)])
def test_student_stats_from_logits_bitwise(emovox, partition, temperature,
                                           ignore):
    logits = _student_logits(7, emovox)
    assert bits_equal(stats.teacher_labels(emovox), jstats.teacher_labels(emovox))
    assert bits_equal(stats.softmax_np(np.stack(logits), temperature, axis=2),
                      jstats.softmax_np(np.stack(logits), temperature, axis=2))
    kw = dict(student_logits=logits, temperature=temperature,
              partition=partition, ignore=ignore)
    got, ref = stats.student_stats(emovox, **kw), jstats.student_stats(emovox, **kw)
    assert got and same_results(got, ref)


def test_student_stats_cache_and_refusals_equal(emovox, tmp_path):
    logits = _student_logits(8, emovox)
    for mod, name in ((stats, "t"), (jstats, "j")):
        path = tmp_path / f"{name}.json"
        first = mod.student_stats(emovox, student_logits=logits,
                                  cache_path=str(path))
        # answered from the cache: no logits needed
        assert same_results(mod.student_stats(emovox, cache_path=str(path)),
                            first)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    per_frame = [np.zeros((3, 8), np.float32)] * emovox.num_tracks
    for mod in (stats, jstats):
        with pytest.raises(ValueError, match="per-frame"):
            mod.student_stats(emovox, student_logits=per_frame)
        with pytest.raises(KeyError, match="unknown partition"):
            mod.student_stats(emovox, student_logits=logits, partition="x")


def _write_face_logits(path, tracks, container):
    if container == "classic":
        import scipy.io

        cell = np.empty((len(tracks),), dtype=object)
        for i, t in enumerate(tracks):
            cell[i] = t
        scipy.io.savemat(path, {"faceLogits": cell})
        return
    import h5py

    ref = h5py.special_dtype(ref=h5py.Reference)
    with h5py.File(path, "w", userblock_size=512) as f:
        refs = f.create_group("#refs#")
        ds = f.create_dataset("faceLogits", shape=(len(tracks), 1), dtype=ref)
        for i, t in enumerate(tracks):
            ds[i, 0] = refs.create_dataset(f"t{i}", data=np.asarray(t).T).ref


@pytest.mark.parametrize("per", ["frame", "wav"])
@pytest.mark.parametrize("container", ["classic", "v73"])
def test_teacher_stats_bitwise(emovox, tmp_path, per, container):
    rng = np.random.RandomState(5)
    afew = [rng.randn(rng.randint(2, 6), 8).astype(np.float32) for _ in range(9)]
    path = tmp_path / "afew-logits.mat"
    _write_face_logits(path, afew, container)
    loaded = teacher.load_face_logits_mat(path)
    assert same_results(loaded, jteacher.load_face_logits_mat(path))
    assert all(bits_equal(a, b) for a, b in zip(loaded, afew))
    got = teacher.teacher_stats(emovox, comparison_path=path, per=per)
    ref = jteacher.teacher_stats(emovox, comparison_logits=afew, per=per)
    assert same_results(got, ref) and list(got) == ["emovoxceleb", "AFEW 6.0"]
    assert same_results(teacher.teacher_stats(emovox, per=per),
                        jteacher.teacher_stats(emovox, per=per))
    for fn in ("frame_prediction_histogram", "dominant_prediction_histogram"):
        assert bits_equal(getattr(teacher, fn)(afew, 8),
                          getattr(jteacher, fn)(afew, 8))
    with pytest.raises(ValueError, match="per must be"):
        teacher.teacher_stats(emovox, per="track")


@pytest.mark.parametrize("per_emotion,emotions", [
    (2, None), (20, None), (1, ("happiness", "fear"))])
def test_sample_audio_bitwise(emovox, tmp_path, per_emotion, emotions):
    kw = dict(per_emotion=per_emotion, seed=4, emotions=emotions,
              make_figures=False)
    got = sample_audio.sample_audio(emovox, tmp_path / "t", **kw)
    ref = jsample.sample_audio(emovox, tmp_path / "j", **kw)
    assert got == ref and any(got.values())
    files = sorted(p.relative_to(tmp_path / "t")
                   for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "j")
                           for p in (tmp_path / "j").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    with pytest.raises(FileExistsError):
        sample_audio.sample_audio(emovox, tmp_path / "t", **kw)


# -- end to end: extraction, then the analysis -------------------------------

@pytest.fixture(scope="module")
def tiny_student():
    variables = random_student_variables(seed=6, fc6=64, fc7=32)
    model = build_student(tiny=True, with_frontend=False, dtype=torch.float32)
    return variables, model, student_state_dict_from_flax(variables)


def test_student_stats_end_to_end(tmp_path, tiny_student):
    variables, model, state = tiny_student
    imdb = jbuild_synthetic_imdb(tmp_path / "wav", num_speakers=3,
                                 tracks_per_speaker=5,
                                 duration_range=(1.1, 1.9), seed=3)
    jm = JaxVGGM(fc6_features=64, fc7_features=32, dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jstats.student_stats(imdb, model=jm, variables=variables,
                                   verbose=False)
    got = stats.student_stats(imdb, model=model, state=state, verbose=False,
                              device="cpu")
    assert list(got) == list(ref) == ["train", "unheardVal", "heardVal"]
    for part in got:
        assert list(got[part]) == list(ref[part])
        for emotion, auc in got[part].items():
            assert abs(auc - ref[part][emotion]) <= 1e-6 or (
                np.isnan(auc) and np.isnan(ref[part][emotion])), (part, emotion)


def test_emo_benchmarks_end_to_end(tmp_path, tiny_student):
    variables, model, state = tiny_student
    tracks = build_synthetic_track_imdb(tmp_path / "rml", tracks_per_class=5,
                                        duration=1.0, seed=2)
    jm = JaxVGGM(fc6_features=64, fc7_features=32, dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        jlogits = jfeats.compute_audio_feats(tracks, model=jm,
                                             variables=variables,
                                             verbose=False)
    logits = tfeats.compute_audio_feats(tracks, model, state, verbose=False,
                                        device="cpu")
    spec = lambda ls: {"rml": dict(track_logits=ls, labels=tracks.labels,  # noqa: E731
                                   classes=list(tracks.classes))}
    got = bench.emo_benchmarks(spec(logits), num_folds=5)["rml"]
    ref = jbench.emo_benchmarks(spec(jlogits), num_folds=5)["rml"]
    assert len(got.fold_accuracies) == 5
    assert got.fold_accuracies == ref.fold_accuracies
    assert got.mean_accuracy == ref.mean_accuracy
