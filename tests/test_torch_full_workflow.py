"""The port's worked example (``mcncrossmodalemotions_torch/examples/
full_workflow.py``) end to end on the CPU, held to the contracts between
stages that ``tests/test_full_workflow.py`` holds the JAX package to:
imdb genesis, the distillation's artifacts, the feature contract, the ROC
outputs and the benchmark's outputs, plus the teacher histogram and sample
packs of stage 4, and ``chip_smoke.py``'s workflow phase holds the
run to its gates.

Stage 1's teacher logits are held to the JAX package's
``fetch_emovoxceleb_imdb`` on the same frames (the port's JPEGs: both
packages read one tree) with the same tiny SENet teacher, its Flax weights
bridged into the port, both in float32 (JAX at HIGHEST matmul precision):
within 1e-4 x max|logit| + 1e-5, as ``test_torch_visual_feats.py`` holds
``build_imdb``. One run of the example, about 60 s of one worker at two
threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.examples import full_workflow
from mcncrossmodalemotions_torch.models.resnet import ResNet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.zoo import (
    random_teacher_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.exp import fetch_emovoxceleb_imdb as jfetch
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)

TINY = dict(stage_sizes=(1, 1), width=8, use_se=True)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def teacher():
    """The tiny SENet teacher at 48x48 in float32: the port's pipeline with
    the bridged weights, and the JAX pipeline with its Flax variables."""
    v = random_teacher_variables(seed=0, **TINY)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    port = FaceTeacherPipeline(ResNet(dtype=torch.float32, **TINY),
                               input_size=48, augment=False)
    port.load_state_dict(teacher_state_dict_from_flax(nested), strict=True)
    jmodel = JPipeline(teacher=JResNet(dtype=jnp.float32, **TINY),
                       input_size=48, augment=False)
    return port, jmodel, nested


@pytest.fixture(scope="module")
def workflow(tmp_path_factory, teacher):
    """One run of the example with the fp32 teacher above in place of its
    seeded one (``tiny_teacher``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(full_workflow, "tiny_teacher", lambda: teacher[0])
        try:
            return full_workflow.main(tmp_path_factory.mktemp("wf"),
                                      device="cpu")
        finally:
            torch.set_num_threads(n)


def test_imdb_genesis_contract(workflow):
    imdb = workflow["imdb"]
    assert imdb.num_tracks == full_workflow.SPEAKERS * full_workflow.TRACKS
    for w, frames in zip(imdb.wav_logits, imdb.dense_frames):
        assert len(frames) == full_workflow.FRAMES
        assert w.shape == (len(frames), 8)
        assert np.isfinite(w).all()
    assert set(imdb.set_id.tolist()) == {1, 2}
    assert (workflow["root"] / "emovoxceleb-imdb.npz").is_file()


@pytest.mark.skipif(not jnative.available(),
                    reason="native/libdataservice.so does not load on this "
                           "host (the JAX package's frame reader)")
def test_teacher_logits_match_the_jax_package(workflow, teacher):
    _, jmodel, nested = teacher
    with jax.default_matmul_precision("highest"):
        ref = jfetch.fetch_emovoxceleb_imdb(
            workflow["root"] / "voxceleb", jmodel, nested,
            set_assignment={"spk2": 2}, verbose=False)
    got = workflow["imdb"]
    assert list(got.wav_paths) == list(ref.wav_paths)
    np.testing.assert_array_equal(got.set_id, ref.set_id)
    assert [list(f) for f in got.dense_frames] == [list(f)
                                                   for f in ref.dense_frames]
    a, b = np.concatenate(got.wav_logits), np.concatenate(ref.wav_logits)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert a.shape == b.shape and err <= RTOL * scale + ATOL, (err, scale)


def test_distillation_artifacts(workflow):
    exp_dir = workflow["exp_dir"]
    assert (exp_dir / "net-epoch-20.pt").exists()
    assert (exp_dir / "metrics.jsonl").exists()
    assert len(workflow["history"]) == 20
    assert np.isfinite(workflow["history"][-1]["train"]["loss"])


def test_student_features_contract(workflow):
    logits = workflow["logits"]
    assert len(logits) == workflow["imdb"].num_tracks
    assert all(l.shape == (1, 8) and np.isfinite(l).all() for l in logits)
    assert (workflow["root"] / "student-feats.npz").is_file()


def test_roc_analysis_outputs(workflow):
    aucs = workflow["aucs"]
    assert "train" in aucs
    for part, values in aucs.items():
        assert "meanAuc" in values
    assert (workflow["root"] / "aucs.json").is_file()
    assert list((workflow["root"] / "figs").glob("*.jpg")), \
        "ROC figures should be written"


def test_analysis_extras(workflow):
    """The teacher histogram counts every frame; each sampled track's wav
    is in its emotion's pack."""
    root = workflow["root"]
    assert (root / "figs" / "teacher-hist.pdf").is_file()
    hist = workflow["teacher_hist"]["emovoxceleb"]
    assert hist.sum() == sum(len(w) for w in workflow["imdb"].wav_logits)
    picked = sum(len(v) for v in workflow["samples"].values())
    assert picked > 0
    assert len(list((root / "samples").rglob("*.wav"))) == picked


def test_benchmark_outputs(workflow):
    result = workflow["results"]["rml"]
    n = len(workflow["rml"].classes)
    assert len(workflow["rml_logits"]) == len(workflow["rml"].labels)
    assert 0.0 <= result.mean_accuracy <= 1.0
    assert result.confusion.shape == (n, n)
    assert (workflow["root"] / "figs" / "rml-confusion.pdf").exists()


def test_example_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        full_workflow.main(tmp_path)
    assert not list(tmp_path.iterdir())  # it stopped before stage 0


def test_chip_smoke_workflow_phase_holds_the_run(workflow, tmp_path,
                                                 monkeypatch):
    """chip_smoke's workflow phase passes this run (the example replaced by
    its result here): its artifacts, and its extraction chunks are those
    that chip_smoke's data phase derives from the example's writers."""
    import chip_smoke

    monkeypatch.setattr(full_workflow, "main", lambda *a, **k: workflow)
    wrappers = chip_smoke.kernel_wrappers()
    chunks = chip_smoke.workflow_shapes(tmp_path)
    counts = chip_smoke.workflow_phase("cpu", tmp_path, wrappers, dev="cpu",
                                       checked_chunks=chunks)
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.workflow_phase("cpu", tmp_path, wrappers, dev="cpu",
                                  checked_chunks=chunks[1:])
