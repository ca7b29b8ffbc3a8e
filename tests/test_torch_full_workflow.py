"""The port's worked example (``mcncrossmodalemotions_torch/examples/
full_workflow.py``) end to end on the CPU, held to the contracts between
stages that ``tests/test_full_workflow.py`` holds the JAX package to:
imdb genesis, the distillation's artifacts, the feature contract, the ROC
outputs and the benchmark's outputs, plus the teacher histogram and sample
packs of stage 4, and ``chip_smoke.py``'s workflow phase holds the
run to its gates.

The example runs with its own teacher, ``tiny_teacher()``: the JAX
example's tiny SENet pipeline with the variables of its ``PRNGKey(0)``
init, which ``mcncrossmodalemotions_torch/examples/tiny_teacher_jax.npz``
carries. That file is rebuilt here from JAX in memory and held bitwise;
this file writes it (``JAX_PLATFORMS=cpu python
tests/test_torch_full_workflow.py --write``).

Stage 1's teacher logits are held to the JAX package's
``fetch_emovoxceleb_imdb`` on the same frames (the port's JPEGs: both
packages read one tree) in two cases: the example's teacher in its own
dtype, bf16, on both sides, within 3e-2 x max|logit| (the bf16 gate of
``test_torch_teacher.py``), every track's argmax label JAX's; and a tiny
SENet with ``random_teacher_variables(seed=0)`` bridged into the port, both
in float32 (JAX at HIGHEST matmul precision), within 1e-4 x max|logit| +
1e-5, as ``test_torch_visual_feats.py`` holds ``build_imdb``. Stage 3's
``meanAuc`` is finite in both partitions and scores the emotions that the
JAX package's ``student_stats`` scores on JAX's imdb of the same tree. One
run of the example, about 60 s of one worker at two threads.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Mapping

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mcncrossmodalemotions_torch.examples import full_workflow  # noqa: E402
from mcncrossmodalemotions_torch.exp import (  # noqa: E402
    fetch_emovoxceleb_imdb as tfetch,
)
from mcncrossmodalemotions_torch.models.resnet import ResNet  # noqa: E402
from mcncrossmodalemotions_torch.models.teacher_pipeline import (  # noqa: E402
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.zoo import (  # noqa: E402
    random_teacher_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.data import native as jnative  # noqa: E402
from mcncrossmodalemotions_tpu.exp import (  # noqa: E402
    fetch_emovoxceleb_imdb as jfetch,
)
from mcncrossmodalemotions_tpu.exp import (  # noqa: E402
    student_stats as jstats,
)
from mcncrossmodalemotions_tpu.exp.ferplus_baselines import (  # noqa: E402
    FerPlusConfig as JFerPlusConfig,
)
from mcncrossmodalemotions_tpu.exp.ferplus_baselines import (  # noqa: E402
    build_pipeline as jbuild_pipeline,
)
from mcncrossmodalemotions_tpu.models.resnet import (  # noqa: E402
    ResNet as JResNet,
)
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (  # noqa: E402
    FaceTeacherPipeline as JPipeline,
)

TINY = dict(stage_sizes=(1, 1), width=8, use_se=True)
RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL = 3e-2  # test_torch_teacher.py's bf16 gate
needs_jax_reader = pytest.mark.skipif(
    not jnative.available(),
    reason="native/libdataservice.so does not load on this host (the JAX "
           "package's frame reader)")


def jax_example_teacher():
    """(model, variables) of the JAX example's teacher
    (``examples/full_workflow.py``): the tiny FER+ pipeline at 48x48, no
    augmentation, initialised from ``PRNGKey(0)``."""
    model = jbuild_pipeline(JFerPlusConfig(tiny_model=True, input_size=48,
                                           dropout=0.0, augment=False))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 48, 48, 1), jnp.uint8))
    return model, variables


def flat_variables(tree: Mapping, prefix: str = "") -> dict:
    """A variables tree as {"params/teacher/conv1/kernel": array, ...}."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(flat_variables(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


@pytest.fixture(scope="module")
def jax_teacher():
    return jax_example_teacher()


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """One run of the example as a user runs it, its own teacher included."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return full_workflow.main(tmp_path_factory.mktemp("wf"), device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_imdb(workflow, jax_teacher, tmp_path_factory):
    """The JAX package's stage 1 over the example's tree with the JAX
    example's teacher (a cache of its own: both packages also keep imdbs
    in memory by root and cache path)."""
    model, variables = jax_teacher
    cache = tmp_path_factory.mktemp("jax-imdb") / "emovoxceleb-imdb.npz"
    return jfetch.fetch_emovoxceleb_imdb(
        workflow["root"] / "voxceleb", model, variables,
        cache_path=str(cache), set_assignment={"spk2": 2}, verbose=False)


def test_teacher_file_is_the_jax_init(jax_teacher):
    """``tiny_teacher_jax.npz`` holds the JAX example's teacher variables bit
    for bit, and ``tiny_teacher()`` loads every one of them."""
    fresh = flat_variables(jax_teacher[1])
    with np.load(full_workflow.TEACHER_VARIABLES) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(stored) == sorted(fresh)
    assert len(fresh) == 55 and sum(v.size for v in fresh.values()) == 10470
    for key, want in fresh.items():
        got = stored[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key
    port = full_workflow.tiny_teacher()
    state = port.state_dict()
    conv1 = stored["params/teacher/conv1/kernel"]
    np.testing.assert_array_equal(
        state["teacher.conv1.weight"].numpy(), conv1.transpose(3, 2, 0, 1))
    assert port.teacher.dtype == torch.bfloat16  # the JAX example's dtype


def test_imdb_genesis_contract(workflow):
    imdb = workflow["imdb"]
    assert imdb.num_tracks == full_workflow.SPEAKERS * full_workflow.TRACKS
    for w, frames in zip(imdb.wav_logits, imdb.dense_frames):
        assert len(frames) == full_workflow.FRAMES
        assert w.shape == (len(frames), 8)
        assert np.isfinite(w).all()
    assert set(imdb.set_id.tolist()) == {1, 2}
    assert (workflow["root"] / "emovoxceleb-imdb.npz").is_file()


def _bridged_fp32(root: Path):
    """Stage 1's build (``build_imdb``) over ``root`` in both packages with
    a tiny fp32 SENet of ``random_teacher_variables(seed=0)``: (port imdb,
    JAX imdb)."""
    v = random_teacher_variables(seed=0, **TINY)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    port = FaceTeacherPipeline(ResNet(dtype=torch.float32, **TINY),
                               input_size=48, augment=False)
    port.load_state_dict(teacher_state_dict_from_flax(nested), strict=True)
    jmodel = JPipeline(teacher=JResNet(dtype=jnp.float32, **TINY),
                       input_size=48, augment=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = tfetch.build_imdb(root, port, port.state_dict(),
                                set_assignment={"spk2": 2}, verbose=False,
                                device="cpu")
    finally:
        torch.set_num_threads(n)
    with jax.default_matmul_precision("highest"):
        ref = jfetch.build_imdb(root, jmodel, nested,
                                set_assignment={"spk2": 2}, verbose=False)
    return got, ref


@needs_jax_reader
@pytest.mark.parametrize("case", ["example-bf16", "bridged-fp32"])
def test_teacher_logits_match_the_jax_package(workflow, jax_imdb, case):
    """The example's stage 1 against JAX's with the JAX example's teacher
    (bf16 gate), and a bridged fp32 teacher's stage 1 over the same tree
    (fp32 gate)."""
    if case == "example-bf16":
        got, ref, rtol, atol = workflow["imdb"], jax_imdb, BF16_RTOL, 0.0
    else:
        got, ref = _bridged_fp32(workflow["root"] / "voxceleb")
        rtol, atol = RTOL, ATOL
    assert list(got.wav_paths) == list(ref.wav_paths)
    np.testing.assert_array_equal(got.set_id, ref.set_id)
    assert [list(f) for f in got.dense_frames] == [list(f)
                                                   for f in ref.dense_frames]
    a, b = np.concatenate(got.wav_logits), np.concatenate(ref.wav_logits)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert a.shape == b.shape and err <= rtol * scale + atol, (err, scale)


@needs_jax_reader
def test_track_labels_match_the_jax_package(workflow, jax_imdb):
    """Every track's teacher label (argmax over emotions of the max over
    its frames) is the one JAX's run gives, and not all are ignored ones."""
    got = jstats.teacher_labels(workflow["imdb"])
    want = jstats.teacher_labels(jax_imdb)
    np.testing.assert_array_equal(got, want)
    ignored = [jstats.EMOTIONS.index(e) for e in jstats.IGNORE_EMOTIONS]
    assert not np.isin(want, ignored).all(), want


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
    """Both partitions are scored: ``meanAuc`` finite in each."""
    aucs = workflow["aucs"]
    assert sorted(aucs) == ["train", "unheardVal"]
    for part, values in aucs.items():
        assert np.isfinite(values["meanAuc"]), (part, values)
    assert (workflow["root"] / "aucs.json").is_file()
    assert list((workflow["root"] / "figs").glob("*.jpg")), \
        "ROC figures should be written"


@needs_jax_reader
def test_scored_emotions_are_the_jax_package_s(workflow, jax_imdb):
    """The emotions stage 3 scores in each partition are those the JAX
    package's ``student_stats`` scores on JAX's imdb of the same tree."""
    want = jstats.student_stats(jax_imdb, student_logits=workflow["logits"],
                                verbose=False)
    got = workflow["aucs"]
    assert sorted(got) == sorted(want)
    for part in want:
        assert sorted(got[part]) == sorted(want[part]), part
        scored = set(want[part]) - {"meanAuc"} - set(jstats.IGNORE_EMOTIONS)
        assert scored, (part, want[part])


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
    that chip_smoke's data phase derives from the example's writers; a run
    whose stage 3 scored nothing in a partition fails it."""
    import copy

    import chip_smoke

    monkeypatch.setattr(full_workflow, "main", lambda *a, **k: workflow)
    wrappers = chip_smoke.KERNEL_NAMES
    chunks = chip_smoke.workflow_shapes(tmp_path)
    counts = chip_smoke.workflow_phase("cpu", tmp_path, wrappers, dev="cpu",
                                       checked_chunks=chunks)
    assert counts == {k: 0 for k in wrappers}  # CPU tensors: plain versions
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.workflow_phase("cpu", tmp_path, wrappers, dev="cpu",
                                  checked_chunks=chunks[1:])
    unscored = dict(workflow, aucs=copy.deepcopy(workflow["aucs"]))
    unscored["aucs"]["unheardVal"]["meanAuc"] = float("nan")
    monkeypatch.setattr(full_workflow, "main", lambda *a, **k: unscored)
    with pytest.raises(chip_smoke.SmokeFailure, match="meanAuc"):
        chip_smoke.workflow_phase("cpu", tmp_path, wrappers, dev="cpu",
                                  checked_chunks=chunks)


def main(argv) -> int:
    if "--write" in argv:
        flat = flat_variables(jax_example_teacher()[1])
        np.savez(full_workflow.TEACHER_VARIABLES, **flat)
        print(f"wrote {full_workflow.TEACHER_VARIABLES}: {len(flat)} arrays, "
              f"{sum(v.size for v in flat.values())} values, "
              f"{full_workflow.TEACHER_VARIABLES.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main(sys.argv[1:]))
