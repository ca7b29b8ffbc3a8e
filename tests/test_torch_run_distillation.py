"""The port's offline ``run_distillation`` and its engine, on the CPU.

- ``DistillationConfig`` has the JAX dataclass's fields and defaults, and
  ``exp_name()`` gives the JAX string for the same config;
- a tiny run (tiny student, 1 s crops, batch 2) of 2 epochs on a synthetic
  imdb writes checkpoints 1 and 2 and ``metrics.jsonl`` with a finite
  loss; a second call with ``num_epochs=3`` resumes at epoch 3; a corrupt
  latest checkpoint falls back to the one before it;
- the engine's helpers (LR schedule, mini-epochs, split, class stats)
  agree with the JAX ones;
- ``from_scratch=False`` starts from a released student ``.mat`` (a path;
  a registry name raises, nothing is downloaded): epoch 0's weights are
  the release's, the run trains and resumes;
- ``load_student_from_exp`` rebuilds the student of a port experiment
  directory (latest, ``'best'``, an int epoch, past a corrupt latest
  checkpoint) bitwise equal to the checkpoint's ``state_dict``, and of a
  JAX experiment directory (``net-epoch-N.msgpack``) bitwise equal to the
  bridge of the JAX variables, with the JAX forward's logits;
  ``read_latest_run_config`` reads either package's run metadata alike.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from mcncrossmodalemotions_tpu.exp import run_distillation as jrd
from mcncrossmodalemotions_tpu.train import engine as jengine
from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
from mcncrossmodalemotions_torch.exp import run_distillation as rd
from mcncrossmodalemotions_torch.train import checkpoints as ckpt
from mcncrossmodalemotions_torch.train import engine

TINY_RUN = dict(batch_size=2, num_seconds=1.0, tiny_model=True,
                mini_epoch_ratio=1.0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The runs take about a second on two threads; with all cores, beside
    other test processes, torch's thread pool spins and takes ~20x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def imdb(tmp_path_factory):
    return build_synthetic_imdb(tmp_path_factory.mktemp("rd") / "wav",
                                num_speakers=3, tracks_per_speaker=4,
                                duration_range=(1.2, 2.0))


def test_config_fields_and_defaults_equal_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jrd.DistillationConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(rd.DistillationConfig)}
    assert tf == jf


@pytest.mark.parametrize("overrides", [
    {},
    dict(loss_type="euclidean", temperature=1.0, num_seconds=3.0, seed=2,
         tiny_model=True, weight_decay=0.0, num_epochs=7),
    dict(dropout=0.5, mulaw_feed=True, speed_aug=True, noise_num=3,
         noise_dir="/n", from_scratch=False, online_teacher=True),
])
def test_exp_name_equals_jax(overrides):
    assert (rd.DistillationConfig(**overrides).exp_name()
            == jrd.DistillationConfig(**overrides).exp_name())


def _run(imdb, out_root, num_epochs):
    cfg = rd.DistillationConfig(num_epochs=num_epochs, out_root=str(out_root),
                                **TINY_RUN)
    return rd.run_distillation(cfg, imdb, device="cpu")


def test_two_epochs_then_resume_at_three(imdb, tmp_path):
    state, history, exp_dir = _run(imdb, tmp_path, 2)
    assert [h["epoch"] for h in history] == [1, 2]
    assert [e for e, _ in ckpt.list_checkpoints(exp_dir)] == [1, 2]
    records = [json.loads(line) for line in
               (exp_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    for r in records:
        assert np.isfinite(r["train"]["loss"]) and np.isfinite(r["val"]["loss"])
        assert r["train"]["num_samples"] == 6  # 6 train tracks, batch 2
        assert 0.0 <= r["train"]["feed_bound_frac"] <= 1.0
    assert state.step == 6
    assert len(list(exp_dir.glob("meta-*.json"))) >= 1
    assert exp_dir.name == jrd.DistillationConfig(
        num_epochs=2, out_root=str(tmp_path), **TINY_RUN).exp_name()

    state, history, exp_dir2 = _run(imdb, tmp_path, 3)
    assert exp_dir2 == exp_dir  # num_epochs is not part of the identity
    assert [h["epoch"] for h in history] == [3]
    assert state.step == 9
    assert [e for e, _ in ckpt.list_checkpoints(exp_dir)] == [1, 2, 3]


def test_corrupt_latest_checkpoint_falls_back(imdb, tmp_path):
    _, _, exp_dir = _run(imdb, tmp_path, 2)
    latest = ckpt.checkpoint_path(exp_dir, 2)
    latest.write_bytes(latest.read_bytes()[:100])  # a truncated write
    state, history, _ = _run(imdb, tmp_path, 3)
    assert [h["epoch"] for h in history] == [2, 3]  # resumed from epoch 1
    assert state.step == 9


def test_checkpoint_round_trip_and_mismatch_raises(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = engine.TrainState.create(model, torch.Generator().manual_seed(5))
    state.velocity["weight"].fill_(0.25)
    state.step = 4
    ckpt.save_checkpoint(tmp_path, 1, state, {"val": {"classerror": 0.5}})
    ckpt.save_checkpoint(tmp_path, 2, state, {"val": {"classerror": 0.25}})
    draw = torch.rand(3, generator=state.generator)
    other = engine.TrainState.create(torch.nn.Linear(3, 2), torch.Generator())
    epoch, other = ckpt.load_latest(tmp_path, other)
    assert epoch == 2 and other.step == 4
    assert torch.equal(other.model.weight, model.weight)
    assert torch.equal(other.velocity["weight"], state.velocity["weight"])
    assert torch.equal(torch.rand(3, generator=other.generator), draw)
    assert ckpt.find_best_epoch(tmp_path) == 2
    assert ckpt.find_best_epoch(tmp_path, mode="max", prune=True) == 1
    assert [e for e, _ in ckpt.list_checkpoints(tmp_path)] == [1]
    wrong = engine.TrainState.create(torch.nn.Linear(4, 2), torch.Generator())
    with pytest.raises(RuntimeError):  # a changed model is not "corrupt"
        ckpt.load_latest(tmp_path, wrong)


def test_resume_requires_the_generator_state(tmp_path):
    """A training resume restores the dropout generator; a checkpoint
    without its state raises rather than resume on a fresh stream."""
    state = engine.TrainState.create(torch.nn.Linear(3, 2),
                                     torch.Generator().manual_seed(5))
    path = ckpt.save_checkpoint(tmp_path, 1, state, {})
    record = ckpt.read_checkpoint(path)
    del record["generator"]
    torch.save(record, path)
    other = engine.TrainState.create(torch.nn.Linear(3, 2), torch.Generator())
    with pytest.raises(KeyError, match="generator"):
        ckpt.load_latest(tmp_path, other)


@pytest.mark.parametrize("field,value", [("online_teacher", True),
                                         ("remat_policy", "drop_conv1"),
                                         ("mulaw_feed", True),
                                         ("speed_aug", True),
                                         ("noise_num", 2)])
def test_modes_build_their_runs_in_jax_dirs(imdb, tmp_path, field, value):
    """Each mode of the driver builds its run (0 epochs) in the JAX
    package's directory; what it needs and lacks raises ValueError as in
    the JAX driver, and ``mesh="auto"`` under a group whose world size
    does not split the batch raises (``auto_mesh``'s rule)."""
    kw = dict(TINY_RUN, num_epochs=0, out_root=str(tmp_path), **{field: value})
    cfg = rd.DistillationConfig(**kw)
    needs = {"online_teacher": "teacher_model", "noise_num": "noise_dir"}
    if field in needs:
        with pytest.raises(ValueError, match=needs[field]):
            rd.run_distillation(cfg, imdb, device="cpu")
        extra = {"noise_num": dict(noise_dir=str(tmp_path))}.get(field, {})
        cfg = rd.DistillationConfig(**kw, **extra)
    teacher = None
    if field == "online_teacher":
        imdb = dataclasses.replace(imdb, dense_frames=[
            np.asarray(["f.jpg"], dtype=object)] * imdb.num_tracks)
        teacher = torch.nn.Identity()
    state, history, exp_dir = rd.run_distillation(cfg, imdb, device="cpu",
                                                  teacher_model=teacher)
    assert history == [] and state.step == 0
    assert exp_dir.name == jrd.DistillationConfig(
        **dataclasses.asdict(cfg)).exp_name()
    from mcncrossmodalemotions_torch.parallel import mesh as pmesh

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pmesh, "world_size", lambda: 3)
        with pytest.raises(ValueError, match="does not split over 3 ranks"):
            rd.run_distillation(cfg, imdb, device="cpu",
                                teacher_model=teacher)


def test_engine_helpers_match_jax(imdb):
    for lr in (1e-3, (1e-2, 5e-3, 2e-3)):
        for epoch in (1, 2, 5):
            assert (engine.lr_for_epoch(engine.TrainConfig(learning_rate=lr), epoch)
                    == jengine.lr_for_epoch(jengine.TrainConfig(learning_rate=lr),
                                            epoch))
    assert engine.logspace_lr(-4, -5, 7) == jengine.logspace_lr(-4, -5, 7)
    for args in ((1000, 0.05, 1, 64), (100, 0.05, 1, 64), (100, 0.5, 4, 8)):
        assert rd.mini_epoch_size(*args) == jrd.mini_epoch_size(*args)
    for a, b in zip(rd.split_imdb(imdb, 0.5, 0), jrd.split_imdb(imdb, 0.5, 0)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(a.wav_paths, b.wav_paths)
    result = {"loss": 1.5, "class_correct": np.array([2.0, 0, 1]),
              "class_pop": np.array([4.0, 0, 2])}
    names = ("a", "b", "c")
    assert (engine.summarize_class_stats(result, names)
            == jengine.summarize_class_stats(result, names))


def test_metric_averager_weights_by_batch_size():
    avg = engine.MetricAverager()
    avg.update({"loss": torch.tensor(1.0), "class_pop": torch.tensor([1.0, 0])}, 2)
    avg.update({"loss": torch.tensor(4.0), "class_pop": torch.tensor([0.0, 3])}, 1)
    out = avg.result()
    assert out["loss"] == pytest.approx(2.0)
    np.testing.assert_array_equal(out["class_pop"], [1.0, 3.0])


# -- from a release, and back from an experiment directory -------------------

FC6, FC7 = 64, 32


def _release_mat(path):
    """A classic MatConvNet student release of the test's widths, conv
    biases nonzero (the smoke run's writer)."""
    chip_smoke.student_release(path, fc6=FC6, fc7=FC7)
    return path


def _release_cfg(tmp_path, num_epochs):
    mat = tmp_path / "release.mat"
    if not mat.exists():
        _release_mat(mat)
    return rd.DistillationConfig(num_epochs=num_epochs, out_root=str(tmp_path),
                                 from_scratch=False,
                                 pretrained_student=str(mat),
                                 **dict(TINY_RUN, tiny_model=False))


def test_from_release_starts_from_its_weights_then_trains(imdb, tmp_path):
    from mcncrossmodalemotions_torch.zoo import load_pretrained_student

    release, _ = load_pretrained_student(
        _release_mat(tmp_path / "release.mat"), device="cpu")
    state, history, exp_dir = rd.run_distillation(_release_cfg(tmp_path, 0),
                                                  imdb, device="cpu")
    assert history == [] and state.step == 0
    for k, v in release.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert exp_dir.name == jrd.DistillationConfig(
        from_scratch=False, pretrained_student=str(tmp_path / "release.mat"),
        **dict(TINY_RUN, tiny_model=False)).exp_name()
    state, history, _ = rd.run_distillation(_release_cfg(tmp_path, 2), imdb,
                                            device="cpu")
    assert [h["epoch"] for h in history] == [1, 2] and state.step == 6
    assert all(np.isfinite(h["train"]["loss"]) for h in history)
    assert state.model.net.fc6.weight.shape[0] == FC6
    assert not torch.equal(state.model.net.conv1.weight,
                           release.net.conv1.weight)
    _, history, _ = rd.run_distillation(_release_cfg(tmp_path, 3), imdb,
                                        device="cpu")
    assert [h["epoch"] for h in history] == [3]


def test_from_release_takes_a_path_not_a_name(imdb, tmp_path, monkeypatch):
    """``pretrained_student`` resolves through the artifact registry as in
    the JAX driver: the default name from a tree placed by hand (no
    download: the file is there), a missing path that is no name raises
    FileNotFoundError, and the name's miss without downloads raises
    ArtifactUnavailable."""
    from mcncrossmodalemotions_torch.zoo.artifacts import (
        ArtifactUnavailable,
        artifact_path,
    )

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "tree"))
    cfg = rd.DistillationConfig(out_root=str(tmp_path), from_scratch=False,
                                **dict(TINY_RUN, num_epochs=0))
    assert cfg.pretrained_student == "emovoxceleb-student"
    with pytest.raises(ArtifactUnavailable):
        rd.load_pretrained_student(cfg.pretrained_student, download=False,
                                   device="cpu")
    path = artifact_path("emovoxceleb-student")
    path.parent.mkdir(parents=True)
    chip_smoke.student_release(path, fc6=64, fc7=32)
    state, history, _ = rd.run_distillation(cfg, imdb, device="cpu")
    assert history == [] and state.model.net.fc6.weight.shape[0] == 64
    cfg = dataclasses.replace(cfg, pretrained_student=str(tmp_path / "no.mat"))
    with pytest.raises(FileNotFoundError, match="ARTIFACTS"):
        rd.run_distillation(cfg, imdb, device="cpu")


def _ckpt_state(exp_dir, epoch):
    return ckpt.read_checkpoint(ckpt.checkpoint_path(exp_dir, epoch))["model"]


def test_load_student_from_exp_epochs(imdb, tmp_path):
    _, history, exp_dir = _run(imdb, tmp_path, 3)
    errors = {h["epoch"]: h["val"]["classerror"] for h in history}
    best = ckpt.find_best_epoch(exp_dir)
    assert errors[best] == min(errors.values())
    for epoch, want_epoch in ((None, 3), ("best", best), (2, 2), (1, 1)):
        model, state = rd.load_student_from_exp(exp_dir, epoch, device="cpu")
        want = _ckpt_state(exp_dir, want_epoch)
        assert isinstance(model, rd.VGGMStudent)
        assert sorted(state) == sorted(k[len("net."):] for k in want)
        for k, v in state.items():
            assert torch.equal(v, want["net." + k]), (epoch, k)
            assert torch.equal(model.state_dict()[k], v)
    model, state = rd.load_student_from_exp(exp_dir, 2, with_frontend=True,
                                            device="cpu")
    assert isinstance(model, rd.AudioStudentPipeline)
    want = _ckpt_state(exp_dir, 2)
    assert all(torch.equal(state[k], v) for k, v in want.items())
    # a corrupt latest checkpoint: the latest readable one
    latest = ckpt.checkpoint_path(exp_dir, 3)
    latest.write_bytes(latest.read_bytes()[:64])
    _, state = rd.load_student_from_exp(exp_dir, device="cpu")
    assert all(torch.equal(v, want["net." + k]) for k, v in state.items())
    with pytest.raises(ckpt.CorruptCheckpointError):
        rd.load_student_from_exp(exp_dir, 3, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint for epoch 7"):
        rd.load_student_from_exp(exp_dir, 7, device="cpu")
    with pytest.raises(FileNotFoundError, match="meta"):
        rd.load_student_from_exp(tmp_path, device="cpu")


def test_load_student_from_a_jax_exp_dir(tmp_path):
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
    from mcncrossmodalemotions_tpu.train import checkpoints as jckpt
    from mcncrossmodalemotions_tpu.train.state import TrainState as JaxState
    from mcncrossmodalemotions_tpu.utils.config import write_run_meta
    from mcncrossmodalemotions_torch.zoo import (
        random_student_variables,
        student_state_dict_from_flax,
    )

    cfg = jrd.DistillationConfig(tiny_model=True, out_root=str(tmp_path))
    exp_dir = tmp_path / cfg.exp_name()
    write_run_meta(exp_dir, cfg)
    variables = {}
    for epoch, err in ((1, 0.25), (2, 0.5), (3, 0.75)):
        v = random_student_variables(seed=epoch, fc6=FC6, fc7=FC7)
        variables[epoch] = v
        nested = {k: {"net": jax.tree.map(jnp.asarray, t)} for k, t in v.items()}
        jckpt.save_checkpoint(exp_dir, epoch,
                              JaxState.create(nested, jax.random.PRNGKey(0)),
                              {"val": {"classerror": err}})
    assert rd.read_latest_run_config(exp_dir, rd.DistillationConfig) == \
        rd.DistillationConfig(**dataclasses.asdict(cfg))
    x = np.random.RandomState(0).randn(2, 512, 100, 1).astype(np.float32)
    jm = JaxVGGM(fc6_features=FC6, fc7_features=FC7, dtype=np.float32)
    for epoch, want_epoch in ((None, 3), ("best", 1), (2, 2)):
        model, state = rd.load_student_from_exp(exp_dir, epoch, device="cpu")
        want = student_state_dict_from_flax(variables[want_epoch])
        assert sorted(state) == sorted(want)
        for k, v in want.items():
            assert torch.equal(state[k], v), (epoch, k)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jm.apply(variables[want_epoch], jnp.asarray(x)))
        assert isinstance(model, rd.VGGMStudent)
        fp32 = rd.VGGMStudent(fc6_features=FC6, fc7_features=FC7,
                              dtype=torch.float32)
        fp32.load_state_dict(state)
        with torch.inference_mode():
            got = fp32(torch.from_numpy(x), train=False).numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    latest = exp_dir / "net-epoch-3.msgpack"
    latest.write_bytes(latest.read_bytes()[:-10])
    _, state = rd.load_student_from_exp(exp_dir, device="cpu")
    want = student_state_dict_from_flax(variables[2])
    assert all(torch.equal(state[k], v) for k, v in want.items())


def test_read_latest_run_config_equals_jax(tmp_path):
    from mcncrossmodalemotions_tpu.utils import config as jconfig
    from mcncrossmodalemotions_torch.utils import config

    rd.write_run_meta(tmp_path / "a", rd.DistillationConfig(seed=4, dropout=0.5))
    for exp in (tmp_path / "a",):
        assert (config.read_latest_run_config(exp, rd.DistillationConfig)
                == jconfig.read_latest_run_config(exp, rd.DistillationConfig))
    for mod in (config, jconfig):
        with pytest.raises(FileNotFoundError, match="no meta"):
            mod.read_latest_run_config(tmp_path, rd.DistillationConfig)
