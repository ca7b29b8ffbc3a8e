"""The port's FER+ teacher entry points against the JAX package's, on the CPU.

- ``FerPlusConfig``: the JAX config's fields and defaults, and the same
  ``exp_name()`` for several configs (both packages resolve one experiment
  directory); ``step_lr`` and ``teacher_loss_fn`` (loss and metrics, both
  losses, a ragged ``pad_mask``) equal.
- ``ferplus_baselines`` end to end on ``device="cpu"`` (tiny SENet and
  VGG-M-bn, 48x48 inputs): 2 epochs, a resume to 3 that runs epoch 3 alone,
  eval-only from the latest checkpoint equal to the last val epoch and from
  the best one equal to that epoch's; eval-only without a checkpoint and
  on a base release's fresh head refused; fine-tuning from a VGGFace2 and a
  classic base ``.mat``; the 'clean' and 'full' dataTypes; ``mesh``
  refused; ``benchmark_ferplus_models`` writes its cache, reads it back
  without evaluating, and ``refresh`` evaluates again.
- ``prepare_teacher_from_base`` and ``prepare_classic_from_base`` on
  synthetic ``.mat`` files (conv biases folded into the BN means): the
  backbone equal to the JAX package's, bit for bit, the head resized to 8
  with a zero bias.
- ``load_teacher_from_exp`` on an experiment directory the JAX package
  wrote (its meta dump, msgpack TrainStates): logits within 1e-5 x
  max|ref| of the JAX package's own reload, in fp32; ``restore_from_exp``
  maps its weights and velocity bit for bit; and on the port's run, feeding
  ``compute_visual_feats``.
- ``check_results`` equal to the JAX package's; ``reproduce_ferplus`` on
  synthetic csvs and released tiny teachers; the dev-checkpoint registry.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcncrossmodalemotions_torch.data.ferplus import build_synthetic_ferplus
from mcncrossmodalemotions_torch.exp import ferplus_baselines as fb
from mcncrossmodalemotions_torch.exp import reproduce_ferplus as rf
from mcncrossmodalemotions_torch.zoo import registry, teacher_state_dict_from_flax
from mcncrossmodalemotions_tpu.exp import ferplus_baselines as jfb
from mcncrossmodalemotions_tpu.exp import reproduce_ferplus as jrf
from mcncrossmodalemotions_tpu.zoo import registry as jregistry

TINY = dict(batch_size=8, tiny_model=True, input_size=48, dropout=0.0,
            lr_values=(0.05,), lr_epochs=(2,))


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def imdb():
    return build_synthetic_ferplus(60, seed=0)


@pytest.mark.parametrize("kw", [
    {}, dict(model="resnet50-ferplus", loss_type="softmaxlog"),
    dict(dropout=0.1, input_size=48, tiny_model=True, seed=3),
    dict(data_type="clean", use_bnorm=False, augment_at_target=True),
    dict(model="vgg-m-face-bn", num_classes=10, data_type="full",
         pretrained_mat="/x/base.mat", use_bnorm=True, finetune_lr=1.0),
])
def test_config_and_exp_name_equal_jax(kw):
    ours, theirs = fb.FerPlusConfig(**kw), jfb.FerPlusConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.exp_name() == theirs.exp_name()


def test_step_lr_and_teacher_loss_equal_jax():
    assert fb.step_lr((0.1, 0.01), (2, 3)) == jfb.step_lr((0.1, 0.01), (2, 3))
    rng = np.random.RandomState(0)
    batch = {"hard_label": rng.randint(0, 8, 6).astype(np.int32),
             "label_dist": rng.dirichlet(np.ones(8), 6).astype(np.float32),
             "pad_mask": np.float32([1, 1, 0, 1, 1, 1])}
    logits = rng.randn(6, 8).astype(np.float32) * 3
    for loss in ("distributions", "softmaxlog"):
        tl, tm = registry.teacher_loss_fn(loss)(
            torch.from_numpy(logits), {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        jl, jm = jregistry.teacher_loss_fn(loss)(
            jnp.asarray(logits), {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert sorted(tm) == sorted(jm)
        for key in tm:
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                       rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="unknown loss_type"):
        registry.teacher_loss_fn("hinge")(torch.from_numpy(logits), {
            k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("model", ["senet50-ferplus", "vgg-m-face-bn"])
def test_ferplus_baselines_trains_resumes_and_evaluates(tmp_path, imdb, model):
    cfg = fb.FerPlusConfig(model=model, out_root=str(tmp_path), **TINY)
    exp = tmp_path / cfg.exp_name()
    with pytest.raises(ValueError, match="no trained checkpoint"):
        fb.ferplus_baselines(cfg, imdb, evaluate_only="val", device="cpu")
    _, history = fb.ferplus_baselines(cfg, imdb, device="cpu")
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["train"]["loss"]) for h in history)
    assert sorted(p.name for p in exp.glob("net-epoch-*.pt")) == [
        "net-epoch-1.pt", "net-epoch-2.pt"]
    longer = dataclasses.replace(cfg, lr_epochs=(3,))
    assert longer.exp_name() == cfg.exp_name()
    _, resumed = fb.ferplus_baselines(longer, imdb, device="cpu")
    assert [h["epoch"] for h in resumed] == [3]  # no epoch run twice
    records = history + resumed
    _, latest = fb.ferplus_baselines(longer, imdb, evaluate_only="val",
                                     device="cpu")
    assert latest["accuracy"] == pytest.approx(
        1.0 - records[-1]["val"]["classerror"], abs=1e-12)
    best = min(records, key=lambda h: h["val"]["classerror"])
    _, from_best = fb.ferplus_baselines(longer, imdb, evaluate_only="val",
                                        use_best_epoch=True, device="cpu")
    assert from_best["accuracy"] == pytest.approx(
        1.0 - best["val"]["classerror"], abs=1e-12)
    _, test = fb.ferplus_baselines(longer, imdb, evaluate_only="test",
                                   device="cpu")
    assert test["num_samples"] == int((imdb.set_id == 3).sum())
    # the trained teacher reloads and feeds the dense path
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        VisualFeatureExtractor,
    )

    pipe, state = fb.load_teacher_from_exp(exp, device="cpu")
    assert not pipe.augment and pipe.teacher.dropout_rate == 0.0
    frames = [str(p) for p in sorted(chip_smoke.FACES.glob("*.jpg"))[:3]]
    ext = VisualFeatureExtractor(pipe, state, batch_size=3, input_size=48,
                                 device="cpu")
    got = ext.frame_logits(frames, verbose=False)
    with torch.no_grad():
        own = pipe(torch.from_numpy(ext._decode(frames))).float().numpy()
    np.testing.assert_array_equal(got, own)
    bare, bare_state = fb.load_teacher_from_exp(exp, epoch="best",
                                                with_pipeline=False,
                                                device="cpu")
    assert not any(k.startswith("teacher.") for k in bare_state)
    assert type(bare) is type(pipe.teacher)


def test_data_types_and_mesh(tmp_path, imdb):
    kw = dict(TINY, lr_epochs=(1,), out_root=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 15"):
        fb.ferplus_baselines(fb.FerPlusConfig(**kw), imdb, mesh=object(),
                             device="cpu")
    with pytest.raises(ValueError, match="10-class"):
        fb.ferplus_baselines(fb.FerPlusConfig(data_type="full", **kw), imdb,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown dataType"):
        fb.ferplus_baselines(fb.FerPlusConfig(data_type="dirty", **kw), imdb,
                             device="cpu")
    _, h = fb.ferplus_baselines(fb.FerPlusConfig(
        data_type="full", num_classes=10, **kw), imdb, device="cpu")
    assert np.isfinite(h[0]["train"]["loss"])
    _, h = fb.ferplus_baselines(fb.FerPlusConfig(
        data_type="clean", **kw), imdb, mesh=None, device="cpu")
    assert np.isfinite(h[0]["train"]["loss"])


def test_benchmark_cache_and_refresh(tmp_path, imdb, monkeypatch):
    base = fb.FerPlusConfig(**dict(TINY, lr_epochs=(1,)))
    models = (("senet50-ferplus", "distributions"),)
    cfg = dataclasses.replace(base, out_root=str(tmp_path))
    fb.ferplus_baselines(cfg, imdb, device="cpu")
    kw = dict(out_root=str(tmp_path), models=models, tiny_model=True,
              base_cfg=base, cache_dir=str(tmp_path / "cache"), device="cpu")
    first = fb.benchmark_ferplus_models(imdb, **kw)
    row = first["senet50-ferplus"]
    assert sorted(row) == ["testAcc", "valAcc"]
    assert json.loads((tmp_path / "cache" / f"{cfg.exp_name()}.json")
                      .read_text()) == row
    calls = []
    real = fb.ferplus_baselines
    monkeypatch.setattr(fb, "ferplus_baselines",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    assert fb.benchmark_ferplus_models(imdb, **kw) == first
    assert calls == []  # served by the cache
    assert fb.benchmark_ferplus_models(imdb, refresh=True, **kw) == first
    assert [c["evaluate_only"] for c in calls] == ["val", "test"]


def _tiny_classic(monkeypatch):
    """build_teacher at the tiny width in both zoos (prepare_classic_from_base
    builds its module by name, full width otherwise)."""
    monkeypatch.setattr(registry, "build_teacher",
                        functools.partial(registry.build_teacher, tiny=True))
    from mcncrossmodalemotions_tpu.models.vggface import VGGFace as JVGGFace

    monkeypatch.setattr(jregistry, "build_teacher", lambda *a, **k: JVGGFace(
        arch="m", width_multiplier=1 / 16, fc_features=64,
        num_outputs=k.get("num_outputs", 8), use_batchnorm=True))


def _same_backbone(state, jvars, head="prediction"):
    jstate = teacher_state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    assert sorted(state) == sorted(jstate)
    for key in state:
        if head in key.split("."):
            continue
        np.testing.assert_array_equal(state[key].numpy(), jstate[key].numpy(),
                                      err_msg=key)
    assert state["prediction.weight"].shape[0] == 8
    assert torch.equal(state["prediction.bias"], torch.zeros(8))
    assert abs(float(state["prediction.weight"].std()) - 0.01) < 0.005


def test_prepare_from_base_equals_jax(tmp_path, monkeypatch):
    path = tmp_path / "senet50_ft-dag.mat"
    chip_smoke.teacher_release(path, seed=4, use_se=True, stage_sizes=(1, 1),
                               width=8)
    model, state = registry.prepare_teacher_from_base(path, device="cpu")
    assert model.use_se and model.stage_sizes == (1, 1)
    _, jvars = jregistry.prepare_teacher_from_base(path, download=False)
    _same_backbone(state, jvars)
    _tiny_classic(monkeypatch)
    path = tmp_path / "vgg-m-face-bn.mat"
    chip_smoke.classic_release(path, seed=5, num_outputs=20, input_size=96,
                               width_multiplier=1 / 16, fc_features=64)
    model, state = registry.prepare_classic_from_base(
        path, "vgg-m-face-bn", input_size=96, device="cpu")
    assert model.arch == "m" and model.use_batchnorm
    _, jvars = jregistry.prepare_classic_from_base(path, "vgg-m-face-bn",
                                                   download=False)
    _same_backbone(state, jvars)
    with pytest.raises(FileNotFoundError, match="ARTIFACTS"):
        registry.prepare_classic_from_base(tmp_path / "no.mat", "vgg_face",
                                           device="cpu")
    from mcncrossmodalemotions_torch.zoo.artifacts import ArtifactUnavailable

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path / "cache"))
    with pytest.raises(ArtifactUnavailable, match="senet50_ft-dag"):
        registry.prepare_teacher_from_base("senet50_ft-dag", download=False,
                                           device="cpu")


def test_finetune_from_bases_and_the_fresh_head_refusal(tmp_path, imdb,
                                                         monkeypatch):
    kw = dict(TINY, lr_epochs=(1,), out_root=str(tmp_path))
    path = tmp_path / "senet50_ft-dag.mat"
    chip_smoke.teacher_release(path, seed=4, use_se=True, stage_sizes=(1, 1),
                               width=8, average_image=(100.0, 90.0, 80.0))
    cfg = fb.FerPlusConfig(model="senet50_ft-dag", pretrained_mat=str(path),
                           **kw)
    with pytest.raises(ValueError, match="nothing trained"):
        fb.ferplus_baselines(cfg, imdb, evaluate_only="val", device="cpu")
    _, history = fb.ferplus_baselines(cfg, imdb, device="cpu")
    assert np.isfinite(history[0]["train"]["loss"])
    pipe, _ = fb.load_teacher_from_exp(tmp_path / cfg.exp_name(),
                                       device="cpu")
    assert pipe.mean_rgb == (100.0, 90.0, 80.0)  # the release's own mean
    _tiny_classic(monkeypatch)
    path = tmp_path / "vgg-m-face-bn.mat"
    chip_smoke.classic_release(path, seed=5, num_outputs=20, input_size=48,
                               width_multiplier=1 / 16, fc_features=64)
    cfg = fb.FerPlusConfig(model="vgg-m-face-bn", pretrained_mat=str(path),
                           **kw)
    _, history = fb.ferplus_baselines(cfg, imdb, device="cpu")
    assert np.isfinite(history[0]["train"]["loss"])
    pipe, _ = fb.load_teacher_from_exp(tmp_path / cfg.exp_name(),
                                       device="cpu")
    assert pipe.mean_rgb == pytest.approx((129.1863, 104.7624, 93.594))


def test_load_teacher_from_a_jax_run(tmp_path, imdb):
    """A JAX package experiment directory (its run metadata, two msgpack
    TrainStates of a tiny SENet pipeline with a nonzero velocity, their
    metrics): the best epoch reloads in both packages to the same logits;
    ``restore_from_exp`` maps its weights and velocity through the
    bridge; eval-only runs from it."""
    from mcncrossmodalemotions_torch.train import checkpoints
    from mcncrossmodalemotions_torch.train.state import TrainState
    from mcncrossmodalemotions_torch.zoo import (
        random_teacher_variables,
        teacher_params_from_flax,
    )
    from mcncrossmodalemotions_tpu.train.checkpoints import save_checkpoint
    from mcncrossmodalemotions_tpu.train.state import TrainState as JState
    from mcncrossmodalemotions_tpu.utils.config import write_run_meta

    cfg = jfb.FerPlusConfig(out_root=str(tmp_path), **TINY)
    exp = tmp_path / cfg.exp_name()
    write_run_meta(exp, cfg, data_type="CNTK", num_images=60)
    velocity = {}
    for epoch, err in ((1, 0.3), (2, 0.6)):
        v = random_teacher_variables(seed=epoch, stage_sizes=(1, 1), width=8)
        nested = {k: {"teacher": jax.tree.map(jnp.asarray, t)}
                  for k, t in v.items()}
        st = JState.create(nested, jax.random.PRNGKey(0))
        st = st.replace(velocity=jax.tree.map(lambda a: a * -0.01, st.params))
        velocity[epoch] = jax.tree.map(np.asarray, st.velocity)
        save_checkpoint(exp, epoch, st, {"val": {"classerror": err}})
    model, state = fb.load_teacher_from_exp(exp, epoch="best", device="cpu")
    model.teacher.dtype = torch.float32
    jmodel, jvars = jfb.load_teacher_from_exp(exp, epoch="best")
    jmodel = jmodel.clone(teacher=jmodel.teacher.clone(dtype=jnp.float32))
    x = np.random.RandomState(1).randint(0, 256, (4, 48, 48, 1)).astype(
        np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ours = TrainState.create(fb.build_pipeline(fb.FerPlusConfig(
        **dataclasses.asdict(cfg))), torch.Generator())
    checkpoints.restore_from_exp(exp, ours, epoch=1)
    want = teacher_params_from_flax(velocity[1])
    assert sorted(want) == sorted(ours.velocity)
    for key, t in want.items():
        np.testing.assert_array_equal(ours.velocity[key].numpy(), t.numpy(),
                                      err_msg=key)
    for key, t in state.items():
        np.testing.assert_array_equal(ours.model.state_dict()[key].numpy(),
                                      t.numpy(), err_msg=key)
    _, stats = fb.ferplus_baselines(fb.FerPlusConfig(**dataclasses.asdict(cfg)),
                                    imdb, evaluate_only="val",
                                    use_best_epoch=True, device="cpu")
    assert 0.0 <= stats["accuracy"] <= 1.0


def test_check_results_equal_jax():
    assert rf.EXPECTED_ACCURACY == jrf.EXPECTED_ACCURACY
    assert rf.DEFAULT_TOLERANCE == jrf.DEFAULT_TOLERANCE
    assert rf.MODELS == jrf.MODELS
    exp = rf.EXPECTED_ACCURACY
    cases = [{m: dict(v) for m, v in exp.items()},
             {m: {k: v + 0.004 for k, v in vals.items()}
              for m, vals in exp.items()},
             {"senet50-ferplus": {"valAcc": 0.9, "testAcc": 0.80}}, {}]
    for results in cases:
        for tol in (rf.DEFAULT_TOLERANCE, 0.1):
            assert rf.check_results(results, tol) == jrf.check_results(
                results, tol)


def test_reproduce_ferplus_on_synthetic_files(tmp_path, capsys):
    rng = np.random.RandomState(0)
    fer, plus = tmp_path / "fer2013.csv", tmp_path / "fer2013new.csv"
    with pytest.raises(FileNotFoundError):
        rf.reproduce_ferplus(str(fer), str(plus), {}, device="cpu")
    assert "Kaggle" in capsys.readouterr().out
    usages = ["Training"] * 4 + ["PublicTest"] * 6 + ["PrivateTest"] * 6
    with open(fer, "w") as f:
        f.write("emotion,pixels,Usage\n")
        for u in usages:
            f.write(f"0,{' '.join(map(str, rng.randint(0, 256, 48 * 48)))},{u}\n")
    with open(plus, "w") as f:
        f.write("Usage,Image name,neutral,happiness,surprise,sadness,anger,"
                "disgust,fear,contempt,unknown,NF\n")
        for i, u in enumerate(usages):
            votes = rng.randint(0, 3, 10)
            votes[i % 8] += 7
            f.write(f"{u},fer{i:07d}.png,{','.join(map(str, votes))}\n")
    mats = {}
    for name, use_se in (("resnet50-ferplus", False), ("senet50-ferplus", True)):
        mats[name] = str(tmp_path / f"{name}.mat")
        chip_smoke.teacher_release(mats[name], use_se=use_se,
                                   stage_sizes=(1, 1), width=8)
    report = rf.reproduce_ferplus(str(fer), str(plus), mats,
                                  out_root=str(tmp_path / "out"),
                                  batch_size=4, input_size=48, device="cpu")
    assert not report["pass"]  # random teachers are not the released ones
    assert len(report["rows"]) == 4
    assert all(r["measured"] is not None for r in report["rows"])
    assert json.loads((tmp_path / "out" / "report.json").read_text())[
        "results"] == report["results"]


def test_dev_checkpoint_registry(tmp_path, monkeypatch):
    assert registry.DEV_CHECKPOINTS == jregistry.DEV_CHECKPOINTS
    name = "senet50_ft-dag-distributions-CNTK-dropout-0.5-aug"
    p = registry.dev_checkpoint_path(name, tmp_path)
    assert p == tmp_path / "grimaces" / name / "net-epoch-90.pt"
    with pytest.raises(KeyError):
        registry.dev_checkpoint_path("not-a-model", tmp_path)
    seen = {}
    monkeypatch.setattr(fb, "load_teacher_from_exp",
                        lambda d, **k: seen.update(dir=d, **k) or "loaded")
    assert registry.load_dev_checkpoint(name, tmp_path, device="cpu") == "loaded"
    assert seen == {"dir": tmp_path / "grimaces" / name, "epoch": 90,
                    "device": "cpu"}
