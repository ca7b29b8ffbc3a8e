"""The online (fused-teacher) distillation step against the JAX package's.

- ``aggregate_frame_logits`` bitwise JAX's, max and mean.
- The batcher with ``frames_per_crop``: ``data``, targets and the
  ``[B, K, S, S, 1]`` uint8 ``frames`` bitwise the JAX batcher's (its
  frames come from the committed C++ decoder where it loads, else from
  PIL, and are then held within one gray level), both reading the JAX
  package's ``build_synthetic_imdb(with_frames=True)`` tree. The port's
  own tree has JAX's file lists and logits, and frames that its JPEG
  writer encodes from JAX's pixels, within 10 gray levels of JAX's.
- ``make_online_distill_step`` against JAX's: a tiny SENet teacher
  (``stage_sizes=(1, 1)``, width 8, input 48, the same weights through
  ``zoo/bridge.py``) over a real online batch (the batcher's frames, its
  crops through the JAX frontend as the tiny student's spectrograms, a
  ragged ``pad_mask``), three steps with lr 1e-2, 5e-3, 2e-3 and weight
  decay 5e-4. In float64 (JAX under ``enable_x64``) the whole student
  state (parameters, running statistics, velocity) within rtol 1e-4 plus
  1e-4 of each tensor's largest magnitude, losses within rtol 1e-5 (bn5's
  bias is analytically zero here: pool5's winners are positive, so its
  shift reaches fc6 as a constant over the batch that bn6 removes; JAX's
  and the port's are rounding noise, about 1e-21, held below 1e-15); in
  fp32 the losses within rtol 1e-5 (``tests/test_torch_train_step.py``
  says why the fp32 state is not held). The teacher is frozen: none of
  its parameters or statistics moves.
- The in-step targets equal the teacher run apart on the same frames and
  aggregated (``tests/test_online_distill.py``'s check), and JAX's.
- ``run_distillation(online_teacher=True)`` end to end on the CPU: 2
  epochs, ``-online`` in the JAX package's experiment name, checkpoints,
  finite losses, train batches with frames and val batches without.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data import emovox, images
from mcncrossmodalemotions_torch.exp import run_distillation as rd
from mcncrossmodalemotions_torch.models import ResNet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.train import checkpoints as ckpt
from mcncrossmodalemotions_torch.train import distill
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.zoo import (
    random_teacher_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.data import emovox as jemovox
from mcncrossmodalemotions_tpu.data import native as jnative
from mcncrossmodalemotions_tpu.exp import run_distillation as jrd
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)
from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_tpu.ops.spectrogram import waveform_to_input
from mcncrossmodalemotions_tpu.train import distill as jdistill
from mcncrossmodalemotions_tpu.train import state as jstate

TINY_STUDENT = dict(fc6_features=64, fc7_features=32)
TINY_RESNET = dict(stage_sizes=(1, 1), width=8)
FRAMES = dict(frames_per_crop=2, frame_size=48)
LRS = (1e-2, 5e-3, 2e-3)
RAGGED = np.float32([1, 0, 1])
ZERO = 1e-15  # the rounding noise of an analytically zero float64 tensor
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    root = tmp_path_factory.mktemp("paired")
    return jemovox.build_synthetic_imdb(root / "wavs", num_speakers=3,
                                        tracks_per_speaker=4,
                                        duration_range=(1.2, 2.5),
                                        with_frames=True)


def _cfg(mod, **kw):
    return mod.BatchConfig(num_seconds=1.0, batch_size=4, **FRAMES, **kw)


@pytest.mark.parametrize("agg", ["max", "mean"])
def test_aggregate_frame_logits_bitwise_jax(agg):
    logits = np.random.RandomState(0).randn(5, 4, 8).astype(np.float32)
    got = distill.aggregate_frame_logits(torch.from_numpy(logits), agg)
    want = np.asarray(jdistill.aggregate_frame_logits(jnp.asarray(logits), agg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="aggregator"):
        distill.aggregate_frame_logits(torch.from_numpy(logits), "median")


@pytest.mark.parametrize("train", [True, False])
def test_batcher_frames_and_data_equal_jax(paired, train):
    got = [b for e in (1, 2) for b in emovox.EmoVoxBatcher(
        paired, _cfg(emovox), train=train, seed=1).batches(e)]
    want = [b for e in (1, 2) for b in jemovox.EmoVoxBatcher(
        paired, _cfg(jemovox), train=train, seed=1).batches(e)]
    assert len(got) == len(want) == 6
    for t, j in zip(got, want):
        assert sorted(t) == sorted(j)
        assert t["frames"].shape == (4, 2, 48, 48, 1)
        assert t["frames"].dtype == np.uint8
        for key in j:
            if key == "frames" and not jnative.available():  # PIL's decode
                diff = np.abs(t[key].astype(int) - j[key].astype(int))
                assert diff.max() <= 1
            else:
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_synthetic_imdb_with_frames_equals_jax(tmp_path):
    j = jemovox.build_synthetic_imdb(tmp_path / "j" / "wavs", num_speakers=2,
                                     tracks_per_speaker=2, seed=3,
                                     with_frames=True)
    t = emovox.build_synthetic_imdb(tmp_path / "t" / "wavs", num_speakers=2,
                                    tracks_per_speaker=2, seed=3,
                                    with_frames=True)
    assert len(t.dense_frames) == len(j.dense_frames) == 4
    for a, b in zip(t.dense_frames, j.dense_frames):
        np.testing.assert_array_equal(a, b)
        # JAX's pixels through the port's JPEG writer (the card's host has
        # no PIL): within 10 gray levels of JAX's PIL file
        # (tests/test_torch_frames.py)
        got = images.load_frame_batch([Path(t.frame_dir) / r for r in b], 64,
                                      crop_ratio=1.0)
        want = images.load_frame_batch([Path(j.frame_dir) / r for r in b], 64,
                                       crop_ratio=1.0)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 10
    assert Path(t.frame_dir) == tmp_path / "t" / "frames"
    for a, b in zip(t.wav_logits, j.wav_logits):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def online_batch(paired):
    """The batcher's first train batch: frames, and its crops through the
    JAX frontend as the tiny student's spectrograms; a ragged pad_mask."""
    batch = next(iter(jemovox.EmoVoxBatcher(
        paired, _cfg(jemovox), train=True, seed=1).batches(1)))
    with jax.default_matmul_precision("highest"):
        spec = np.asarray(waveform_to_input(jnp.asarray(batch["data"])))
    return {"data": spec[:3], "frames": batch["frames"][:3], "pad_mask": RAGGED}


@pytest.fixture(scope="module")
def weights(online_batch):
    student = JaxVGGM(dtype=jnp.float32, **TINY_STUDENT).init(
        jax.random.PRNGKey(0), jnp.asarray(online_batch["data"]))
    teacher = random_teacher_variables(seed=7, use_se=True, **TINY_RESNET)
    return (jax.tree.map(np.asarray, student),
            {"params": {"teacher": teacher["params"]},
             "batch_stats": {"teacher": teacher["batch_stats"]}})


def _jax_teacher(dtype):
    return JPipeline(teacher=JResNet(use_se=True, dtype=dtype,
                                     param_dtype=dtype, **TINY_RESNET),
                     input_size=48, augment=False)


def _port_teacher(tvars, dtype):
    teacher = FaceTeacherPipeline(ResNet(use_se=True, dtype=dtype,
                                         **TINY_RESNET),
                                  input_size=48, augment=False)
    teacher.load_state_dict(teacher_state_dict_from_flax(tvars), strict=True)
    return teacher.to(dtype)


def _jax_run(batch, weights, dtype):
    svars, tvars = weights
    with jax.enable_x64(dtype == jnp.float64), \
            jax.default_matmul_precision("highest"):
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        step = jax.jit(jdistill.make_online_distill_step(
            JaxVGGM(dtype=dtype, param_dtype=dtype, **TINY_STUDENT).apply,
            _jax_teacher(dtype).apply, cast(tvars),
            sgd=jstate.SGDConfig(weight_decay=5e-4), pass_pad_mask=True))
        state = jstate.TrainState.create(cast(svars), jax.random.PRNGKey(1))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = []
        for lr in LRS:
            state, m = step(state, jb, lr)
            losses.append(float(m["loss"]))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                            {"params": state.params, "velocity": state.velocity,
                             "batch_stats": state.model_state["batch_stats"]})
    want = student_state_dict_from_flax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    return want, student_params_from_flax(tree["velocity"]), np.asarray(losses)


def _port_run(batch, weights, dtype):
    svars, tvars = weights
    model = VGGMStudent(dtype=dtype, **TINY_STUDENT)
    model.load_state_dict(student_state_dict_from_flax(svars))
    teacher = _port_teacher(tvars, dtype)
    frozen = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = tstate.TrainState.create(model.to(dtype),
                                     torch.Generator().manual_seed(1))
    step = distill.make_online_distill_step(
        teacher, sgd=tstate.SGDConfig(weight_decay=5e-4))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    losses = []
    for lr in LRS:
        state, m = step(state, tb, lr)
        losses.append(m["loss"].item())
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    return state, np.asarray(losses)


def _close(got: torch.Tensor, ref: torch.Tensor, key: str):
    ref, got = ref.double().numpy(), got.detach().double().numpy()
    if np.abs(ref).max() < ZERO:  # bn5's bias: rounding noise on both sides
        assert np.abs(got).max() < ZERO, key
        return
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_step_matches_jax(online_batch, weights, dtype):
    jdtype, tdtype = DTYPES[dtype]
    want, vel, jlosses = _jax_run(online_batch, weights, jdtype)
    state, tlosses = _port_run(online_batch, weights, tdtype)
    assert state.step == 3
    assert len(set(jlosses.tolist())) == 3  # every step moved the weights
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    if dtype == "float32":
        return
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key)
    assert sorted(vel) == sorted(state.velocity)
    for key in vel:
        assert vel[key].abs().max() > 0, key
        _close(state.velocity[key], vel[key], f"velocity {key}")
    assert np.abs(want["bn5.bias"].numpy()).max() < ZERO


def test_online_targets_equal_the_offline_teacher(online_batch, weights):
    tvars = weights[1]
    teacher = distill.frozen(_port_teacher(tvars, torch.float32))
    frames = torch.from_numpy(online_batch["frames"])
    got = distill.teacher_targets(teacher, frames, 8, "max")
    b, k = frames.shape[:2]
    with torch.inference_mode():
        apart = teacher(frames.reshape(b * k, 48, 48, 1)).float()
    np.testing.assert_array_equal(
        got.numpy(), apart.reshape(b, k, -1).amax(dim=1)[:, :8].numpy())
    jframes = jnp.asarray(online_batch["frames"])
    with jax.default_matmul_precision("highest"):
        jlogits = _jax_teacher(jnp.float32).apply(
            jax.tree.map(jnp.asarray, tvars),
            jframes.reshape((b * k, 48, 48, 1)), train=False)
        want = np.asarray(jdistill.aggregate_frame_logits(
            jlogits.reshape(b, k, -1)[..., :8], "max"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert np.ptp(want, axis=0).max() > 0  # targets differ across crops


def test_run_distillation_online_end_to_end(paired, weights, tmp_path,
                                            monkeypatch):
    seen = []

    class Recording(emovox.EmoVoxBatcher):
        def batches(self, *args, **kwargs):
            for batch in super().batches(*args, **kwargs):
                seen.append((self.train, sorted(batch)))
                yield batch

    monkeypatch.setattr(rd, "EmoVoxBatcher", Recording)
    teacher = _port_teacher(weights[1], torch.float32)
    kw = dict(num_epochs=2, batch_size=4, num_seconds=1.0, tiny_model=True,
              online_teacher=True, mini_epoch_ratio=1.0, mini_val=1.0,
              out_root=str(tmp_path), **FRAMES)
    with pytest.raises(ValueError, match="teacher_model"):
        rd.run_distillation(rd.DistillationConfig(**kw), paired, device="cpu")
    state, history, exp_dir = rd.run_distillation(
        rd.DistillationConfig(**kw), paired, device="cpu",
        teacher_model=teacher)
    assert "-online" in exp_dir.name
    assert exp_dir.name == jrd.DistillationConfig(**kw).exp_name()
    assert [h["epoch"] for h in history] == [1, 2] and state.step == 2
    assert [e for e, _ in ckpt.list_checkpoints(exp_dir)] == [1, 2]
    assert 0 < history[-1]["train"]["loss"] < 10
    assert all(np.isfinite(h["val"]["loss"]) for h in history)
    assert {tuple(keys) for train, keys in seen if train} == {
        ("data", "frames", "logit_target", "max_label")}
    assert {tuple(keys) for train, keys in seen if not train} == {
        ("data", "logit_target", "max_label")}
