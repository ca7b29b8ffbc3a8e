"""The port's face teachers against the JAX package's, on the CPU.

- ``ResNet``, ``SENet`` and ``FaceTeacherPipeline`` at tiny width
  (``stage_sizes=(1, 1)``, ``width=8``) with the Flax weights carried
  across by ``zoo/bridge.teacher_state_dict_from_flax``: fp32 within
  1e-4 x max|ref| + 1e-5 of the JAX modules at full precision, bf16 within
  3e-2 x max|ref| of the JAX modules in bf16;
- the full-width port in fp32 against the JAX golden
  (``tests/fixtures/torch_teacher_golden.npz``), within 1e-3 x max|golden|;
- the Caffe pad-(0,1) stem pool equal to a -inf pad and a VALID pool at
  even and odd sizes; ``resize_separable`` against the JAX one;
- ``load_pretrained_teacher`` on synthetic classic ``.mat`` releases with
  nonzero conv biases (folded into the BN means as the JAX package folds
  them), the release's mean image, and the refusals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from mcncrossmodalemotions_torch.models.resnet import ResNet, stem_pool
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.ops.warp import resize_separable
from mcncrossmodalemotions_torch.zoo import (
    build_teacher,
    load_pretrained_teacher,
    random_teacher_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_torch.zoo.registry import (
    fold_teacher_conv_biases,
    release_mean_rgb,
)
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)
from mcncrossmodalemotions_tpu.ops.warp import resize_separable as jresize
from mcncrossmodalemotions_tpu.zoo import registry as jregistry
from tests.test_torch_teacher_golden import GOLDEN

TINY = dict(stage_sizes=(1, 1), width=8)
FP32_RTOL, FP32_ATOL, BF16_RTOL = 1e-4, 1e-5, 3e-2
GOLDEN_RTOL = 1e-3


def _frames(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (n, size, size, 1)).astype(np.uint8)


def _jax(model, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(model.apply(variables, jnp.asarray(x), train=False),
                          np.float32)


def _port(model, state, x):
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def _check(got, ref, dtype: str, what: str):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    bound = (FP32_RTOL * scale + FP32_ATOL if dtype == "fp32"
             else BF16_RTOL * scale)
    print(f"{what} {dtype}: max abs diff {err:.3e}, max |ref| {scale:.3f}, "
          f"bound {bound:.3e}")
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    assert err <= bound, (what, err, bound)


DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_se", [False, True])
@pytest.mark.parametrize("size", [64, 61])
def test_tiny_resnet_matches_jax(dtype, use_se, size):
    tdt, jdt = DTYPES[dtype]
    v = random_teacher_variables(seed=1 + use_se, use_se=use_se, **TINY)
    x = (np.random.RandomState(size).randn(3, size, size, 3) * 60).astype(
        np.float32)
    ref = _jax(JResNet(use_se=use_se, dtype=jdt, **TINY), v, x)
    got = _port(ResNet(use_se=use_se, dtype=tdt, **TINY),
                teacher_state_dict_from_flax(v), x)
    _check(got, ref, dtype, f"ResNet(use_se={use_se}) {size}x{size}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_se", [False, True])
@pytest.mark.parametrize("frame", [48, 64])
def test_tiny_pipeline_matches_jax(dtype, use_se, frame):
    """uint8 gray frames, resized to 64 where they are 48, replicated and
    mean-subtracted, through the teacher; weights nested under 'teacher'."""
    tdt, jdt = DTYPES[dtype]
    v = random_teacher_variables(seed=5, use_se=use_se, **TINY)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    x = _frames(frame, 4, frame)
    mean = (120.0, 100.5, 90.25)
    ref = _jax(JPipeline(teacher=JResNet(use_se=use_se, dtype=jdt, **TINY),
                         input_size=64, mean_rgb=mean, augment=False), nested, x)
    state = teacher_state_dict_from_flax(nested)
    assert all(k.startswith("teacher.") for k in state)
    got = _port(FaceTeacherPipeline(ResNet(use_se=use_se, dtype=tdt, **TINY),
                                    input_size=64, mean_rgb=mean), state, x)
    _check(got, ref, dtype, f"pipeline(use_se={use_se}) {frame}->64")


def test_pipeline_copies_its_mean_to_a_device_once():
    """The forward copies nothing from the host after its first call on a
    device (on the card such a copy would wait for the card); a new
    ``mean_rgb`` gives a new tensor, and one made under inference mode
    serves calls outside it."""
    model = FaceTeacherPipeline(ResNet(dtype=torch.float32, **TINY),
                                input_size=32, mean_rgb=(1.0, 2.0, 3.0)).eval()
    x = torch.from_numpy(_frames(32, 2, 32))
    with torch.inference_mode():
        model(x)
    first = model.mean_on(torch.device("cpu"))
    assert not first.is_inference()
    with torch.no_grad():
        model(x)
    assert model.mean_on("cpu") is first and len(model._means) == 1
    np.testing.assert_array_equal(first.numpy(),
                                  np.float32([1.0, 2.0, 3.0]))
    model.mean_rgb = (4.0, 5.0, 6.0)
    np.testing.assert_array_equal(model.mean_on("cpu").numpy(),
                                  np.float32([4.0, 5.0, 6.0]))


@pytest.mark.parametrize("arch", ["senet50", "resnet50"])
def test_full_width_port_matches_the_jax_golden(arch):
    """The full-width port in fp32 on the golden's four frames against the
    JAX package's fp32 logits, within 1e-3 x max|golden|; the JAX bf16
    logits beside them, for the record."""
    gold = np.load(GOLDEN)
    frames = gold["frames_crop0625"][gold["logit_index"]][..., None]
    use_se = arch == "senet50"
    v = random_teacher_variables(seed=0, use_se=use_se)
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    model = FaceTeacherPipeline(ResNet(use_se=use_se, dtype=torch.float32))
    got = _port(model, teacher_state_dict_from_flax(nested), frames)
    ref = gold[f"logits_{arch}_fp32"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    jax_bf16 = float(np.abs(gold[f"logits_{arch}_bf16"] - ref).max())
    print(f"{arch} fp32 port vs JAX golden: max abs diff {err:.3e}, max "
          f"|golden| {scale:.3f} (JAX bf16 vs fp32: {jax_bf16:.3e})")
    assert err <= GOLDEN_RTOL * scale
    # the golden is worth holding to: logits spread over frames and classes
    assert ref.std(axis=0).mean() >= 0.1 and ref.std(axis=1).min() >= 0.1


@pytest.mark.parametrize("h,w", [(112, 112), (111, 111), (8, 9), (5, 4),
                                 (3, 3), (4, 6)])
def test_stem_pool_is_the_caffe_pad_0_1_pool(h, w):
    x = torch.randn(2, 5, h, w)
    padded = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    ref = F.max_pool2d(padded, 3, 2)
    got = stem_pool(x)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)
    # and the JAX package's pool at the same geometry
    import flax.linen as nn

    jref = nn.max_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), (3, 3),
                       strides=(2, 2), padding=[(0, 1), (0, 1)])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jref))


@pytest.mark.parametrize("shape,out", [((2, 48, 48, 1), (224, 224)),
                                       ((1, 37, 53, 3), (20, 71)),
                                       ((1, 1, 5, 1), (4, 1)),
                                       ((1, 9, 9, 2), (9, 9))])
def test_resize_separable_matches_jax(shape, out):
    x = np.random.RandomState(0).uniform(0, 255, shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jresize(jnp.asarray(x), *out))
    got = resize_separable(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


def test_build_teacher_names_and_refusals():
    """Every zoo name builds (the classic VGG face names too, since the
    teacher's training slice) and an unknown one raises; the teachers and
    their pipeline run in train mode (``tests/test_torch_teacher_train.py``
    holds that mode to Flax)."""
    assert build_teacher("senet50-ferplus", tiny=True).use_se
    assert not build_teacher("resnet50-ferplus", tiny=True).use_se
    full = build_teacher("senet50_ft-dag")
    assert full.stage_sizes == (3, 4, 6, 3) and full.width == 64
    assert build_teacher("vgg_face").arch == "vd"
    assert build_teacher("vgg-m-face-bn", tiny=True).use_batchnorm
    with pytest.raises(KeyError):
        build_teacher("alexnet")
    model = build_teacher(tiny=True)
    gen = torch.Generator().manual_seed(0)
    assert model(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 8)
    out = FaceTeacherPipeline(model, input_size=32)(
        torch.zeros(2, 32, 32, 1), train=True, generator=gen)
    assert out.shape == (2, 8)


def test_bridge_refuses_unknown_and_missing_leaves():
    v = random_teacher_variables(seed=0, use_se=True, **TINY)
    state = teacher_state_dict_from_flax(v)
    model = ResNet(use_se=True, **TINY)
    model.load_state_dict(state, strict=True)
    v["params"]["layer1_0"]["conv1"]["bias"] = np.zeros(8, np.float32)
    with pytest.raises(RuntimeError, match="conv1.bias"):
        model.load_state_dict(teacher_state_dict_from_flax(v), strict=True)
    v["params"]["layer1_0"]["conv1"]["mystery"] = np.zeros(8, np.float32)
    with pytest.raises(KeyError, match="mystery"):
        teacher_state_dict_from_flax(v)
    del state["layer2_0.bn_down.running_var"]
    with pytest.raises(RuntimeError, match="bn_down.running_var"):
        model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("use_se", [False, True])
def test_load_pretrained_teacher_folds_biases_as_jax(tmp_path, use_se):
    path = tmp_path / "teacher.mat"
    v = chip_smoke.teacher_release(path, seed=3, use_se=use_se,
                                   stage_sizes=(2, 1), width=8,
                                   average_image=(110.5, 99.0, 80.25))
    model, state = load_pretrained_teacher(path, with_pipeline=True,
                                           input_size=64, device="cpu")
    model.teacher.dtype = torch.float32  # bf16 compute by default
    assert isinstance(model, FaceTeacherPipeline)
    assert model.mean_rgb == (110.5, 99.0, 80.25)
    assert model.teacher.stage_sizes == (2, 1) and model.teacher.use_se == use_se
    jmodel, jvars = jregistry.load_pretrained_teacher(
        path, with_pipeline=True, input_size=64, download=False)
    # the same folded means, bit for bit
    jstate = teacher_state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), jstate[k].numpy(), k)
    x = _frames(9, 3, 48)
    jfp32 = jmodel.clone(teacher=jmodel.teacher.clone(dtype=jnp.float32))
    ref = _jax(jfp32, jvars, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _check(got, ref, "fp32", f"load_pretrained_teacher(use_se={use_se})")
    # and the release computes what its unbiased weights compute
    nested = {"params": {"teacher": v["params"]},
              "batch_stats": {"teacher": v["batch_stats"]}}
    plain = _port(FaceTeacherPipeline(
        ResNet(use_se=use_se, stage_sizes=(2, 1), width=8,
               dtype=torch.float32), input_size=64,
        mean_rgb=(110.5, 99.0, 80.25)), teacher_state_dict_from_flax(nested), x)
    _check(got, plain, "fp32", "release vs its unbiased weights")


def test_fold_teacher_conv_biases_matches_jax():
    rng = np.random.RandomState(0)
    v = random_teacher_variables(seed=2, use_se=False, **TINY)
    for node in ("conv1", "layer1_0/conv2", "layer2_0/downsample"):
        leaf = v["params"]
        for part in node.split("/"):
            leaf = leaf[part]
        leaf["bias"] = rng.randn(leaf["kernel"].shape[-1]).astype(np.float32)
    arch = {"stage_sizes": (1, 1)}
    import copy

    ours = fold_teacher_conv_biases(arch, copy.deepcopy(v))
    theirs = copy.deepcopy(v)
    jregistry._fold_teacher_conv_biases(arch, theirs)
    flat = teacher_state_dict_from_flax
    a, b = flat(ours), flat(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), k)


def test_release_mean_rgb_of_a_full_average_image(tmp_path):
    img = np.random.RandomState(1).uniform(0, 255, (6, 5, 3)).astype(np.float32)
    path = tmp_path / "t.mat"
    chip_smoke.teacher_release(path, use_se=False, average_image=img, **TINY)
    got = release_mean_rgb(path)
    ref = jregistry.release_mean_rgb(path, download=False)
    assert got == ref
    np.testing.assert_allclose(got, img.reshape(-1, 3).mean(0), rtol=1e-6)
    bare = tmp_path / "bare.mat"
    chip_smoke.teacher_release(bare, use_se=False, average_image=None, **TINY)
    assert release_mean_rgb(bare) is None


def test_load_pretrained_teacher_takes_a_path_and_the_card(tmp_path,
                                                          monkeypatch):
    from mcncrossmodalemotions_torch.zoo.artifacts import ArtifactUnavailable

    monkeypatch.setenv("MCN_TPU_ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(ArtifactUnavailable, match="senet50-ferplus"):
        load_pretrained_teacher("senet50-ferplus", download=False,
                                device="cpu")
    with pytest.raises(FileNotFoundError, match="ARTIFACTS"):
        load_pretrained_teacher(tmp_path / "senet50-ferplus.mat", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pretrained_teacher(tmp_path / "x.mat")
