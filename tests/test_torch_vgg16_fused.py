"""The VGG face teachers' fused eval forward on the CPU
(``models/vggface.VGGFace.fused_forward``, ``ops/epilogue.affine_relu_pool2x2``,
``models/prepared.PreparedEval``).

- ``affine_relu_pool2x2``'s plain version is ``F.max_pool2d(F.relu(s y +
  t), 2, 2)`` in fp32, bit for bit, at even and odd sizes (floor) and with
  negative scales, where pooling before the affine would differ; on a CPU
  tensor the wrapper is its plain version and launches nothing; H or W
  under 2 is refused.
- A tiny VGG-VD-16 (width 1/16, fc 64, 32x32 input) in a
  ``FaceTeacherPipeline`` on uint8 frames, with seeded weights (He-scaled
  kernels, nonzero biases, BatchNorm statistics away from the identity),
  BN-less with biases and with the useBnorm retrofit: the unfused forward
  and ``fused_forward`` both equal ``tests/plain_vgg16.py`` in fp32, the
  embedding too.
- Full-width VGG-VD-16 (BN-less and useBnorm) in a ``FaceTeacherPipeline``
  with the vgg_face mean, ``fused_forward`` in fp32 (the epilogues' plain
  versions) on the teacher golden's four frames against the JAX package's
  fp32 logits (``tests/fixtures/torch_vgg16_golden.npz``), within 1e-3 x
  max|golden|, as ``tests/test_torch_teacher.py`` holds ResNet's.
- Train mode, eval with autograd on, and every CPU call run the unfused
  code: nothing prepared, outputs bitwise equal to that code written out.
- ``PreparedEval``, shared by ``VGGFace`` and ``ResNet``, is rebuilt after
  an in-place update of a tensor in use, after ``load_state_dict`` and
  after a submodule is replaced, and kept otherwise.

The kernel and the full-width forward are held on the card by
``tests/test_torch_kernels_gpu.py``.
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import numpy as np

import plain_vgg16
from mcncrossmodalemotions_torch.models.resnet import ResNet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggface import VGGFace
from mcncrossmodalemotions_torch.ops import epilogue
from mcncrossmodalemotions_torch.zoo import (
    random_vggface_variables,
    teacher_state_dict_from_flax,
)
from tests.test_torch_teacher_golden import GOLDEN, SEED, VGG16_GOLDEN

SIZE = 32
MEAN_RGB = (129.1863, 104.7624, 93.5940)
FORWARD_RTOL = 1e-5  # fp32 against fp32 (fc6 a GEMM against a conv, bias
                     # added after the conv against inside it)


def _close(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= rtol * scale, (err, scale)


@torch.no_grad()
def _seed_weights(model: nn.Module, seed: int) -> nn.Module:
    """Kernels at variance 2 / fan_in (the first scaled by the input's
    variance, about 60^2 here), biases 0.1 z, BatchNorm scale 1 + 0.2 z,
    shift 0.1 z, running mean 0.1 z, running variance in [0.5, 2]."""
    gen = torch.Generator().manual_seed(seed)
    first = True
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        z = torch.randn(t.shape, generator=gen)
        if name.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
        elif name.endswith("weight") and t.dim() == 4:
            fan_in = t[0].numel() * (3600.0 if first else 1.0)
            t.copy_(z * (2.0 / fan_in) ** 0.5)
            first = False
        elif name.endswith("weight") and t.dim() == 2:
            t.copy_(z / t.shape[1] ** 0.5)
        elif name.endswith("weight") and t.dim() == 1:
            t.copy_(1.0 + 0.2 * z)
        else:
            t.copy_(0.1 * z)
    return model


def _vgg(bn: bool, seed: int = 0) -> VGGFace:
    model = VGGFace("vd", use_batchnorm=bn, width_multiplier=1 / 16,
                    fc_features=64, dtype=torch.float32, input_size=SIZE)
    return _seed_weights(model, seed).eval()


def _frames(seed: int = 0, size: int = 40) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (3, size, size, 1), generator=gen,
                         dtype=torch.uint8)


# -- affine_relu_pool2x2's plain version ----------------------------------

@pytest.mark.parametrize("h,w", [(8, 6), (7, 5), (2, 3)])
@pytest.mark.parametrize("sign", ["positive", "mixed"])
def test_pool_epilogue_plain_is_relu_then_pool(h, w, sign):
    gen = torch.Generator().manual_seed(h * 10 + w)
    b, c = 2, 16
    y = torch.randn(b, h, w, c, generator=gen)
    s = torch.rand(c, generator=gen) + 0.5
    if sign == "mixed":
        s[::2] *= -1.0
    t = torch.randn(c, generator=gen) * 0.3
    before = epilogue.affine_relu_pool2x2.launches
    got = epilogue.affine_relu_pool2x2(y, s, t)
    assert epilogue.affine_relu_pool2x2.launches == before
    yc = y.permute(0, 3, 1, 2)
    ref = F.max_pool2d(F.relu(yc * s[:, None, None] + t[:, None, None]), 2, 2)
    assert got.shape == (b, h // 2, w // 2, c)
    assert torch.equal(got, ref.permute(0, 2, 3, 1))
    pooled_first = F.relu(F.max_pool2d(yc, 2, 2) * s[:, None, None]
                          + t[:, None, None]).permute(0, 2, 3, 1)
    assert torch.equal(got, pooled_first) == (sign == "positive")
    yb = y.bfloat16()
    half = epilogue.affine_relu_pool2x2(yb, s, t)
    assert half.dtype == torch.bfloat16  # one rounding, after the max:
    assert torch.equal(half, epilogue.affine_relu_pool2x2(yb.float(), s,
                                                          t).bfloat16())


@pytest.mark.parametrize("shape", [(2, 1, 4, 8), (2, 4, 1, 8), (4, 4, 8)])
def test_pool_epilogue_refuses_what_it_cannot_pool(shape):
    y = torch.zeros(shape)
    with pytest.raises(ValueError, match="H and W of 2 or more"):
        epilogue.affine_relu_pool2x2(y, torch.ones(8), torch.zeros(8))


# -- the whole teacher against the plain reference -------------------------

@pytest.mark.parametrize("path", ["unfused", "fused"])
@pytest.mark.parametrize("bn", [False, True], ids=["biases", "batchnorm"])
@torch.no_grad()
def test_vgg16_pipeline_is_the_plain_reference(bn, path, monkeypatch):
    model = _vgg(bn)
    if path == "fused":
        monkeypatch.setattr(
            VGGFace, "forward",
            lambda self, x, train=False, return_embedding=False, **kw:
            self.fused_forward(x, return_embedding))
    pipeline = FaceTeacherPipeline(model, input_size=SIZE, mean_rgb=MEAN_RGB,
                                   augment=False).eval()
    frames = _frames(1)
    got, emb = pipeline(frames, return_embedding=True)
    weights = model.state_dict()
    ref = plain_vgg16.forward(weights, frames, SIZE, MEAN_RGB)
    ref_emb = plain_vgg16.forward(weights, frames, SIZE, MEAN_RGB,
                                  embedding=True)
    _close(got, ref, FORWARD_RTOL)
    _close(emb, ref_emb, FORWARD_RTOL)
    assert ref.std(dim=0).mean() > 0.05  # logits that differ across frames
    assert model.prepared.builds == (path == "fused")


@pytest.mark.parametrize("bn", [False, True], ids=["biases", "batchnorm"])
@torch.no_grad()
def test_full_width_vgg16_fused_forward_matches_the_jax_golden(bn,
                                                               monkeypatch):
    monkeypatch.setattr(
        VGGFace, "forward",
        lambda self, x, train=False, return_embedding=False, **kw:
        self.fused_forward(x, return_embedding))
    gold = np.load(GOLDEN)
    frames = gold["frames_crop0625"][gold["logit_index"]][..., None]
    v = random_vggface_variables(SEED, arch="vd", use_batchnorm=bn)
    model = FaceTeacherPipeline(
        VGGFace("vd", use_batchnorm=bn, dtype=torch.float32),
        mean_rgb=MEAN_RGB, augment=False)
    model.load_state_dict(teacher_state_dict_from_flax(
        {k: {"teacher": tree} for k, tree in v.items()}), strict=True)
    del v
    got = model.eval()(torch.from_numpy(frames)).numpy()
    ref = np.load(VGG16_GOLDEN)[f"logits_vgg16{'_bn' if bn else ''}_fp32"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"fused fp32 vs JAX golden: max abs {err:.3e}, max |golden| "
          f"{scale:.3f}")
    assert err <= 1e-3 * scale
    assert model.teacher.prepared.builds == 1
    # the golden is worth holding to: logits spread over frames and classes
    assert ref.std(axis=0).mean() >= 0.1 and ref.std(axis=1).min() >= 0.1


def test_plain_reference_imports_nothing_of_the_port_or_jax():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(plain_vgg16.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "typing", "torch"}, names


@pytest.mark.parametrize("bn", [False, True], ids=["biases", "batchnorm"])
@torch.no_grad()
def test_vggm_fused_forward_is_its_eval_forward(bn):
    """VGG-M's fused path (3x3/2 ``stem_pool`` after ``affine_relu``, fc6
    over 2x2 at 96) against its own unfused forward."""
    model = _seed_weights(VGGFace("m", use_batchnorm=bn, width_multiplier=1 / 16,
                                  fc_features=64, dtype=torch.float32,
                                  input_size=96), 3).eval()
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(4)) * 60
    got, emb = model.fused_forward(x, return_embedding=True)
    ref, ref_emb = model(x, return_embedding=True)  # a CPU call: unfused
    _close(got, ref, FORWARD_RTOL)
    _close(emb, ref_emb, FORWARD_RTOL)
    assert model.prepared.builds == 1


# -- which path a call takes ------------------------------------------------

def _unfused(model: VGGFace, x: torch.Tensor, train: bool, pad_mask=None):
    """VGGFace's forward without the fused path, written out."""
    from mcncrossmodalemotions_torch.models.resnet import _bn

    bn = dict(train=train, bn_mask=pad_mask)
    x = x.to(model.dtype).permute(0, 3, 1, 2)
    for name, pool in model.layers + [("fc6", None), ("fc7", None)]:
        conv = getattr(model, name)
        x = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
        if model.use_batchnorm:
            x = _bn(x, getattr(model, f"bn_{name}"), **bn)
        x = F.relu(x)
        if pool == "2x2":
            x = F.max_pool2d(x, 2, 2)
    x = x.reshape(x.shape[0], -1).float()
    return F.linear(x, model.prediction.weight, model.prediction.bias)


@pytest.mark.parametrize("mode", ["train", "eval_grad", "eval_no_grad"])
@pytest.mark.parametrize("bn", [False, True], ids=["biases", "batchnorm"])
def test_train_grad_and_the_cpu_run_the_unfused_code(bn, mode):
    model = _vgg(bn)
    ref_model = copy.deepcopy(model)
    x = torch.randn(3, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(5))
    train = mode == "train"
    mask = torch.tensor([1.0, 1.0, 0.0])
    if train:
        model.train(), ref_model.train()
    with torch.set_grad_enabled(mode != "eval_no_grad"):
        got = model(x, train=train, pad_mask=mask)
        ref = _unfused(ref_model, x, train, mask)
    assert torch.equal(got, ref)
    assert got.requires_grad == (mode != "eval_no_grad")
    for (name, a), (_, b) in zip(model.named_buffers(),
                                 ref_model.named_buffers()):
        assert torch.equal(a, b), name
    assert model.prepared.builds == 0


# -- PreparedEval, shared by both families ----------------------------------

def _model(kind: str, seed: int = 0) -> nn.Module:
    if kind == "vggface":
        return _vgg(True, seed)
    model = ResNet(use_se=True, dtype=torch.float32, stage_sizes=(1, 1),
                   width=8)
    return _seed_weights(model, seed).eval()


def _bn_of(model: nn.Module) -> tuple:
    """(parent module, attribute name) of a BatchNorm that the fused
    forward reads."""
    if isinstance(model, VGGFace):
        return model, "bn_conv3_2"
    return model.layer1_0, "bn2"


@pytest.mark.parametrize("how", ["in_place", "load_state_dict",
                                 "replaced_submodule"])
@pytest.mark.parametrize("kind", ["vggface", "resnet"])
@torch.no_grad()
def test_prepared_weights_rebuild_on_a_change_in_both_families(kind, how):
    model = _model(kind)
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(6)) * 40
    first = model.fused_forward(x)
    _close(model.fused_forward(x), first, 0.0)
    assert model.prepared.builds == 1  # kept over calls
    owner, attr = _bn_of(model)
    if how == "in_place":
        getattr(owner, attr).running_var.mul_(2.5)
    elif how == "load_state_dict":
        model.load_state_dict(_model(kind, seed=7).state_dict())
    else:
        old = getattr(owner, attr)
        new = nn.BatchNorm2d(old.num_features, eps=old.eps).eval()
        new.running_var.fill_(4.0)
        setattr(owner, attr, new)
    got = model.fused_forward(x)
    assert model.prepared.builds == 2
    assert not torch.equal(got, first)
    _close(got, model(x), FORWARD_RTOL)  # the CPU call: unfused
