"""The face teachers' fused eval forward on the CPU (``ops/epilogue.py``,
``models/resnet.ResNet.fused_forward``).

- Each epilogue's plain version equals the unfused composition it
  replaces in fp32 (``F.batch_norm`` -> ReLU; ``F.batch_norm`` -> the SE
  squeeze; ``F.batch_norm`` -> gate -> + the block input or the
  projection's ``F.batch_norm`` -> ReLU) within 1e-6 of the largest
  value, gated and ungated; on a CPU tensor each wrapper is its plain
  version and launches nothing.
- ``fused_forward`` built from the plain versions equals the eval forward
  of the tiny SENet50 and ResNet50 in fp32.
- ``PreparedEval`` is built once, and again after an in-place update of a
  running variance or of a conv weight, after ``load_state_dict``, and
  under ``functional_call`` with another state dict.
  A submodule replaced after a call is read, and so are later in-place
  updates of its tensors.
- Train mode and eval with autograd on run the unfused code: outputs and
  running statistics bitwise equal to that code written out here, and
  nothing prepared.
- The kernels' wrappers refuse a C that is not a whole number of 16-byte
  vectors and data off 16-byte alignment (``_ffi.check_lanes``, which a
  CUDA tensor meets before any launch; held here on CPU tensors).

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mcncrossmodalemotions_torch.models.resnet import (
    ResNet,
    _bn,
    _conv,
    stem_pool,
)
from mcncrossmodalemotions_torch.ops import _ffi, epilogue
from mcncrossmodalemotions_torch.zoo.bridge import (
    random_teacher_variables,
    teacher_state_dict_from_flax,
)

TINY = dict(stage_sizes=(1, 2), width=8)  # projection and identity blocks
PLAIN_RTOL = 1e-6   # fp32, BatchNorm's formula against s y + t
FORWARD_RTOL = 1e-5  # the same through a tiny network's convs


def _bn_module(c: int, gen: torch.Generator) -> nn.BatchNorm2d:
    bn = nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        bn.weight.normal_(generator=gen)
        bn.bias.normal_(generator=gen)
        bn.running_mean.normal_(generator=gen)
        bn.running_var.uniform_(0.25, 4.0, generator=gen)
    return bn


def _eval_bn(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def _affine(bn: nn.BatchNorm2d) -> tuple:
    return epilogue.bn_affine(bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, bn.eps)


def _close(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= rtol * scale, (err, scale)


CASES = ["relu", "squeeze", "tail", "tail_gate", "tail_proj",
         "tail_gate_proj"]


@pytest.mark.parametrize("case", CASES)
@torch.no_grad()
def test_plain_epilogue_is_the_unfused_composition(case):
    gen = torch.Generator().manual_seed(CASES.index(case))
    b, c, h, w = 3, 24, 7, 5
    y = torch.randn(b, c, h, w, generator=gen).contiguous(
        memory_format=torch.channels_last)  # NCHW view, NHWC memory
    yn = y.permute(0, 2, 3, 1)
    bn = _bn_module(c, gen)
    s, t = _affine(bn)
    before = (epilogue.affine_relu.launches, epilogue.affine_squeeze.launches,
              epilogue.affine_gate_add_relu.launches)
    if case == "relu":
        ref = F.relu(_eval_bn(y, bn)).permute(0, 2, 3, 1)
        got = epilogue.affine_relu(yn, s, t)
        assert torch.equal(got, epilogue.affine_relu_plain(yn, s, t))
        inplace = yn.clone()
        assert epilogue.affine_relu(inplace, s, t, out=inplace) is inplace
        assert torch.equal(inplace, got)
    elif case == "squeeze":
        ref = _eval_bn(y, bn).mean(dim=(2, 3), dtype=torch.float32)
        got = epilogue.affine_squeeze(yn, s, t)
        assert torch.equal(got, epilogue.affine_squeeze_plain(yn, s, t))
    else:
        x = torch.randn(b, c, h, w, generator=gen).contiguous(
            memory_format=torch.channels_last)
        gate = (torch.rand(b, c, generator=gen) if "gate" in case else None)
        down = _bn_module(c, gen) if "proj" in case else None
        v = _eval_bn(y, bn)
        if gate is not None:
            v = v * gate[:, :, None, None]
        r = x if down is None else _eval_bn(x, down)
        ref = F.relu(v + r).permute(0, 2, 3, 1)
        kw = dict(gate=gate,
                  residual_affine=None if down is None else _affine(down))
        got = epilogue.affine_gate_add_relu(yn, s, t, x.permute(0, 2, 3, 1),
                                            **kw)
        assert torch.equal(got, epilogue.affine_gate_add_relu_plain(
            yn, s, t, x.permute(0, 2, 3, 1), **kw))
    _close(got, ref, PLAIN_RTOL)
    assert (epilogue.affine_relu.launches, epilogue.affine_squeeze.launches,
            epilogue.affine_gate_add_relu.launches) == before


def _tiny(use_se: bool, seed: int = 0) -> ResNet:
    model = ResNet(use_se=use_se, dtype=torch.float32, **TINY)
    model.load_state_dict(teacher_state_dict_from_flax(
        random_teacher_variables(seed=seed, use_se=use_se, **TINY)))
    return model.eval()


def _input(seed: int = 0, size: int = 29) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(3, size, size, 3, generator=gen) * 60


@pytest.mark.parametrize("use_se", [True, False], ids=["senet50", "resnet50"])
@torch.no_grad()
def test_fused_eval_forward_is_the_eval_forward(use_se):
    model, x = _tiny(use_se), _input()
    ref, ref_emb = model(x, return_embedding=True)  # a CPU call: unfused
    assert model.prepared.builds == 0
    got, emb = model.fused_forward(x, return_embedding=True)
    _close(got, ref, FORWARD_RTOL)
    _close(emb, ref_emb, FORWARD_RTOL)
    assert ref.std(dim=0).mean() > 0.02  # logits that differ across frames
    _close(model.fused_forward(x), ref, FORWARD_RTOL)
    assert model.prepared.builds == 1


class _Fused(nn.Module):
    """``functional_call`` reaches ``fused_forward`` through this."""

    def __init__(self, model: ResNet):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.fused_forward(x)


def _change(model: ResNet, how: str, wrapper: _Fused, x: torch.Tensor):
    """Change the weights in use ``how``; returns the new weights' fused
    forward and the unfused forward of the same weights."""
    if how == "running_var":
        model.layer2_1.bn2.running_var.mul_(1.5)
    elif how == "conv_weight":
        model.layer1_0.conv2.weight.mul_(-0.5)
    elif how == "load_state_dict":
        model.load_state_dict(_tiny(model.use_se, seed=7).state_dict())
    if how != "functional_call":
        return model.fused_forward(x), model(x)
    other = _tiny(model.use_se, seed=9).state_dict()
    got = functional_call(wrapper, {f"model.{k}": v for k, v in other.items()},
                          (x,))
    assert model.prepared.builds == 2
    again = functional_call(wrapper, {f"model.{k}": v for k, v in other.items()},
                            (x,))
    assert torch.equal(again, got)  # the same state's tensors: kept
    return got, functional_call(model, other, (x,))


@pytest.mark.parametrize("how", ["running_var", "conv_weight",
                                 "load_state_dict", "functional_call"])
@torch.no_grad()
def test_prepared_weights_rebuild_when_the_weights_change(how):
    model, x = _tiny(True), _input(1)
    wrapper = _Fused(model)
    first = model.fused_forward(x)
    assert torch.equal(wrapper(x), first)
    assert model.prepared.builds == 1  # kept over calls
    got, ref = _change(model, how, wrapper, x)
    _close(got, ref, FORWARD_RTOL)
    assert not torch.equal(got, first)
    assert model.prepared.builds == 2
    if how == "functional_call":  # back to the module's own tensors
        _close(model.fused_forward(x), first, 0.0)
        assert model.prepared.builds == 3


@torch.no_grad()
def test_prepared_weights_follow_a_replaced_module():
    model, x = _tiny(True), _input(3)
    model.fused_forward(x)
    gen = torch.Generator().manual_seed(4)
    model.layer1_0.bn2 = _bn_module(model.layer1_0.bn2.num_features, gen)
    _close(model.fused_forward(x), model(x), FORWARD_RTOL)
    assert model.prepared.builds == 2
    model.layer1_0.bn2.running_var.mul_(3.0)  # the new module's tensor
    got = model.fused_forward(x)
    _close(got, model(x), FORWARD_RTOL)
    assert model.prepared.builds == 3


def _unfused(model: ResNet, x, train, pad_mask=None, generator=None):
    """The face teachers' forward without the fused path, written out."""
    bn = dict(train=train, bn_mask=pad_mask)
    x = x.to(model.dtype).permute(0, 3, 1, 2)
    x = stem_pool(F.relu(_bn(_conv(x, model.conv1), model.bn1, **bn)))
    for name in model.blocks:
        blk = getattr(model, name)
        y = F.relu(_bn(_conv(x, blk.conv1), blk.bn1, **bn))
        y = F.relu(_bn(_conv(y, blk.conv2), blk.bn2, **bn))
        y = _bn(_conv(y, blk.conv3), blk.bn3, **bn)
        if blk.se is not None:
            y = blk.se(y)
        r = _bn(_conv(x, blk.downsample), blk.bn_down, **bn) if blk.project \
            else x
        x = F.relu(y + r)
    x = x.mean(dim=(2, 3), dtype=torch.float32)
    return F.linear(x, model.prediction.weight.float(),
                    model.prediction.bias.float())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval_grad"])
@pytest.mark.parametrize("use_se", [True, False], ids=["senet50", "resnet50"])
def test_train_and_grad_enabled_eval_run_the_unfused_code(use_se, train):
    model = _tiny(use_se)
    ref_model = copy.deepcopy(model)
    x = _input(2)
    mask = torch.tensor([1.0, 1.0, 0.0])
    if train:
        model.train(), ref_model.train()
    got = model(x, train=train, pad_mask=mask)
    ref = _unfused(ref_model, x, train, mask)
    assert got.requires_grad and torch.equal(got, ref)
    for (name, a), (_, b) in zip(model.named_buffers(),
                                 ref_model.named_buffers()):
        assert torch.equal(a, b), name
    if train:  # the running statistics moved, alike
        assert not torch.equal(model.bn1.running_mean,
                               _tiny(use_se).bn1.running_mean)
    assert model.prepared.builds == 0


def _nhwc_at(shape: tuple, dtype: torch.dtype, offset: int) -> torch.Tensor:
    """A contiguous NHWC tensor ``offset`` elements into a fresh buffer."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype,c,offset,where", [
    (torch.bfloat16, 12, 0, "y"),        # 24 bytes a pixel
    (torch.bfloat16, 16, 1, "y"),        # y's data 2 bytes off
    (torch.bfloat16, 16, 3, "residual"),  # the residual's 6 bytes off
    (torch.float32, 6, 0, "y"),          # 24 bytes a pixel
    (torch.float32, 8, 2, "out"),        # out's data 8 bytes off
    (torch.bfloat16, 16, 0, None),       # 32 bytes a pixel, aligned
    (torch.float32, 4, 0, None)])        # 16 bytes a pixel, aligned
def test_kernel_checks_refuse_narrow_or_misaligned(dtype, c, offset, where):
    shape = (2, 3, 5, c)
    y, r, out = (_nhwc_at(shape, dtype, offset if where == k else 0)
                 for k in ("y", "residual", "out"))
    if where is None:
        _ffi.check_lanes("affine_gate_add_relu", y, r, None, out)
        return
    with pytest.raises(ValueError, match="16-byte"):
        _ffi.check_lanes("affine_gate_add_relu", y, r, None, out)
