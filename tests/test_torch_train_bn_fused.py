"""The dispatch of the student's train-mode BatchNorm and ReLU
(``models/vggm.batch_norm_train``, ``ops/train_bn.py``) on the CPU.

The kernels run only on the card, where ``tests/test_torch_kernels_gpu.py``
holds them to the eager code (``models/vggm._batch_norm_train``, then
``F.relu``) and their statistics' gradient to autograd. Here: the kernels
only for a 4-D CUDA bf16 ``channels_last`` tensor with C a multiple of 8,
no mesh and ``use_kernels``; every other call runs the eager code,
bitwise; the wrappers refuse a CPU tensor; the student's Flax parity
through ``relu=True``.
"""

import pytest
import torch
import torch.nn.functional as F

from mcncrossmodalemotions_torch.models import vggm
from mcncrossmodalemotions_torch.ops import train_bn


class _OnCard:
    """A CPU tensor's stand-in that reports it lies on the card: what
    ``takes`` reads of it is the tensor's own."""

    is_cuda = True

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


def test_dispatch_takes_the_kernels_only_where_they_apply():
    """The kernels for a 4-D CUDA bf16 ``channels_last`` tensor with C a
    multiple of 8 and no mesh; the plain path for a CPU tensor of any
    dtype, for fp32 and fp64 on the card, for a tensor that is not
    ``channels_last``, for C = 12, for an empty one and under a mesh."""
    cl = torch.channels_last
    x = torch.zeros(2, 16, 5, 3, dtype=torch.bfloat16).contiguous(memory_format=cl)
    assert train_bn.takes(_OnCard(x))
    assert not train_bn.takes(_OnCard(x), mesh=object())
    for dtype in (torch.float32, torch.float64, torch.float16):
        assert not train_bn.takes(_OnCard(x.to(dtype)))
    assert not train_bn.takes(_OnCard(x.contiguous()))  # NCHW memory
    assert not train_bn.takes(_OnCard(
        torch.zeros(2, 12, 5, 3, dtype=torch.bfloat16).contiguous(memory_format=cl)))
    assert not train_bn.takes(_OnCard(
        torch.zeros(0, 16, 5, 3, dtype=torch.bfloat16).contiguous(memory_format=cl)))
    assert not train_bn.takes(_OnCard(torch.zeros(2, 16, 5, dtype=torch.bfloat16)))
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        assert not train_bn.takes(x.to(dtype))  # the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
def test_cpu_calls_run_the_eager_code(monkeypatch, dtype, relu):
    """``batch_norm_train`` on a CPU tensor never reaches the Function: the
    eager code and ``F.relu``, bitwise, and no plain call is counted (the
    count is of CUDA tensors)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU took the fused path")

    monkeypatch.setattr(train_bn, "batch_norm", refuse)
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(3, 16, 4, 4, generator=gen) * 3 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    mask = torch.tensor([1.0, 0.0, 1.0])
    bn_a, bn_b = torch.nn.BatchNorm2d(16), torch.nn.BatchNorm2d(16)
    if dtype == torch.float64:
        bn_a, bn_b = bn_a.double(), bn_b.double()
    before = dict(train_bn.calls)
    got = vggm.batch_norm_train(x, bn_a, mask, relu=relu)
    want = vggm._batch_norm_train(x, bn_b, mask, True, None)
    assert torch.equal(got, F.relu(want) if relu else want)
    assert torch.equal(bn_a.running_var, bn_b.running_var)
    assert train_bn.calls == before


def test_student_parity_with_flax_holds_through_relu(monkeypatch):
    """``tests/test_torch_train_bn.py``'s train-mode parity with Flax
    (masked, fp32 logits and every running statistic within 1e-5), with
    the student's six BatchNorms seen to call ``batch_norm_train(...,
    relu=True)``."""
    import test_torch_train_bn as parity

    seen = []
    inner = vggm.batch_norm_train

    def spy(*args, **kwargs):
        seen.append(kwargs.get("relu", False))
        return inner(*args, **kwargs)

    monkeypatch.setattr(vggm, "batch_norm_train", spy)
    parity.test_train_forward_and_batch_stats_match_flax(True)
    assert seen == [True] * 6


def _cpu_calls() -> dict:
    """Each wrapper's call on CPU tensors of the kernels' own layout: NHWC
    bf16 [2, 3, 3, 8], fp32 per-channel vectors and partials."""
    x = torch.zeros(2, 3, 3, 8, dtype=torch.bfloat16)
    v, part = torch.ones(8), torch.zeros(2, 16)
    saved = torch.ones(4, 8)
    return {
        "stats": lambda: train_bn.stats(x, None),
        "finalize": lambda: train_bn.finalize(part, None, 2, 9, v, v, v, v,
                                              1e-5, 0.9, True),
        "apply": lambda: train_bn.apply(x, v, v, True),
        "backward_reduce": lambda: train_bn.backward_reduce(x, x, v, v, saved,
                                                            True),
        "backward_finalize": lambda: train_bn.backward_finalize(part, saved, v,
                                                                v, 1e-5),
        "backward_apply": lambda: train_bn.backward_apply(
            x, x, v, v, saved, None, True),
    }


@pytest.mark.parametrize("wrapper", list(_cpu_calls()))
def test_wrappers_count_no_launch_on_the_cpu(wrapper):
    """Each of the six wrappers refuses CPU tensors (the CPU runs the eager
    code, never the kernels' wrappers) and counts no launch."""
    fn = getattr(train_bn, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        _cpu_calls()[wrapper]()
    assert fn.launches == before


@pytest.mark.parametrize("use_kernels", [True, False])
def test_use_kernels_false_keeps_the_eager_batch_norm(monkeypatch,
                                                      use_kernels):
    """The student's train forward hands ``use_kernels`` to its six
    BatchNorms: with a tensor the kernels take (the CPU's stood in for the
    card's), True reaches ``ops/train_bn.batch_norm`` six times, False
    never (the plain step of ``make_train_step(use_kernels=False)``)."""
    fused = []

    def stand_in(x, bn, pad_mask, update, momentum, relu):
        fused.append(relu)
        y = vggm._batch_norm_train(x, bn, pad_mask, update, None)
        return torch.relu(y) if relu else y

    monkeypatch.setattr(train_bn, "takes", lambda x, mesh=None: mesh is None)
    monkeypatch.setattr(train_bn, "batch_norm", stand_in)
    model = vggm.VGGMStudent(fc6_features=64, fc7_features=32,
                             dtype=torch.float32)
    model(torch.randn(2, 512, 100, 1), train=True, use_kernels=use_kernels)
    assert fused == ([True] * 6 if use_kernels else [])
