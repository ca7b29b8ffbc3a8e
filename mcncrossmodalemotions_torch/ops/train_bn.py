"""The student's train-mode BatchNorm and its ReLU (``csrc/train_bn.cu``).

Replaces no TPU kernel: the JAX package leaves Flax's masked BatchNorm to
XLA. ``models/vggm.batch_norm_train`` takes this path for a 4-D CUDA bf16
tensor in ``channels_last`` memory with C a multiple of 8, no mesh and
``use_kernels``; the CPU, fp32, fp64, the global BatchNorm under a mesh
and ``use_kernels=False`` keep the eager code there. The function is that code's (Flax's ``nn.BatchNorm``): the
statistics of the rows where ``mask > 0`` (all rows without a mask) in
fp32, the biased variance in the fast form ``clamp(E[x^2] - E[x]^2, 0)``,
the running update ``momentum * running + (1 - momentum) * batch``, then
``relu(x * scale + shift)`` (or the affine alone) rounded once to x's
dtype. Two passes each way, each a wrapper that counts its launches:

- forward: ``stats`` (the masked sums of x and x^2, as rows of block
  partials), ``finalize`` (their fixed-order sum; scale, shift, the
  statistics the backward needs; the running update), ``apply``;
- backward: ``backward_reduce`` (the sums of g and g (x - mean), g the
  gradient through the ReLU, whose mask the forward's affine recomputed
  gives), ``backward_finalize`` (dgamma, dbeta and the coefficients a, b
  of the statistics' gradient), ``backward_apply`` (``dx = g scale +
  w[n] (a + b x)``).

``BatchNormReLU`` is the ``torch.autograd.Function`` over them; it saves
x, scale, shift, the statistics and the mask, and no fp32 copy of x. The
wrappers run on the card alone and raise on a tensor the kernels do not
take (a CPU one too): the eager ``_batch_norm_train`` is the one plain
version, the path of every other input and the kernels' reference in the
tests. Every tensor is NHWC: the student's ``channels_last`` activations
give a contiguous ``x.permute(0, 2, 3, 1)``.

``calls`` counts the fused path's engagement: ``fused`` and
``fused_backward``, the Function's forwards and backwards on the card;
``plain``, ``batch_norm_train`` calls on a CUDA tensor that took the
eager code (``models/vggm.py`` adds those).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from mcncrossmodalemotions_torch.ops import _ffi
from mcncrossmodalemotions_torch.ops._ffi import FLOAT, INT, VOIDP

calls = {"fused": 0, "fused_backward": 0, "plain": 0}
_chunks: Dict[Tuple[int, int, int], int] = {}  # (batch, hw, c) -> chunks
LIB = _ffi.Library("train_bn", {
    "train_bn_chunks": (INT, [INT] * 3),
    "train_bn_stats_bf16": (INT, [VOIDP] * 3 + [INT] * 4 + [VOIDP]),
    "train_bn_finalize": (INT, [VOIDP, INT, VOIDP, INT, INT, INT]
                          + [VOIDP] * 4 + [FLOAT] * 3 + [INT] + [VOIDP] * 4),
    "train_bn_apply_bf16": (INT, [VOIDP] * 4 + [INT] * 4 + [VOIDP]),
    "train_bn_reduce_bf16": (INT, [VOIDP] * 6 + [INT] * 5 + [VOIDP]),
    "train_bn_grad_finalize": (INT, [VOIDP, INT, INT] + [VOIDP] * 3
                               + [FLOAT, VOIDP, VOIDP]),
    "train_bn_dx_bf16": (INT, [VOIDP] * 7 + [INT] * 4 + [VOIDP])})


def takes(x: torch.Tensor, mesh=None) -> bool:
    """Whether the kernels take NCHW ``x`` (``batch_norm_train`` asks when
    ``use_kernels``): a 4-D CUDA bf16 tensor in ``channels_last`` memory
    with C a multiple of 8, not empty, and no mesh (whose all-reduce of
    the sums the eager code does)."""
    return (mesh is None and x.is_cuda and x.dtype == torch.bfloat16
            and x.dim() == 4 and x.shape[1] % 8 == 0 and x.numel() > 0
            and x.is_contiguous(memory_format=torch.channels_last))


# -- the kernels ------------------------------------------------------------

def _check(who: str, *tensors: torch.Tensor) -> None:
    """Raise on activations the kernels do not take: contiguous NHWC bf16
    of one shape with C a multiple of 8 (``_ffi.check_lanes``), not empty,
    on one card, 16-byte aligned."""
    ref = tensors[0]
    if not ref.is_cuda:
        raise ValueError(f"{who}: the kernels take CUDA tensors, got one on "
                         f"{ref.device}")
    for t in tensors:
        _ffi.check_dtype(who, t, (torch.bfloat16,))
    _ffi.check_nhwc(who, *tensors)
    _ffi.check_device(who, *tensors)
    if any(t.shape != ref.shape for t in tensors) or not ref.numel():
        raise ValueError(f"{who}: tensors of shapes "
                         f"{[tuple(t.shape) for t in tensors]}, not one "
                         "shape, or empty")
    _ffi.check_lanes(who, *tensors)


def _check_vectors(who: str, device, c: int, *vectors: torch.Tensor) -> None:
    """Raise on a per-channel fp32 tensor the kernels do not take: contiguous
    on ``device`` (a card), ``c`` entries a row, 16-byte aligned."""
    if device.type != "cuda":
        raise ValueError(f"{who}: the kernels take CUDA tensors, got {device}")
    for v in vectors:
        if (v.dtype != torch.float32 or not v.is_contiguous()
                or v.device != device or v.shape[-1] != c
                or v.data_ptr() % 16):
            raise ValueError(f"{who}: per-channel tensors must be contiguous, "
                             f"aligned fp32 [.., {c}] on {device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _mask_arg(who: str, mask: Optional[torch.Tensor], batch: int, device):
    """The mask's pointer (None without one), raising on a mask the kernels
    do not take."""
    if mask is None:
        return None
    if (mask.dtype != torch.float32 or mask.shape != (batch,)
            or not mask.is_contiguous() or mask.device != device):
        raise ValueError(f"{who}: the mask must be contiguous fp32 [{batch}] "
                         f"on {device}, got {mask.dtype} {tuple(mask.shape)} "
                         f"on {mask.device}")
    return mask.data_ptr()


def chunks(batch: int, hw: int, c: int) -> int:
    """The chunks of an image's rows the two reductions walk on the card:
    their partials have batch x chunks rows."""
    key = (batch, hw, c)
    n = _chunks.get(key)
    if n is None:
        n = LIB.fn("train_bn_chunks")(batch, hw, c)
        if n <= 0:
            raise ValueError(f"train_bn: no launch for batch {batch}, "
                             f"{hw} positions, {c} channels")
        _chunks[key] = n
    return n


@_ffi.counted("stats")
def stats(x: torch.Tensor, mask: Optional[torch.Tensor], *,
          stream: Optional[int] = None) -> torch.Tensor:
    """Rows of partial sums [P, 2C], fp32, of x and x^2 over the rows
    where the mask is > 0 (every row without one)."""
    _check("stats", x)
    m = _mask_arg("stats", mask, x.shape[0], x.device)
    b, h, w, c = x.shape
    part = torch.empty((b * chunks(b, h * w, c), 2 * c), dtype=torch.float32,
                       device=x.device)
    LIB.launch("train_bn_stats_bf16", stats, x, (
        x.data_ptr(), m, part.data_ptr(), b, h * w, c, part.shape[0] // b),
        stream)
    return part


@_ffi.counted("finalize")
def finalize(part: torch.Tensor, mask: Optional[torch.Tensor], batch: int,
             hw: int, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor,
             eps: float, momentum: float, update: bool, *,
             stream: Optional[int] = None) -> tuple:
    """(scale, shift, saved) from the partials: ``saved`` [4, C] holds the
    mean, the (clamped) variance, 1 where the clamp let the variance
    through, and the count. With ``update`` the running statistics move
    in place."""
    c = part.shape[1] // 2
    _check_vectors("finalize", part.device, 2 * c, part)
    _check_vectors("finalize", part.device, c, weight, bias, running_mean,
                   running_var)
    m = _mask_arg("finalize", mask, batch, part.device)
    out = torch.empty((6, c), dtype=torch.float32, device=part.device)
    scale, shift, saved = out[0], out[1], out[2:]
    LIB.launch("train_bn_finalize", finalize, part, (
        part.data_ptr(), part.shape[0], m, batch, hw, c, weight.data_ptr(),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
        eps, momentum, 1.0 - momentum, int(update), scale.data_ptr(),
        shift.data_ptr(), saved.data_ptr()), stream)
    return scale, shift, saved


@_ffi.counted("apply")
def apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          relu: bool, *, stream: Optional[int] = None) -> torch.Tensor:
    """``relu(x * scale + shift)`` (or the affine alone) in x's dtype, a new
    NHWC tensor."""
    _check("apply", x)
    _check_vectors("apply", x.device, x.shape[3], scale, shift)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, h, w, c = x.shape
    LIB.launch("train_bn_apply_bf16", apply, x, (
        x.data_ptr(), y.data_ptr(), scale.data_ptr(), shift.data_ptr(), b,
        h * w, c, int(relu)), stream)
    return y


@_ffi.counted("backward_reduce")
def backward_reduce(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, saved: torch.Tensor, relu: bool, *,
                    stream: Optional[int] = None) -> torch.Tensor:
    """Rows of partial sums [P, 2C] of g and g (x - mean) over every row, g
    the gradient through the ReLU (``dy`` itself without one)."""
    _check("backward_reduce", x, dy)
    b, h, w, c = x.shape
    mean = saved[0]
    _check_vectors("backward_reduce", x.device, c, scale, shift, mean)
    part = torch.empty((b * chunks(b, h * w, c), 2 * c), dtype=torch.float32,
                       device=x.device)
    LIB.launch("train_bn_reduce_bf16", backward_reduce, x, (
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), part.data_ptr(), b, h * w, c, part.shape[0] // b,
        int(relu)), stream)
    return part


@_ffi.counted("backward_finalize")
def backward_finalize(part: torch.Tensor, saved: torch.Tensor,
                      weight: torch.Tensor, scale: torch.Tensor, eps: float,
                      *, stream: Optional[int] = None) -> torch.Tensor:
    """coef [4, C]: dgamma, dbeta and the coefficients a, b of the
    statistics' gradient (``dx = g scale + w[n] (a + b x)``)."""
    c = part.shape[1] // 2
    _check_vectors("backward_finalize", part.device, 2 * c, part)
    _check_vectors("backward_finalize", part.device, c, saved, weight, scale)
    coef = torch.empty((4, c), dtype=torch.float32, device=part.device)
    LIB.launch("train_bn_grad_finalize", backward_finalize, part, (
        part.data_ptr(), part.shape[0], c, saved.data_ptr(), weight.data_ptr(),
        scale.data_ptr(), eps, coef.data_ptr()), stream)
    return coef


@_ffi.counted("backward_apply")
def backward_apply(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, coef: torch.Tensor,
                   mask: Optional[torch.Tensor], relu: bool, *,
                   stream: Optional[int] = None) -> torch.Tensor:
    """``dx = g * scale + w[n] * (a + b * x)`` in x's dtype, a new NHWC
    tensor."""
    _check("backward_apply", x, dy)
    b, h, w, c = x.shape
    _check_vectors("backward_apply", x.device, c, scale, shift, coef)
    m = _mask_arg("backward_apply", mask, x.shape[0], x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    LIB.launch("train_bn_dx_bf16", backward_apply, x, (
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        coef.data_ptr(), m, dx.data_ptr(), b, h * w, c, int(relu)), stream)
    return dx


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class BatchNormReLU(torch.autograd.Function):
    """Train-mode BatchNorm of NCHW ``x`` (bf16 in ``channels_last`` memory
    on the card) with the ReLU that follows when ``relu``, through the
    kernels above. ``mask`` is None or fp32 [B] on x's card."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mask, eps,
                momentum, update, relu):
        b, _, h, w = x.shape
        xn = _nhwc(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            part = stats(xn, mask, stream=stream)
            scale, shift, saved = finalize(
                part, mask, b, h * w, weight, bias, running_mean, running_var,
                eps, momentum, update, stream=stream)
            y = apply(xn, scale, shift, relu, stream=stream)
        ctx.save_for_backward(x, weight, scale, shift, saved, mask)
        ctx.eps, ctx.relu = eps, relu
        calls["fused"] += 1
        return y.permute(0, 3, 1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, scale, shift, saved, mask = ctx.saved_tensors
        xn = _nhwc(x)
        dyn = _nhwc(dy.contiguous(memory_format=torch.channels_last))
        dx = None
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            part = backward_reduce(dyn, xn, scale, shift, saved, ctx.relu,
                                   stream=stream)
            coef = backward_finalize(part, saved, weight, scale, ctx.eps,
                                     stream=stream)
            if ctx.needs_input_grad[0]:
                dx = backward_apply(dyn, xn, scale, shift, coef, mask,
                                    ctx.relu, stream=stream).permute(0, 3, 1, 2)
        calls["fused_backward"] += 1
        return (dx, coef[0], coef[1]) + (None,) * 7


def batch_norm(x: torch.Tensor, bn: torch.nn.BatchNorm2d,
               pad_mask: Optional[torch.Tensor], update: bool,
               momentum: float, relu: bool) -> torch.Tensor:
    """``bn`` in train mode over NCHW ``x`` through ``BatchNormReLU``: the
    rows where ``pad_mask > 0`` give the statistics, ``update`` moves the
    running ones by ``momentum``, ``relu`` applies the ReLU."""
    mask = None
    if pad_mask is not None:
        mask = pad_mask.to(torch.float32).reshape(-1).contiguous()
    return BatchNormReLU.apply(x, bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, mask, bn.eps, momentum, update,
                               relu)
