"""K2: the 3x3 stride-2 max-pool kernels (``csrc/max_pool_3x3s2.cu``).

Replaces the TPU kernel ``mcncrossmodalemotions_tpu/ops/pallas_pool.py``:
its forward (``max_pool_3x3s2`` -> ``_pool_fwd_pallas``) and its
``custom_vjp`` backward (``_bwd`` -> ``_sas_grad``, XLA's
SelectAndScatterAdd). The layout stays the JAX one, NHWC, at the public
functions; the student keeps its activations ``channels_last``, so that
``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view and costs no copy.
The source note in ``csrc/max_pool_3x3s2.cu`` says what bounds each
kernel on the card and what its design does about that.

Three kernels, each behind a wrapper that counts its launches:

- ``max_pool_3x3s2_cuda``: the index-free forward, for inference and
  ``torch.no_grad()``;
- ``max_pool_3x3s2_idx_cuda``: the forward that also writes each window's
  winner as a uint8 in-window position ``dy * 3 + dx`` (0..8);
- ``max_pool_3x3s2_bwd_cuda``: routes ``dy`` to those winners.

``max_pool_3x3s2_train`` is the differentiable pool: a
``torch.autograd.Function`` whose forward is the with-index kernel and
whose backward is the backward kernel. One winner per window, the first
maximum in row-major window order: the rule of ``F.max_pool2d`` and of
XLA's ``ge`` SelectAndScatter alike (for NaN, PyTorch's rule, where a NaN
wins). Each wrapper runs its plain PyTorch version for a CPU tensor and
its kernel for a CUDA tensor; the plain version of the backward as a whole
is autograd of ``F.max_pool2d`` (``max_pool_3x3s2_backward``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcncrossmodalemotions_torch.ops import _ffi
from mcncrossmodalemotions_torch.ops._ffi import INT, VOIDP

WINDOW = 3
STRIDE = 2

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIB = _ffi.Library("max_pool_3x3s2", {
    f"max_pool_3x3s2{kind}_{sfx}": (INT, [VOIDP] * n + [INT] * 4 + [VOIDP])
    for sfx in _SUFFIX.values()
    for kind, n in (("", 2), ("_idx", 3), ("_bwd", 3))})


def _out_hw(h: int, w: int):
    return (h - WINDOW) // STRIDE + 1, (w - WINDOW) // STRIDE + 1


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, H, W, C] -> [B, (H-3)//2+1, (W-3)//2+1, C]."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), WINDOW, STRIDE)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3s2_with_index(x: torch.Tensor):
    """Plain version of the with-index forward: (y, idx), idx uint8 of
    y's shape holding each window's winner as ``dy * 3 + dx``."""
    y, flat = F.max_pool2d(x.permute(0, 3, 1, 2), WINDOW, STRIDE,
                           return_indices=True)
    ho, wo = y.shape[-2:]
    w = x.shape[2]
    oi = torch.arange(ho, device=x.device).view(ho, 1)
    oj = torch.arange(wo, device=x.device).view(1, wo)
    rel = (flat // w - STRIDE * oi) * WINDOW + (flat % w - STRIDE * oj)
    return y.permute(0, 2, 3, 1), rel.to(torch.uint8).permute(0, 2, 3, 1)


def max_pool_3x3s2_backward_from_index(dy: torch.Tensor, idx: torch.Tensor,
                                       h: int, w: int) -> torch.Tensor:
    """Plain version of the backward kernel: dx [B, h, w, C] from dy and
    the with-index forward's idx, summed in fp32 (fp64 for fp64 dy) in
    window order."""
    bsz, ho, wo, c = dy.shape
    oi = torch.arange(ho, device=dy.device).view(1, ho, 1, 1)
    oj = torch.arange(wo, device=dy.device).view(1, 1, wo, 1)
    idx = idx.long()
    flat = ((STRIDE * oi + idx // WINDOW) * w + STRIDE * oj + idx % WINDOW)
    flat = flat.permute(0, 3, 1, 2).reshape(bsz, c, ho * wo)
    acc = torch.promote_types(dy.dtype, torch.float32)
    src = dy.to(acc).permute(0, 3, 1, 2).reshape(bsz, c, ho * wo)
    dx = torch.zeros(bsz, c, h * w, dtype=acc, device=dy.device)
    dx.scatter_add_(2, flat, src)
    return dx.view(bsz, c, h, w).permute(0, 2, 3, 1).to(dy.dtype)


def max_pool_3x3s2_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the whole backward: autograd of ``F.max_pool2d``
    on the NCHW view of ``x`` (NHWC), against ``dy`` (NHWC)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(max_pool_3x3s2(x), x, dy)
    return dx


def _check(x: torch.Tensor, who: str) -> None:
    """Raise on what the kernels do not take (x is a CUDA NHWC input)."""
    _ffi.check_dtype(who, x, _SUFFIX)
    _ffi.check_nhwc(who, x)
    if x.shape[1] < WINDOW or x.shape[2] < WINDOW:
        raise ValueError(f"{who} expects [B, H>=3, W>=3, C], "
                         f"got {tuple(x.shape)}")


@_ffi.counted("max_pool_3x3s2")
def max_pool_3x3s2_cuda(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 VALID max pool over NHWC, bf16 or fp32.

    A CPU tensor goes through the plain version. A CUDA tensor must be a
    contiguous NHWC bf16/fp32 tensor with H, W >= 3 and goes through the
    kernel; each launch adds one to ``max_pool_3x3s2_cuda.launches``.
    """
    if _ffi.on_cpu("max_pool_3x3s2_cuda", x):
        return max_pool_3x3s2(x)
    _check(x, "max_pool_3x3s2_cuda")
    bsz, h, w, c = x.shape
    out = torch.empty((bsz, *_out_hw(h, w), c), dtype=x.dtype, device=x.device)
    LIB.launch(f"max_pool_3x3s2_{_SUFFIX[x.dtype]}", max_pool_3x3s2_cuda, x,
               (x.data_ptr(), out.data_ptr(), bsz, h, w, c))
    return out


@_ffi.counted("max_pool_3x3s2_idx")
def max_pool_3x3s2_idx_cuda(x: torch.Tensor):
    """The forward that also returns each window's winner: (y, idx uint8).

    CPU: the plain version. CUDA: the kernel (same checks as
    ``max_pool_3x3s2_cuda``); each launch adds one to
    ``max_pool_3x3s2_idx_cuda.launches``. ``y`` is bitwise equal to the
    index-free forward's.
    """
    if _ffi.on_cpu("max_pool_3x3s2_idx_cuda", x):
        return max_pool_3x3s2_with_index(x)
    _check(x, "max_pool_3x3s2_idx_cuda")
    bsz, h, w, c = x.shape
    out = torch.empty((bsz, *_out_hw(h, w), c), dtype=x.dtype, device=x.device)
    idx = torch.empty(out.shape, dtype=torch.uint8, device=x.device)
    LIB.launch(f"max_pool_3x3s2_idx_{_SUFFIX[x.dtype]}",
               max_pool_3x3s2_idx_cuda, x,
               (x.data_ptr(), out.data_ptr(), idx.data_ptr(), bsz, h, w, c))
    return out, idx


@_ffi.counted("max_pool_3x3s2_bwd")
def max_pool_3x3s2_bwd_cuda(dy: torch.Tensor, idx: torch.Tensor,
                            h: int, w: int) -> torch.Tensor:
    """dx [B, h, w, C] of the pool of an [B, h, w, C] input, from the
    upstream gradient ``dy`` and the with-index forward's ``idx``.

    CPU: the plain version. CUDA: ``dy`` contiguous NHWC bf16/fp32, ``idx``
    contiguous uint8 of dy's shape on the same device; each launch adds one
    to ``max_pool_3x3s2_bwd_cuda.launches``.
    """
    if _ffi.on_cpu("max_pool_3x3s2_bwd_cuda", dy):
        return max_pool_3x3s2_backward_from_index(dy, idx, h, w)
    _ffi.check_dtype("max_pool_3x3s2_bwd_cuda", dy, _SUFFIX)
    if h < WINDOW or w < WINDOW or dy.dim() != 4 or tuple(dy.shape[1:3]) != \
            _out_hw(h, w):
        raise ValueError(f"max_pool_3x3s2_bwd_cuda: dy {tuple(dy.shape)} is "
                         f"not the pool output of a {h}x{w} input")
    if (idx.dtype != torch.uint8 or idx.shape != dy.shape
            or idx.device != dy.device):
        raise ValueError("max_pool_3x3s2_bwd_cuda: idx must be uint8 of dy's "
                         "shape on dy's device")
    _ffi.check_nhwc("max_pool_3x3s2_bwd_cuda", dy, idx)
    bsz, c = dy.shape[0], dy.shape[3]
    dx = torch.empty((bsz, h, w, c), dtype=dy.dtype, device=dy.device)
    LIB.launch(f"max_pool_3x3s2_bwd_{_SUFFIX[dy.dtype]}",
               max_pool_3x3s2_bwd_cuda, dy,
               (dy.data_ptr(), idx.data_ptr(), dx.data_ptr(), bsz, h, w, c))
    return dx


class _MaxPool3x3s2(torch.autograd.Function):
    """K2 with its backward: the with-index forward saves only the uint8
    winners (one byte per output; autograd of ``F.max_pool2d`` keeps
    int64 indices), and the backward kernel gathers dy from them."""

    @staticmethod
    def forward(ctx, x):
        y, idx = max_pool_3x3s2_idx_cuda(x)
        ctx.save_for_backward(idx)
        ctx.hw = x.shape[1:3]
        return y

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return max_pool_3x3s2_bwd_cuda(dy.contiguous(), idx, *ctx.hw)


def max_pool_3x3s2_train(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3/2 max pool over NHWC through the K2 kernels (their
    plain versions for a CPU tensor). ``y`` is contiguous NHWC."""
    return _MaxPool3x3s2.apply(x)
