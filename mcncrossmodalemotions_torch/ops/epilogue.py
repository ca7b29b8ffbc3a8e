"""The face teachers' eval-mode epilogues (``csrc/teacher_epilogue.cu``).

Replace no TPU kernel: the JAX package leaves eval BatchNorm, ReLU, the
squeeze-excitation and residual elementwise work and VGG's 2x2 pools to
XLA. In the port's eval forward without autograd
(``models/resnet.ResNet.fused_forward``, ``models/vggface.VGGFace.
fused_forward``) each BatchNorm is a per-channel affine ``s y + t`` on the
raw bf16 conv output, ``s = gamma * rsqrt(running_var + eps)`` and ``t =
beta - running_mean * s`` in fp32 (``bn_affine``; a conv bias before it
adds ``s * bias`` to ``t``), and a conv bias with no BatchNorm is ``s = 1``,
``t = bias``; the affine is applied inside one of four kernels:

- ``affine_relu``: ``relu(s y + t)``, in place with ``out=y``;
- ``affine_squeeze``: the SE squeeze ``mean_hw(s y + t)`` summed in fp32,
  [B, C] in y's dtype (the one rounding the SE MLP's input takes);
- ``affine_gate_add_relu``: ``relu((s y + t) gate + r)``, ``r`` the block
  input or ``rs yd + rt`` of the raw projection conv output
  (``residual_affine=(rs, rt)``), ``gate`` [B, C] or None;
- ``affine_relu_pool2x2``: ``max_pool2d(relu(s y + t), 2, 2)``, the end of
  a VGG block, [B, H // 2, W // 2, C] (floor, as ``F.max_pool2d``): the
  affine before the max, since ``s`` may be negative.

Every tensor is NHWC [B, H, W, C]: the teachers keep their activations in
``channels_last`` memory, so ``y.permute(0, 2, 3, 1)`` of a conv output is
a contiguous NHWC view and costs no copy. Each wrapper runs its plain
PyTorch version for a CPU tensor and its kernel for a CUDA one, raising on
a CUDA tensor the kernel does not take (not contiguous NHWC, not
bf16/fp32, mismatched shapes or dtypes, C not a whole number of 16-byte
vectors, data not 16-byte aligned; for the pool, H or W under 2): there
is no narrower path. Each launch adds one to the wrapper's ``.launches``.

The host's path a launch is short, since a forward makes 65 of them: a
caller that passes ``stream`` (``torch.cuda.current_stream().cuda_stream``,
read once a forward) with the tensors' device current skips the device
guard and the stream lookup of ``_ffi.Library.launch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mcncrossmodalemotions_torch.ops import _ffi
from mcncrossmodalemotions_torch.ops._ffi import INT, VOIDP

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIB = _ffi.Library("teacher_epilogue", {
    f"{base}_{sfx}": (INT, args) for sfx in _SUFFIX.values()
    for base, args in (
        ("affine_relu", [VOIDP] * 4 + [INT] * 3 + [VOIDP]),
        ("affine_squeeze", [VOIDP] * 4 + [INT] * 3 + [VOIDP]),
        ("affine_gate_add_relu", [VOIDP] * 8 + [INT] * 3 + [VOIDP]),
        ("affine_relu_pool2x2", [VOIDP] * 4 + [INT] * 4 + [VOIDP]))})


def bn_affine(weight: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, t), fp32 [C]: eval BatchNorm as ``s y + t``."""
    s = weight.float() * torch.rsqrt(running_var.float() + eps)
    return s.contiguous(), (bias.float() - running_mean.float() * s).contiguous()


# -- plain versions (NHWC, any strides) ----------------------------------

def affine_relu_plain(y: torch.Tensor, s: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    return torch.relu(y.float() * s + t).to(y.dtype)


def affine_squeeze_plain(y: torch.Tensor, s: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
    return (y.float() * s + t).mean(dim=(1, 2)).to(y.dtype)


def affine_gate_add_relu_plain(y: torch.Tensor, s: torch.Tensor,
                               t: torch.Tensor, residual: torch.Tensor,
                               gate: Optional[torch.Tensor] = None,
                               residual_affine: Optional[tuple] = None
                               ) -> torch.Tensor:
    v = y.float() * s + t
    if gate is not None:
        v = v * gate.float()[:, None, None, :]
    r = residual.float()
    if residual_affine is not None:
        r = r * residual_affine[0] + residual_affine[1]
    return torch.relu(v + r).to(y.dtype)


def affine_relu_pool2x2_plain(y: torch.Tensor, s: torch.Tensor,
                              t: torch.Tensor) -> torch.Tensor:
    v = torch.relu(y.float() * s + t).permute(0, 3, 1, 2)
    return F.max_pool2d(v, 2, 2).permute(0, 2, 3, 1).to(y.dtype)


# -- the kernels ----------------------------------------------------------

def _check(who: str, y: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
           *others: Optional[torch.Tensor]) -> None:
    """Raise on what the kernels do not take: each lane reads and writes
    16 bytes (``_ffi.check_lanes``). ``others`` are tensors of y's dtype and
    device (the shapes are the caller's to check)."""
    _ffi.check_dtype(who, y, _SUFFIX)
    _ffi.check_nhwc(who, y)
    c = y.shape[3]
    for v in (s, t):
        if (v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous()
                or v.device != y.device):
            raise ValueError(f"{who}: s and t must be contiguous fp32 [{c}] "
                             f"on {y.device}, got {v.dtype} {tuple(v.shape)} "
                             f"on {v.device}")
    for v in others:
        if v is not None and (v.dtype != y.dtype or v.device != y.device
                              or not v.is_contiguous()):
            raise ValueError(f"{who}: every tensor must be contiguous "
                             f"{y.dtype} on {y.device}")
    _ffi.check_lanes(who, y, *others)


@_ffi.counted("affine_relu")
def affine_relu(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor, *,
                out: Optional[torch.Tensor] = None,
                stream: Optional[int] = None) -> torch.Tensor:
    """``relu(s y + t)`` over NHWC ``y``, into ``out`` (``y`` itself for in
    place) or a new tensor."""
    if y.device.type == "cpu":
        res = affine_relu_plain(y, s, t)
        return res if out is None else out.copy_(res)
    _check("affine_relu", y, s, t, out)
    if out is None:
        out = torch.empty_like(y)
    elif out.shape != y.shape:
        raise ValueError(f"affine_relu: out {tuple(out.shape)} is not y's "
                         f"{tuple(y.shape)}")
    if y.numel():
        b, h, w, c = y.shape
        LIB.launch(f"affine_relu_{_SUFFIX[y.dtype]}", affine_relu, y,
                   (y.data_ptr(), out.data_ptr(), s.data_ptr(), t.data_ptr(),
                    b, h * w, c), stream)
    return out


@_ffi.counted("affine_squeeze")
def affine_squeeze(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor, *,
                   stream: Optional[int] = None) -> torch.Tensor:
    """[B, C] in y's dtype: the mean over H and W of ``s y + t``, summed
    in fp32."""
    if y.device.type == "cpu":
        return affine_squeeze_plain(y, s, t)
    _check("affine_squeeze", y, s, t)
    b, h, w, c = y.shape
    out = torch.empty((b, c), dtype=y.dtype, device=y.device)
    if y.numel():
        LIB.launch(f"affine_squeeze_{_SUFFIX[y.dtype]}", affine_squeeze, y,
                   (y.data_ptr(), out.data_ptr(), s.data_ptr(), t.data_ptr(),
                    b, h * w, c), stream)
    return out


@_ffi.counted("affine_gate_add_relu")
def affine_gate_add_relu(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                         residual: torch.Tensor, *,
                         gate: Optional[torch.Tensor] = None,
                         residual_affine: Optional[tuple] = None,
                         out: Optional[torch.Tensor] = None,
                         stream: Optional[int] = None) -> torch.Tensor:
    """``relu((s y + t) gate + r)`` over NHWC ``y``: ``r`` is ``residual``
    as it is, or ``rs residual + rt`` with ``residual_affine=(rs, rt)``;
    ``gate`` [B, C] or None (no gate). Into ``out`` (``y`` or
    ``residual`` for in place) or a new tensor."""
    if y.device.type == "cpu":
        res = affine_gate_add_relu_plain(y, s, t, residual, gate,
                                         residual_affine)
        return res if out is None else out.copy_(res)
    rs, rt = residual_affine if residual_affine is not None else (None, None)
    _check("affine_gate_add_relu", y, s, t, residual, gate, out)
    if rs is not None:
        _check("affine_gate_add_relu", residual, rs, rt)
    b, h, w, c = y.shape
    if (residual.shape != y.shape or (out is not None and out.shape != y.shape)
            or (gate is not None and gate.shape != (b, c))):
        raise ValueError(f"affine_gate_add_relu: y {tuple(y.shape)}, residual "
                         f"{tuple(residual.shape)}, gate "
                         f"{None if gate is None else tuple(gate.shape)}")
    if out is None:
        out = torch.empty_like(y)
    if y.numel():
        LIB.launch(f"affine_gate_add_relu_{_SUFFIX[y.dtype]}",
                   affine_gate_add_relu, y, (
                       y.data_ptr(), s.data_ptr(), t.data_ptr(),
                       None if gate is None else gate.data_ptr(),
                       residual.data_ptr(),
                       None if rs is None else rs.data_ptr(),
                       None if rt is None else rt.data_ptr(), out.data_ptr(),
                       b, h * w, c), stream)
    return out


@_ffi.counted("affine_relu_pool2x2")
def affine_relu_pool2x2(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor, *,
                        stream: Optional[int] = None) -> torch.Tensor:
    """[B, H // 2, W // 2, C] in y's dtype: the 2x2/2 max pool of
    ``relu(s y + t)`` over NHWC ``y``, into a new tensor."""
    if y.dim() != 4 or y.shape[1] < 2 or y.shape[2] < 2:
        raise ValueError(f"affine_relu_pool2x2 expects NHWC [B, H, W, C] with "
                         f"H and W of 2 or more, got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return affine_relu_pool2x2_plain(y, s, t)
    _check("affine_relu_pool2x2", y, s, t)
    b, h, w, c = y.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    if y.numel():
        LIB.launch(f"affine_relu_pool2x2_{_SUFFIX[y.dtype]}",
                   affine_relu_pool2x2, y,
                   (y.data_ptr(), out.data_ptr(), s.data_ptr(), t.data_ptr(),
                    b, h, w, c), stream)
    return out
