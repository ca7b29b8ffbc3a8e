"""The face teachers' eval-mode BatchNorm epilogues
(``csrc/teacher_epilogue.cu``).

Replace no TPU kernel: the JAX package leaves eval BatchNorm, ReLU and
the squeeze-excitation and residual elementwise work to XLA. In the port's
eval forward without autograd (``models/resnet.ResNet.fused_forward``) each
BatchNorm is a per-channel affine ``s y + t`` on the raw bf16 conv output,
``s = gamma * rsqrt(running_var + eps)`` and ``t = beta - running_mean *
s`` in fp32 (``bn_affine``), applied inside one of three kernels:

- ``affine_relu``: ``relu(s y + t)``, in place with ``out=y``;
- ``affine_squeeze``: the SE squeeze ``mean_hw(s y + t)`` summed in fp32,
  [B, C] in y's dtype (the one rounding the SE MLP's input takes);
- ``affine_gate_add_relu``: ``relu((s y + t) gate + r)``, ``r`` the block
  input or ``rs yd + rt`` of the raw projection conv output
  (``residual_affine=(rs, rt)``), ``gate`` [B, C] or None.

Every tensor is NHWC [B, H, W, C]: the teachers keep their activations in
``channels_last`` memory, so ``y.permute(0, 2, 3, 1)`` of a conv output is
a contiguous NHWC view and costs no copy. Each wrapper runs its plain
PyTorch version for a CPU tensor and its kernel for a CUDA one, raising on
a CUDA tensor the kernel does not take (not contiguous NHWC, not
bf16/fp32, mismatched shapes or dtypes, C not a whole number of 16-byte
vectors, data not 16-byte aligned): there is no narrower path. Each
launch adds one to the wrapper's ``.launches``.

The host's path a launch is short, since a forward makes 65 of them: the
library's functions and argument types are bound once, and a caller that
passes ``stream`` (``torch.cuda.current_stream().cuda_stream``, read once
a forward) with the tensors' device current skips the device guard and
the stream lookup.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from mcncrossmodalemotions_torch.ops import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: Dict[str, object] = {}  # name -> the library's function


def _fn(name: str):
    """The library's function ``name``, its argument types set once."""
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("teacher_epilogue")
        ptr, cint = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            for base, argtypes in (
                    ("affine_relu", [ptr] * 4 + [cint] * 3 + [ptr]),
                    ("affine_squeeze", [ptr] * 4 + [cint] * 3 + [ptr]),
                    ("affine_gate_add_relu", [ptr] * 8 + [cint] * 3 + [ptr])):
                f = getattr(lib, f"{base}_{sfx}")
                f.restype, f.argtypes = cint, argtypes
                _fns[f"{base}_{sfx}"] = f
        fn = _fns[name]
    return fn


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


# -- the kernels ----------------------------------------------------------

def _check(who: str, y: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
           *others: Optional[torch.Tensor]) -> None:
    """Raise on what the kernels do not take: each lane reads and writes
    16 bytes, so C must be a whole number of 16-byte vectors and each
    tensor's data 16-byte aligned. ``others`` are tensors of y's dtype and
    device (the shapes are the caller's to check)."""
    if y.dtype not in _SUFFIX:
        raise TypeError(f"{who}: unsupported dtype {y.dtype}")
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"{who} expects a contiguous NHWC [B, H, W, C] "
                         f"tensor, got {tuple(y.shape)} with strides "
                         f"{y.stride()}")
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
    if c * y.element_size() % 16:
        raise ValueError(f"{who}: C = {c} in {y.dtype} is not a whole number "
                         f"of 16-byte vectors")
    for v in (y, *others):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"{who}: a tensor's data is not 16-byte aligned")


def _launch(name: str, y: torch.Tensor, args, stream: Optional[int]) -> None:
    fn = _fn(f"{name}_{_SUFFIX[y.dtype]}")
    if stream is None:
        with torch.cuda.device(y.device):
            err = fn(*args, torch.cuda.current_stream(y.device).cuda_stream)
    else:
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(shape {tuple(y.shape)}, {y.dtype})")


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
        _launch("affine_relu", y, (y.data_ptr(), out.data_ptr(), s.data_ptr(),
                                   t.data_ptr(), b, h * w, c), stream)
        affine_relu.launches += 1
    return out


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
        _launch("affine_squeeze", y, (y.data_ptr(), out.data_ptr(),
                                      s.data_ptr(), t.data_ptr(), b, h * w, c),
                stream)
        affine_squeeze.launches += 1
    return out


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
        _launch("affine_gate_add_relu", y, (
            y.data_ptr(), s.data_ptr(), t.data_ptr(),
            None if gate is None else gate.data_ptr(), residual.data_ptr(),
            None if rs is None else rs.data_ptr(),
            None if rt is None else rt.data_ptr(), out.data_ptr(), b, h * w,
            c), stream)
        affine_gate_add_relu.launches += 1
    return out


affine_relu.launches = 0
affine_squeeze.launches = 0
affine_gate_add_relu.launches = 0
