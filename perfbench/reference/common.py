"""Weights from the seed, exact float32 settings and the float8 control."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], str, int]
"""(name, shape, init, fan_in) of one parameter or running statistic."""


@contextlib.contextmanager
def exact_fp32():
    """Float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_weights(leaves: List[Leaf], seed: int, device,
                 stem_var: float = 1.0) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` from one normal draw of a generator
    there seeded ``seed``: kernels z / sqrt(fan_in), biases 0.1 z,
    BatchNorm scale 1 + 0.1 z and shift 0.1 z, running mean 0.1 z,
    running variance exp(0.2 z) (times ``stem_var`` for ``stem_var``
    leaves)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init, fan_in in leaves:
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        if init == "kernel":
            v = v / math.sqrt(fan_in)
        elif init in ("bias", "bn_shift", "running_mean"):
            v = 0.1 * v
        elif init == "bn_scale":
            v = 1.0 + 0.1 * v
        elif init == "running_var":
            v = torch.exp(0.2 * v)
        elif init == "stem_var":
            v = stem_var * torch.exp(0.2 * v)
        else:
            raise ValueError(f"unknown init {init!r}")
        out[name] = v.clone()
    return out


def fake_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to float8 (e4m3 by default, e5m2 for gradients) with
    one scale (its largest magnitude to the format's largest), back in
    t's dtype."""
    top = torch.finfo(dtype).max
    scale = top / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Conv(torch.autograd.Function):
    """A convolution in float8 both ways: e4m3 input, weight and result
    forward (as the program keeps its bf16 convolutions' results in bf16),
    e5m2 output gradient backward."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = fake_fp8(x), fake_fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding)
        return fake_fp8(F.conv2d(qx, qw, None, stride, padding))

    @staticmethod
    def backward(ctx, go):
        qx, qw = ctx.saved_tensors
        stride, padding = ctx.conf
        qgo = fake_fp8(go, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qgo, stride, padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qgo, stride, padding)
        return gx, gw, None, None


class _Fp8Linear(torch.autograd.Function):
    """``_Fp8Conv``'s rule for a matrix product; the bias is added in
    float32."""

    @staticmethod
    def forward(ctx, x, w):
        qx, qw = fake_fp8(x), fake_fp8(w)
        ctx.save_for_backward(qx, qw)
        return fake_fp8(qx @ qw.t())

    @staticmethod
    def backward(ctx, go):
        qx, qw = ctx.saved_tensors
        qgo = fake_fp8(go, torch.float8_e5m2)
        return qgo @ qw, qgo.t() @ qx


def _round(t: torch.Tensor, fmt: str, grad: bool = False) -> torch.Tensor:
    """``t`` rounded to ``fmt`` (``fp8``: e4m3, or e5m2 for a gradient;
    ``bf16``) and back."""
    if fmt == "bf16":
        return t.bfloat16().to(t.dtype)
    return fake_fp8(t, torch.float8_e5m2 if grad else torch.float8_e4m3fn)


class _Store(torch.autograd.Function):
    """An activation kept in ``fmt``: rounded forward, its gradient rounded
    backward."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt, grad=True), None


class Ops:
    """Convolution, linear and activations kept between operations, in
    the reference's precision: ``fp32`` as they are; ``fp8`` (the
    control) from float8 operands and results in the forward and float8
    gradients in the backward (``_Fp8Conv``, ``_Fp8Linear``,
    ``_Store``), as the program computes in bf16; ``bf16`` the same in
    bfloat16, a witness of what the program's precision alone moves,
    never a limit's reading."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def conv(self, x, w, stride=1, padding=0):
        if self.precision == "fp8":
            return _Fp8Conv.apply(x, w, stride, padding)
        if self.precision == "bf16":
            return F.conv2d(x.bfloat16(), w.bfloat16(), None, stride, padding).float()
        return F.conv2d(x, w, None, stride, padding)

    def store(self, x):
        """An activation as the program keeps it between operations: in
        its compute dtype (bf16, for the control fp8), float32 here."""
        return x if self.precision == "fp32" else _Store.apply(x, self.precision)

    def linear(self, x, w, b=None):
        if self.precision == "fp8":
            y = _Fp8Linear.apply(x, w)
            return y if b is None else y + b
        if self.precision == "bf16":
            y = F.linear(x.bfloat16(), w.bfloat16()).float()
            return y if b is None else y + b
        return F.linear(x, w, b)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
               train: bool, eps: float) -> torch.Tensor:
    """BatchNorm over NCHW: the batch's mean and biased variance in train
    mode, the running statistics in eval mode."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    inv = torch.rsqrt(var + eps) * p[f"{name}.weight"]
    return (x - mean[:, None, None]) * inv[:, None, None] + p[f"{name}.bias"][:, None, None]


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: frozenset = frozenset()) -> Dict[str, float]:
    """|prog - ref| / max(ref, median ref) of each leaf's norm, the leaves
    in ``skip`` left out."""
    med = float(np.median(list(ref.values())))
    return {n: abs(prog[n] - r) / max(r, med) for n, r in ref.items() if n not in skip}


def negligible_leaves(ref_grads: Dict[str, float], floor: float = 1e-3) -> frozenset:
    """Leaves whose reference gradient is under ``floor`` x the median
    leaf's: they move by round-off alone, so neither their gradient nor
    their change is compared."""
    med = float(np.median(list(ref_grads.values())))
    return frozenset(n for n, r in ref_grads.items() if r < floor * med)
