"""K2: the 3x3 stride-2 max-pool kernel (``csrc/max_pool_3x3s2.cu``).

Replaces the forward of the TPU kernel
``mcncrossmodalemotions_tpu/ops/pallas_pool.py`` (``max_pool_3x3s2`` ->
``_pool_fwd_pallas``). The layout stays the JAX one, NHWC, at the public
functions; the student keeps its activations ``channels_last``, so that
``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view and costs no copy.
The source note in ``csrc/max_pool_3x3s2.cu`` says what bounds the kernel
on the card and what its design does about that.

Only the forward is ported: the slice is inference. The backward (XLA's
SelectAndScatterAdd with its one-winner tie rule) comes with training.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mcncrossmodalemotions_torch.ops import _build

WINDOW = 3
STRIDE = 2

_KERNELS = {torch.float32: "max_pool_3x3s2_f32",
            torch.bfloat16: "max_pool_3x3s2_bf16"}


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, H, W, C] -> [B, (H-3)//2+1, (W-3)//2+1, C]."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), WINDOW, STRIDE)
    return y.permute(0, 2, 3, 1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("max_pool_3x3s2")
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
    return lib


def max_pool_3x3s2_cuda(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 VALID max pool over NHWC, bf16 or fp32.

    A CPU tensor goes through the plain version. A CUDA tensor must be a
    contiguous NHWC bf16/fp32 tensor with H, W >= 3 and goes through the
    kernel; each launch adds one to ``max_pool_3x3s2_cuda.launches``.
    """
    if x.device.type == "cpu":
        return max_pool_3x3s2(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_3x3s2_cuda: unsupported device {x.device}")
    if x.dtype not in _KERNELS:
        raise TypeError(f"max_pool_3x3s2_cuda: unsupported dtype {x.dtype}")
    if x.dim() != 4 or x.shape[1] < WINDOW or x.shape[2] < WINDOW:
        raise ValueError(f"max_pool_3x3s2_cuda expects [B, H>=3, W>=3, C], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("max_pool_3x3s2_cuda expects a contiguous NHWC tensor")
    bsz, h, w, c = x.shape
    out = torch.empty((bsz, (h - WINDOW) // STRIDE + 1,
                       (w - WINDOW) // STRIDE + 1, c),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_lib(), _KERNELS[x.dtype])(
            x.data_ptr(), out.data_ptr(), bsz, h, w, c,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max-pool kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, {x.dtype})")
    max_pool_3x3s2_cuda.launches += 1
    return out


max_pool_3x3s2_cuda.launches = 0
