"""VGG-M ("VGGVox"-style) speech student, eval mode, PyTorch.

Port of ``mcncrossmodalemotions_tpu/models/vggm.py`` (``VGGMStudent``),
forward only. Same parameters (through ``zoo/bridge.py``) and the same
function:

- input [B, 512, T, 1] (the JAX NHWC layout at the public function);
  inside, activations are NCHW-shaped tensors in ``channels_last`` memory,
  so pool1/pool2 hand the kernel a contiguous NHWC view without a copy;
- conv1 7x7/2 (the JAX ``SpaceToDepthConv1`` is a TPU layout trick with
  the same parameters and the same result; here conv1 is a plain conv);
- BatchNorm on running statistics (eps 1e-5), then ReLU, after every conv;
- pool1 and pool2 are 3x3/2 VALID max pools through the K2 kernel
  (``ops/pool.max_pool_3x3s2_cuda``); pool5 is 5x3/(3,2), a plain
  ``F.max_pool2d``, as the JAX model left it to XLA;
- fc6 is a 9x1 conv collapsing frequency, then a masked temporal mean over
  the valid columns (``temporal_valid_frames``), fc7 + ReLU, and the head.

Compute runs in ``dtype`` (bf16 by default) with fp32 parameters; pool6
and the head run in fp32, as in the JAX module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mcncrossmodalemotions_torch.ops.pool import (
    max_pool_3x3s2,
    max_pool_3x3s2_cuda,
)

BN_EPS = 1e-5  # flax.linen.BatchNorm default


def _floor_out(size, kernel, stride):
    """VALID conv/pool output size; works on ints and integer tensors."""
    return (size - kernel) // stride + 1


def temporal_valid_frames(w):
    """Valid input spectrogram frames -> valid columns at the fc6 output.

    conv1 s2, mpool1 3/2, conv2 s2, mpool2 3/2, (conv3-5 SAME), mpool5 3/2
    in time: 400 frames -> 11, the reference's ``pool6=[1 11]``.
    """
    w = _floor_out(w, 7, 2)   # conv1
    w = _floor_out(w, 3, 2)   # mpool1
    w = _floor_out(w, 5, 2)   # conv2
    w = _floor_out(w, 3, 2)   # mpool2
    w = _floor_out(w, 3, 2)   # mpool5 (time stride 2)
    return w


class VGGMStudent(nn.Module):
    """VGG-M audio emotion student (eval-mode forward).

    Input: spectrogram [B, 512, T, 1] (freq-major, instance-normalised).
    Output: logits [B, num_outputs], plus the fc7 embedding with
    ``return_embedding``.
    """

    def __init__(self, num_outputs: int = 8, fc6_features: int = 4096,
                 fc7_features: int = 1024, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 96, 7, stride=2, bias=False)
        self.conv2 = nn.Conv2d(96, 256, 5, stride=2, bias=False)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1, bias=False)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1, bias=False)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        self.fc6 = nn.Conv2d(256, fc6_features, (9, 1), bias=False)
        for i, feats in enumerate((96, 256, 384, 256, 256, fc6_features), 1):
            setattr(self, f"bn{i}", nn.BatchNorm2d(feats, eps=BN_EPS))
        self.fc7 = nn.Linear(fc6_features, fc7_features)
        self.prediction = nn.Linear(fc7_features, num_outputs)

    def _conv_bn_relu(self, x: torch.Tensor, i: int, name: str = "") -> torch.Tensor:
        conv = getattr(self, name or f"conv{i}")
        bn = getattr(self, f"bn{i}")
        x = F.conv2d(x, conv.weight.to(self.dtype), None, conv.stride,
                     conv.padding)
        # mixed-precision eval BN: statistics and affine in fp32, result
        # in the compute dtype (flax BatchNorm(dtype=bf16) does the same)
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.relu(x, inplace=True)

    @staticmethod
    def _pool_3x3s2(x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        pool = max_pool_3x3s2_cuda if use_kernels else max_pool_3x3s2
        return pool(nhwc).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, valid_frames: Optional[torch.Tensor] = None,
                return_embedding: bool = False, use_kernels: bool = True):
        """``use_kernels`` sends pool1/pool2 through the K2 wrapper (kernel
        on the card, plain on the CPU); False runs the plain pool."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # [B, 1, F, T]
        x = x.contiguous(memory_format=torch.channels_last)
        x = self._conv_bn_relu(x, 1)
        x = self._pool_3x3s2(x, use_kernels)
        x = self._conv_bn_relu(x, 2)
        x = self._pool_3x3s2(x, use_kernels)
        x = self._conv_bn_relu(x, 3)
        x = self._conv_bn_relu(x, 4)
        x = self._conv_bn_relu(x, 5)
        x = F.max_pool2d(x, (5, 3), stride=(3, 2))
        x = self._conv_bn_relu(x, 6, "fc6")  # [B, C, 1, T']

        # pool6: masked temporal mean (replaces per-bucket poolSize surgery)
        x = x.float()[:, :, 0, :]  # [B, C, T']
        t_out = x.shape[-1]
        if valid_frames is None:
            x = x.mean(dim=-1)
        else:
            valid = temporal_valid_frames(
                torch.as_tensor(valid_frames, device=x.device))
            valid = valid.clamp(1, t_out)
            mask = (torch.arange(t_out, device=x.device)[None, :]
                    < valid[:, None]).to(x.dtype)
            x = (x * mask[:, None, :]).sum(dim=-1) / valid[:, None].to(x.dtype)

        x = F.linear(x.to(self.dtype), self.fc7.weight.to(self.dtype),
                     self.fc7.bias.to(self.dtype))
        x = F.relu(x)
        embedding = x.float()
        logits = self.prediction(embedding)
        if return_embedding:
            return logits, embedding
        return logits
