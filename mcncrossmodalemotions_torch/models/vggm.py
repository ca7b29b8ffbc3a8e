"""VGG-M ("VGGVox"-style) speech student, PyTorch.

Port of ``mcncrossmodalemotions_tpu/models/vggm.py`` (``VGGMStudent``),
eval and train mode. Same parameters (through ``zoo/bridge.py``) and the
same function:

- input [B, 512, T, 1] (the JAX NHWC layout at the public function);
  inside, activations are NCHW-shaped tensors in ``channels_last`` memory,
  so pool1/pool2 hand the kernel a contiguous NHWC view without a copy;
- conv1 7x7/2 (the JAX ``SpaceToDepthConv1`` is a TPU layout trick with
  the same parameters and the same result; here conv1 is a plain conv);
- BatchNorm (eps 1e-5), then ReLU, after every conv; with
  ``use_batchnorm=False`` the convs carry biases instead;
- pool1 and pool2 are 3x3/2 VALID max pools through the K2 kernels
  (``ops/pool.py``): the index-free forward without grad, the with-index
  forward and its backward kernel under grad; pool5 is 5x3/(3,2), a plain
  ``F.max_pool2d``, as the JAX model left it to XLA;
- dropout after pool5 and after fc7 (train mode, ``dropout_rate > 0``);
- fc6 is a 9x1 conv collapsing frequency, then a masked temporal mean over
  the valid columns (``temporal_valid_frames``), fc7 + ReLU (the
  embedding, taken before dropout), and the head.

Compute runs in ``dtype`` (bf16 by default) with fp32 parameters; pool6
and the head run in fp32, as in the JAX module.

Train-mode BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9)``, not
``nn.BatchNorm2d``'s: statistics in fp32 whatever the input dtype, the
variance in the biased fast form E[x^2] - E[x]^2 clipped at 0, over the
rows where ``pad_mask > 0`` only; the running update is
``0.9 * running + 0.1 * batch`` with that BIASED variance
(``nn.BatchNorm2d`` would use momentum 0.1 on the unbiased one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mcncrossmodalemotions_torch.ops.pool import (
    max_pool_3x3s2,
    max_pool_3x3s2_cuda,
    max_pool_3x3s2_train,
)

BN_EPS = 1e-5  # flax.linen.BatchNorm default
BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch
# stddev of a unit normal truncated to [-2, 2]: lecun_normal divides by it
# so that the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


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


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flax train-mode BatchNorm over NCHW ``x``: normalise with the batch
    statistics of the rows where ``pad_mask > 0`` (all rows without a
    mask) and update ``bn``'s running statistics in place. The result is
    in ``x``'s dtype; statistics and affine run in fp32 (fp64 for an fp64
    ``x``: Flax promotes to at least fp32)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if pad_mask is None:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = xf.square().mean(dim=(0, 2, 3))
    else:
        w = (pad_mask > 0).float()[:, None]
        count = w.sum() * (x.shape[2] * x.shape[3])
        mean = (xf.sum(dim=(2, 3)) * w).sum(dim=0) / count
        mean2 = (xf.square().sum(dim=(2, 3)) * w).sum(dim=0) / count
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    with torch.no_grad():  # running statistics: in place, outside autograd
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate); the draws come from ``generator`` (required)."""
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit torch.Generator")
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    mask.bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class VGGMStudent(nn.Module):
    """VGG-M audio emotion student.

    Input: spectrogram [B, 512, T, 1] (freq-major, instance-normalised).
    Output: logits [B, num_outputs], plus the fc7 embedding with
    ``return_embedding``. Built with Flax's scratch init
    (``reset_parameters``).
    """

    def __init__(self, num_outputs: int = 8, fc6_features: int = 4096,
                 fc7_features: int = 1024, dropout_rate: float = 0.0,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.bfloat16,
                 head_init_scale: float = 1e-4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.use_batchnorm = use_batchnorm
        self.head_init_scale = head_init_scale
        bias = not use_batchnorm
        self.conv1 = nn.Conv2d(1, 96, 7, stride=2, bias=bias)
        self.conv2 = nn.Conv2d(96, 256, 5, stride=2, bias=bias)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1, bias=bias)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1, bias=bias)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1, bias=bias)
        self.fc6 = nn.Conv2d(256, fc6_features, (9, 1), bias=bias)
        if use_batchnorm:
            for i, feats in enumerate((96, 256, 384, 256, 256, fc6_features), 1):
                setattr(self, f"bn{i}", nn.BatchNorm2d(feats, eps=BN_EPS))
        self.fc7 = nn.Linear(fc6_features, fc7_features)
        self.prediction = nn.Linear(fc7_features, num_outputs)
        self.reset_parameters(generator)

    def convs(self):
        """(name, conv) in network order."""
        return [(n, getattr(self, n))
                for n in ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6")]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's scratch init, in place: ``lecun_normal`` (a normal
        truncated at 2 std, variance 1/fan_in) for conv and fc7 kernels,
        ``normal(head_init_scale)`` for the head, zero biases, BatchNorm
        scale 1, bias 0, running mean 0, running variance 1."""
        for layer in [conv for _, conv in self.convs()] + [self.fc7]:
            fan_in = int(np.prod(layer.weight.shape[1:]))
            std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
        self.prediction.weight.normal_(0.0, self.head_init_scale,
                                       generator=generator)
        self.prediction.bias.zero_()
        if self.use_batchnorm:
            for i in range(1, 7):
                getattr(self, f"bn{i}").reset_parameters()

    def _conv_bn_relu(self, x: torch.Tensor, i: int, name: str, train: bool,
                      bn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        conv = getattr(self, name)
        bias = None if conv.bias is None else conv.bias.to(self.dtype)
        x = F.conv2d(x, conv.weight.to(self.dtype), bias, conv.stride,
                     conv.padding)
        if self.use_batchnorm:
            bn = getattr(self, f"bn{i}")
            if train:
                x = batch_norm_train(x, bn, bn_mask)
            else:
                # mixed-precision eval BN: statistics and affine in fp32,
                # result in the compute dtype (flax BatchNorm(dtype=bf16)
                # does the same)
                x = F.batch_norm(x, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x, inplace=True)

    @staticmethod
    def _pool_3x3s2(x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        if not use_kernels:
            pool = max_pool_3x3s2
        elif torch.is_grad_enabled() and nhwc.requires_grad:
            pool = max_pool_3x3s2_train
        else:
            pool = max_pool_3x3s2_cuda
        return pool(nhwc).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                valid_frames: Optional[torch.Tensor] = None,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None):
        """``train`` uses batch statistics (over the rows where
        ``pad_mask > 0``) and updates the running ones, and applies
        dropout drawn from ``generator``. ``use_kernels`` sends pool1/pool2
        through the K2 wrappers (kernels on the card, plain on the CPU);
        False runs the plain pool."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # [B, 1, F, T]
        x = x.contiguous(memory_format=torch.channels_last)
        drop = train and self.dropout_rate > 0
        bn = dict(train=train, bn_mask=pad_mask)
        x = self._conv_bn_relu(x, 1, "conv1", **bn)
        x = self._pool_3x3s2(x, use_kernels)
        x = self._conv_bn_relu(x, 2, "conv2", **bn)
        x = self._pool_3x3s2(x, use_kernels)
        x = self._conv_bn_relu(x, 3, "conv3", **bn)
        x = self._conv_bn_relu(x, 4, "conv4", **bn)
        x = self._conv_bn_relu(x, 5, "conv5", **bn)
        x = F.max_pool2d(x, (5, 3), stride=(3, 2))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        x = self._conv_bn_relu(x, 6, "fc6", **bn)  # [B, C, 1, T']

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
        embedding = x.float()  # before dropout, as in the JAX module
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        head = self.prediction  # fp32 whatever the parameters' dtype
        logits = F.linear(x.float(), head.weight.float(), head.bias.float())
        if return_embedding:
            return logits, embedding
        return logits
