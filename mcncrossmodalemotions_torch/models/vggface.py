"""Classic VGG face teachers (VGG-M and VGG-Very-Deep-16), PyTorch.

Port of ``mcncrossmodalemotions_tpu/models/vggface.py`` (``VGGFace``): the
pre-ResNet face models of the reference's teacher zoo
(ferPlusZoo.m:44-59): ``vgg_face`` / ``vgg-vd-face*`` are VGG-VD-16 stacks
and ``vgg-m-face-bn*`` VGG-M stacks. The classics ship without BatchNorm;
``use_batchnorm`` is the reference's ``useBnorm`` retrofit
(ferPlusZoo.m:123, insertBNLayers): BN after every conv, convs bias-free.

Same parameters (through ``zoo/bridge.py``: the Flax module names are the
``state_dict`` keys, ``conv1_1`` / ``bn_conv1_1`` ... ``fc6``, ``bn_fc6``,
``fc7``, ``prediction``) and the same function:

- input [B, S, S, 3] mean-subtracted faces (the JAX NHWC layout at the
  public function), 224 for the released geometry; inside, NCHW-shaped
  tensors in ``channels_last`` memory;
- VD-16: 13 3x3 convs (pad 1) in five blocks, a 2x2/2 max pool after each;
- VGG-M: 7x7/2 conv (no pad), 5x5/2 (pad 1), three 3x3 (pad 1), each pool
  3x3/2 with MatConvNet's [0 1 0 1] pad (a window from row and column 0,
  one padded row and column at the bottom and right for the last window:
  ``models/resnet.stem_pool``), so the released 224 geometry comes out
  109 -> 54 -> 26 -> 13 -> 6 and fc6 is a 6x6 kernel. These are plain
  pools: the reference left them to XLA, not to the Pallas K2 (a VALID
  pool);
- fc6 a conv over the whole remaining extent (``fc6_extent``; PyTorch
  needs the kernel's size up front, so the model takes ``input_size``),
  fc7 a 1x1 conv, BatchNorm + ReLU after each, dropout after each (train
  mode, ``dropout_rate > 0``, drawn from the caller's generator);
- the fc7 features flattened to fp32 (the embedding), the head an fp32
  ``Linear`` with ``normal(head_init_scale)`` scratch init.

Compute runs in ``dtype`` (bf16 by default) with fp32 parameters; train-mode
BatchNorm is Flax's (``models/vggm.batch_norm_train``: masked by
``pad_mask``, fp32 statistics, biased variance, momentum 0.9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mcncrossmodalemotions_torch.models.resnet import _bn, stem_pool
from mcncrossmodalemotions_torch.models.vggm import (
    BN_EPS,
    dropout,
    lecun_normal_,
)
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh

# Per-block 3x3 conv widths of VGG-VD-16 (vgg_face, Parkhi et al.); a
# 2x2/2 max pool after each block.
VD16_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


def _ceil_pool_out(size: int) -> int:
    """3x3/2 pool with one pad at the end: ``(size + 1 - 3) // 2 + 1``."""
    return (size - 2) // 2 + 1


def fc6_extent(arch: str, input_size: int) -> int:
    """Spatial extent of fc6's input (its kernel size) at ``input_size``:
    7 for VD-16 and 6 for VGG-M at 224."""
    s = input_size
    if arch == "vd":
        for _ in VD16_BLOCKS:
            s //= 2
    elif arch == "m":
        s = (s - 7) // 2 + 1                     # conv1 7x7/2
        s = _ceil_pool_out(s)
        s = _ceil_pool_out((s + 2 - 5) // 2 + 1)  # conv2 5x5/2 pad 1, pool
        s = _ceil_pool_out(s)                    # conv3-5 keep the size
    else:
        raise ValueError(f"unknown VGGFace arch {arch!r}")
    if s < 1:
        raise ValueError(f"input {input_size} is too small for VGGFace "
                         f"{arch!r}")
    return s


class VGGFace(nn.Module):
    """VGG-M ('m') or VGG-VD-16 ('vd') face network.

    Input: [B, S, S, 3] with S = ``input_size``. Output: [B, num_outputs]
    logits; ``return_embedding`` also yields the fc7 features.
    ``width_multiplier`` and ``fc_features`` give the tiny test configs.
    """

    def __init__(self, arch: str = "vd", num_outputs: int = 8,
                 use_batchnorm: bool = False, fc_features: int = 4096,
                 width_multiplier: float = 1.0, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 head_init_scale: float = 0.01, input_size: int = 224):
        super().__init__()
        self.arch = arch
        self.num_outputs = num_outputs
        self.use_batchnorm = use_batchnorm
        self.width_multiplier = width_multiplier
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.head_init_scale = head_init_scale
        self.input_size = input_size
        self.layers = []  # (conv name, pool after it: None | "2x2" | "3x3")
        in_ch = 3
        if arch == "vd":
            for b, widths in enumerate(VD16_BLOCKS, start=1):
                for c, width in enumerate(widths, start=1):
                    in_ch = self._add(f"conv{b}_{c}", in_ch, self._w(width), 3,
                                      1, 1)
                    self.layers.append((f"conv{b}_{c}",
                                        "2x2" if c == len(widths) else None))
        elif arch == "m":
            in_ch = self._add("conv1", in_ch, self._w(96), 7, 2, 0)
            self.layers.append(("conv1", "3x3"))
            in_ch = self._add("conv2", in_ch, self._w(256), 5, 2, 1)
            self.layers.append(("conv2", "3x3"))
            for i in (3, 4, 5):
                in_ch = self._add(f"conv{i}", in_ch, self._w(512), 3, 1, 1)
                self.layers.append((f"conv{i}", "3x3" if i == 5 else None))
        else:
            raise ValueError(f"unknown VGGFace arch {arch!r}")
        fc = self._w(fc_features)
        self._add("fc6", in_ch, fc, fc6_extent(arch, input_size), 1, 0)
        self._add("fc7", fc, fc, 1, 1, 0)
        self.prediction = nn.Linear(fc, num_outputs)

    def _w(self, channels: int) -> int:
        return max(8, int(round(channels * self.width_multiplier)))

    def _add(self, name: str, in_ch: int, out_ch: int, kernel: int,
             stride: int, padding: int) -> int:
        self.add_module(name, nn.Conv2d(in_ch, out_ch, kernel, stride,
                                        padding, bias=not self.use_batchnorm))
        if self.use_batchnorm:
            self.add_module(f"bn_{name}", nn.BatchNorm2d(out_ch, eps=BN_EPS))
        return out_ch

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's scratch init, in place: ``lecun_normal`` conv kernels,
        zero biases, BatchNorm scale 1, bias 0, running mean 0, variance
        1, the head ``normal(head_init_scale)`` with a zero bias."""
        for name, module in self.named_children():
            if isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, nn.Conv2d):
                lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
        self.prediction.weight.normal_(0.0, self.head_init_scale,
                                       generator=generator)
        self.prediction.bias.zero_()

    def _conv_bn_relu(self, x: torch.Tensor, name: str, train: bool,
                      bn_mask: Optional[torch.Tensor],
                      mesh: Optional[DataMesh] = None) -> torch.Tensor:
        conv = getattr(self, name)
        bias = None if conv.bias is None else conv.bias.to(self.dtype)
        x = F.conv2d(x, conv.weight.to(self.dtype), bias, conv.stride,
                     conv.padding)
        if self.use_batchnorm:
            x = _bn(x, getattr(self, f"bn_{name}"), train, bn_mask, mesh)
        return F.relu(x)

    def forward(self, x: torch.Tensor, train: bool = False,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[DataMesh] = None):
        """``train`` uses the batch statistics of the rows where
        ``pad_mask > 0``, updates the running ones and draws the dropout
        from ``generator``; under ``mesh`` both are the global batch's."""
        bn = dict(train=train, bn_mask=pad_mask, mesh=mesh)
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
        for name, pool in self.layers:
            x = self._conv_bn_relu(x, name, **bn)
            if pool == "2x2":
                x = F.max_pool2d(x, 2, 2)
            elif pool == "3x3":
                x = stem_pool(x)
        drop = train and self.dropout_rate > 0
        for name in ("fc6", "fc7"):
            x = self._conv_bn_relu(x, name, **bn)
            if drop:
                x = dropout(x, self.dropout_rate, generator, mesh)
        x = x.reshape(x.shape[0], -1).float()  # [B, C, 1, 1] -> [B, C]
        embedding = x
        head = self.prediction
        logits = F.linear(x, head.weight.float(), head.bias.float())
        if return_embedding:
            return logits, embedding
        return logits
