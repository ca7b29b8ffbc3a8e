"""ResNet-50 / SE-ResNet-50 facial-emotion teachers, PyTorch.

Port of ``mcncrossmodalemotions_tpu/models/resnet.py`` (``SEBlock``,
``Bottleneck``, ``ResNet``, ``ResNet50``, ``SENet50``): the architectures of
the released ``resnet50-ferplus`` and ``senet50-ferplus`` teachers
(ferPlusZoo.m:37-92). Same parameters (through ``zoo/bridge.py``, Flax
module names as ``state_dict`` keys) and the same function, op for op:

- input [B, H, W, 3] (the JAX NHWC layout at the public function); inside,
  NCHW-shaped tensors in ``channels_last`` memory for cuDNN;
- conv1 7x7/2 (pad 3), BatchNorm, ReLU, then the Caffe pad-(0,1) stem pool:
  3x3/2 windows from row and column 0 with one padded row and column at
  the bottom and right for the final window, which is
  ``F.max_pool2d(3, 2, padding=0, ceil_mode=True)`` (held equal to the
  padded VALID pool at even and odd sizes by the tests). It is a plain
  pool: the reference pools the stem in XLA, not through the Pallas K2;
- bottlenecks 1x1 -> 3x3 -> 1x1 (expansion 4) with the downsampling stride
  on the FIRST 1x1 (the released Caffe-descended weights), not on the 3x3
  as in torchvision's v1.5; the projection shortcut (1x1 conv + BN) runs
  wherever the block's channels or stride change;
- squeeze-excitation: the squeeze a mean in fp32, fc1 -> ReLU -> fc2 in the
  compute dtype, the sigmoid in fp32 cast back to the compute dtype;
- the global pool a mean in fp32, the single dropout on the pooled
  embedding (train mode, drawn from the caller's ``torch.Generator``: the
  reference's two spatial dropouts inside the last bottleneck are a
  recorded deviation of the JAX package, PARITY.md, copied as it is), the
  head an fp32 ``Linear``.

Compute runs in ``dtype`` (bf16 by default, fp32 for the tests) with fp32
parameters. Eval-mode BatchNorm reads the running statistics (not folded
into the convs): ``F.batch_norm`` computes ``(x - mean) * rsqrt(var + eps)
* scale + bias`` in fp32 and casts to the compute dtype, as Flax does.
Train mode (FER+ fine-tuning) normalises with the batch statistics of the
rows where ``pad_mask > 0`` and moves the running ones by Flax's rule
(``models/vggm.batch_norm_train``: fp32 statistics, the biased variance,
momentum 0.9), not ``F.batch_norm(training=True)``, whose running variance
is the unbiased one. ``reset_parameters`` is Flax's scratch init.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mcncrossmodalemotions_torch.models.vggm import (
    batch_norm_train,
    dropout,
    lecun_normal_,
)
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh

STAGE_SIZES = {50: (3, 4, 6, 3)}
BN_EPS = 1e-5


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False,
        bn_mask: Optional[torch.Tensor] = None,
        mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Flax BatchNorm: the batch statistics in train mode (over the rows
    where ``bn_mask > 0``, the global batch's under ``mesh``, running
    statistics updated in place), the running ones in eval mode."""
    if train:
        return batch_norm_train(x, bn, bn_mask, mesh=mesh)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """Caffe pad-(0,1) 3x3/2 max pool (the released teachers' geometry)."""
    return F.max_pool2d(x, 3, 2, padding=0, ceil_mode=True)


class SEBlock(nn.Module):
    """Squeeze-and-excitation: global mean -> fc1 (1/16) -> ReLU -> fc2 ->
    sigmoid gate."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(features, features // reduction)
        self.fc2 = nn.Linear(features // reduction, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        squeezed = x.mean(dim=(2, 3), dtype=torch.float32)
        hidden = F.relu(F.linear(squeezed.to(dt), self.fc1.weight.to(dt),
                                 self.fc1.bias.to(dt)))
        gate = F.linear(hidden, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        gate = torch.sigmoid(gate.float()).to(dt)
        return x * gate[:, :, None, None]


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck (1x1 -> 3x3 -> 1x1, expansion 4), optional SE;
    ``downsample`` is the projection shortcut, present where the channels
    or the stride change."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 use_se: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_features, features, 1, strides, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPS)
        self.se = SEBlock(out) if use_se else None
        self.project = in_features != out or strides != 1
        if self.project:
            self.downsample = nn.Conv2d(in_features, out, 1, strides,
                                        bias=False)
            self.bn_down = nn.BatchNorm2d(out, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_mask: Optional[torch.Tensor] = None,
                mesh: Optional[DataMesh] = None) -> torch.Tensor:
        bn = dict(train=train, bn_mask=bn_mask, mesh=mesh)
        y = F.relu(_bn(_conv(x, self.conv1), self.bn1, **bn))
        y = F.relu(_bn(_conv(y, self.conv2), self.bn2, **bn))
        y = _bn(_conv(y, self.conv3), self.bn3, **bn)
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.project:
            residual = _bn(_conv(x, self.downsample), self.bn_down, **bn)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-v1 with optional SE blocks; 8-way emotion head by default
    (``num_outputs=10`` for the reference's 'full' FER+ class set).
    ``stage_sizes`` overrides the depth's for tiny test configs."""

    def __init__(self, num_outputs: int = 8, depth: int = 50,
                 stage_sizes: Optional[Sequence[int]] = None,
                 use_se: bool = False, width: int = 64,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 head_init_scale: float = 0.01):
        super().__init__()
        self.num_outputs = num_outputs
        self.head_init_scale = head_init_scale  # ferPlusZoo.m head re-init
        self.stage_sizes = tuple(stage_sizes or STAGE_SIZES[depth])
        self.use_se = use_se
        self.width = width
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.blocks = []
        in_features = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                features = width * 2 ** stage
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(
                    in_features, features,
                    strides=2 if stage > 0 and block == 0 else 1,
                    use_se=use_se))
                self.blocks.append(name)
                in_features = features * 4
        self.prediction = nn.Linear(in_features, num_outputs)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's scratch init, in place: ``lecun_normal`` conv and SE
        kernels, zero biases, BatchNorm scale 1, bias 0, running mean 0,
        variance 1, the head ``normal(head_init_scale)``."""
        for name, module in self.named_modules():
            if isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, (nn.Conv2d, nn.Linear)):
                if name == "prediction":
                    module.weight.normal_(0.0, self.head_init_scale,
                                          generator=generator)
                else:
                    lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[DataMesh] = None):
        """[B, H, W, 3] -> logits [B, num_outputs] fp32, and the pooled
        embedding (before dropout) with ``return_embedding``. ``train``
        uses the batch statistics of the rows where ``pad_mask > 0`` and
        updates the running ones, and draws the dropout from
        ``generator``; under ``mesh`` both are the global batch's. The
        weights come from ``load_state_dict`` (the bridge, a release) or
        ``reset_parameters``."""
        bn = dict(train=train, bn_mask=pad_mask, mesh=mesh)
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
        x = F.relu(_bn(_conv(x, self.conv1), self.bn1, **bn))
        x = stem_pool(x)
        for name in self.blocks:
            x = getattr(self, name)(x, **bn)
        x = x.mean(dim=(2, 3), dtype=torch.float32)  # global pool
        embedding = x
        if train and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator, mesh)
        logits = F.linear(x, self.prediction.weight.float(),
                          self.prediction.bias.float())
        if return_embedding:
            return logits, embedding
        return logits


def ResNet50(**kw) -> ResNet:
    """resnet50-ferplus equivalent."""
    return ResNet(depth=50, use_se=False, **kw)


def SENet50(**kw) -> ResNet:
    """senet50-ferplus equivalent (SE-ResNet-50)."""
    return ResNet(depth=50, use_se=True, **kw)
