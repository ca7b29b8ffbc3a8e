"""Plain VGG-VD-16 (Simonyan & Zisserman, ICLR 2015, Table 1, config D) as
the VGG-Face teacher (Parkhi et al., BMVC 2015) with the 8-way FER+ head,
from ``configs/vgg16-face-ferplus.json``, with the face pipeline in front
of it: uint8 gray [B, S, S, 1] -> float -> (align-corners bilinear resize
to the input size where it differs) -> three equal channels minus the
mean RGB -> five blocks of 3x3 convs (pad 1) with their biases, a ReLU
after each, a 2x2/2 max pool after each block -> fc6, a conv over the
whole remaining extent (7x7 at 224), and fc7, a 1x1 conv, each with its
bias and a ReLU -> the fc7 features flattened -> the head.

Departures from the papers: the input is a gray face replicated to three
channels (the dense pass's frames); eval has no dropout; the head is
FER+'s 8 classes, not VGG-Face's 2,622 identities; the weights are drawn
from the seed (``leaves``)."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.common import Leaf, Ops, exact_fp32
from perfbench.reference.senet50 import resize_align_corners


def conv_names(cfg: dict) -> List[List[str]]:
    """The port's names of each block's convs: conv1_1, conv1_2, ..."""
    return [[f"conv{b}_{c}" for c in range(1, len(widths) + 1)]
            for b, widths in enumerate(cfg["blocks"], start=1)]


def fc6_extent(cfg: dict) -> int:
    return cfg["input_size"] // cfg["pool"]["stride"] ** len(cfg["blocks"])


def leaves(cfg: dict) -> List[Leaf]:
    """Kernels at variance 2 / fan_in (``make_weights`` divides by the
    square root of the fan-in given: half of it here), conv1_1's also over
    the input's variance; the head at 1 / fan_in; biases 0.1 z."""
    k, cin, out = cfg["conv"]["kernel"], cfg["input_channels"], []
    for names, widths in zip(conv_names(cfg), cfg["blocks"]):
        for name, cout in zip(names, widths):
            fan_in = cin * k * k / 2
            if name == "conv1_1":
                fan_in *= cfg["input_var"]
            out += [(f"{name}.weight", (cout, cin, k, k), "kernel", fan_in),
                    (f"{name}.bias", (cout,), "bias", 0)]
            cin = cout
    fc, e = cfg["fc_features"], fc6_extent(cfg)
    out += [("fc6.weight", (fc, cin, e, e), "kernel", cin * e * e / 2),
            ("fc6.bias", (fc,), "bias", 0),
            ("fc7.weight", (fc, fc, 1, 1), "kernel", fc / 2),
            ("fc7.bias", (fc,), "bias", 0),
            ("prediction.weight", (cfg["num_outputs"], fc), "kernel", fc),
            ("prediction.bias", (cfg["num_outputs"],), "bias", 0)]
    return out


def _layer(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, pad: int,
           ops: Ops) -> torch.Tensor:
    y = ops.conv(x, p[f"{name}.weight"], 1, pad) + p[f"{name}.bias"][:, None, None]
    return F.relu(ops.store(y))


def forward(cfg: dict, p: Dict[str, torch.Tensor], frames: torch.Tensor,
            ops: Ops, embedding: bool = False) -> torch.Tensor:
    """[B, S, S, 1] uint8 gray frames -> [B, C] logits (float32), or the
    fc7 features with ``embedding``; float32 products without TF32."""
    with exact_fp32():
        x = frames.float().permute(0, 3, 1, 2)
        if x.shape[-1] != cfg["input_size"] or x.shape[-2] != cfg["input_size"]:
            x = resize_align_corners(x, cfg["input_size"])
        mean = torch.tensor(cfg["mean_rgb"], device=x.device)
        x = x.expand(-1, 3, -1, -1) - mean[None, :, None, None]
        pool = cfg["pool"]
        for names in conv_names(cfg):
            for name in names:
                x = _layer(x, p, name, cfg["conv"]["pad"], ops)
            x = F.max_pool2d(x, pool["kernel"], pool["stride"])
        x = _layer(_layer(x, p, "fc6", 0, ops), p, "fc7", 0, ops).flatten(1)
        if embedding:
            return x
        return ops.linear(x, p["prediction.weight"], p["prediction.bias"])
