"""Plain SE-ResNet-50 (Hu et al., CVPR 2018, Table 1) from
``configs/senet50-ferplus.json``, with the face pipeline in front of it:
uint8 gray [B, S, S, 1] -> float -> (align-corners bilinear resize to the
input size where it differs) -> three equal channels minus the dataset's
mean RGB -> conv1 7x7/2 (pad 3), BatchNorm, ReLU, a 3x3/2 max pool in
ceil mode -> bottlenecks 1x1 (the stage's stride) -> 3x3 -> 1x1 (x4),
each with BatchNorm, squeeze-excitation (mean, fc/16, ReLU, fc,
sigmoid) on the third, a projection shortcut (1x1 conv + BatchNorm) where
the shape changes, ReLU after the sum -> the global mean -> the head."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.common import Leaf, Ops, batch_norm


def _bn(name: str, c: int, stem: bool = False) -> List[Leaf]:
    return [(f"{name}.weight", (c,), "bn_scale", 0), (f"{name}.bias", (c,), "bn_shift", 0),
            (f"{name}.running_mean", (c,), "running_mean", 0),
            (f"{name}.running_var", (c,), "stem_var" if stem else "running_var", 0)]


def blocks(cfg: dict):
    """(name, cin, width, stride, project) of every bottleneck."""
    out, cin = [], cfg["stem"]["out"]
    for stage, (n, width) in enumerate(zip(cfg["stage_sizes"], cfg["stage_widths"])):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            cout = width * cfg["expansion"]
            out.append((f"layer{stage + 1}_{b}", cin, width, stride,
                        cin != cout or stride != 1))
            cin = cout
    return out


def leaves(cfg: dict) -> List[Leaf]:
    stem = cfg["stem"]
    k = stem["kernel"]
    out: List[Leaf] = [("conv1.weight", (stem["out"], cfg["input_channels"], k, k),
                        "kernel", cfg["input_channels"] * k * k)]
    out += _bn("bn1", stem["out"], stem=True)
    for name, cin, width, _, project in blocks(cfg):
        cout = width * cfg["expansion"]
        red = cout // cfg["se_reduction"]
        out += [(f"{name}.conv1.weight", (width, cin, 1, 1), "kernel", cin)]
        out += _bn(f"{name}.bn1", width)
        out += [(f"{name}.conv2.weight", (width, width, 3, 3), "kernel", width * 9)]
        out += _bn(f"{name}.bn2", width)
        out += [(f"{name}.conv3.weight", (cout, width, 1, 1), "kernel", width)]
        out += _bn(f"{name}.bn3", cout)
        out += [(f"{name}.se.fc1.weight", (red, cout), "kernel", cout),
                (f"{name}.se.fc1.bias", (red,), "bias", 0),
                (f"{name}.se.fc2.weight", (cout, red), "kernel", red),
                (f"{name}.se.fc2.bias", (cout,), "bias", 0)]
        if project:
            out += [(f"{name}.downsample.weight", (cout, cin, 1, 1), "kernel", cin)]
            out += _bn(f"{name}.bn_down", cout)
        cin = cout
    out += [("prediction.weight", (cfg["num_outputs"], cin), "kernel", cin),
            ("prediction.bias", (cfg["num_outputs"],), "bias", 0)]
    return out


def resize_align_corners(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, 1, H, W] -> [B, 1, size, size], align-corners bilinear."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=True)


def forward(cfg: dict, p: Dict[str, torch.Tensor], frames: torch.Tensor,
            train: bool, ops: Ops, embedding: bool = False) -> torch.Tensor:
    """[B, S, S, 1] uint8 gray frames -> [B, C] logits (float32), or the
    pooled embedding before the head with ``embedding``."""
    eps = cfg["batchnorm_eps"]
    x = frames.float().permute(0, 3, 1, 2)
    if x.shape[-1] != cfg["input_size"] or x.shape[-2] != cfg["input_size"]:
        x = resize_align_corners(x, cfg["input_size"])
    mean = torch.tensor(cfg["mean_rgb"], device=x.device)
    x = x.expand(-1, 3, -1, -1) - mean[None, :, None, None]
    stem = cfg["stem"]
    x = ops.conv(x, p["conv1.weight"], stem["stride"], stem["pad"])
    x = F.relu(ops.store(batch_norm(x, p, "bn1", train, eps)))
    x = F.max_pool2d(x, stem["pool"]["kernel"], stem["pool"]["stride"], ceil_mode=True)
    for name, _, _, stride, project in blocks(cfg):
        y = F.relu(ops.store(batch_norm(ops.conv(x, p[f"{name}.conv1.weight"], stride),
                                        p, f"{name}.bn1", train, eps)))
        y = F.relu(ops.store(batch_norm(ops.conv(y, p[f"{name}.conv2.weight"], 1, 1),
                                        p, f"{name}.bn2", train, eps)))
        y = ops.store(batch_norm(ops.conv(y, p[f"{name}.conv3.weight"]), p,
                                 f"{name}.bn3", train, eps))
        s = y.mean(dim=(2, 3))
        s = F.relu(ops.linear(s, p[f"{name}.se.fc1.weight"], p[f"{name}.se.fc1.bias"]))
        s = torch.sigmoid(ops.linear(s, p[f"{name}.se.fc2.weight"], p[f"{name}.se.fc2.bias"]))
        y = ops.store(y * ops.store(s)[:, :, None, None])
        if project:
            x = ops.store(batch_norm(ops.conv(x, p[f"{name}.downsample.weight"], stride),
                                     p, f"{name}.bn_down", train, eps))
        x = F.relu(ops.store(y + x))
    x = x.mean(dim=(2, 3))
    if embedding:
        return x
    return ops.linear(x, p["prediction.weight"], p["prediction.bias"])
