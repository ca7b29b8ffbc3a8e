"""Plain VGG-VD-16 face teacher: the port's reference for the CPU tests.

Configuration D of Simonyan & Zisserman (ICLR 2015) as VGG-Face (Parkhi,
Vedaldi & Zisserman, BMVC 2015) with an 8-way FER+ head, written from the
papers in plain PyTorch in float32 with TF32 off. It imports neither JAX
nor anything of the port, and takes its weights by the port's
``state_dict`` names (``conv1_1.weight`` ... ``fc6.weight``, ``fc7.weight``,
``prediction.weight``; ``bn_<conv>.*`` for the useBnorm retrofit):

- uint8 gray frames [B, H, W, 1] -> float -> align-corners bilinear resize
  to ``input_size`` where the size differs -> three equal channels minus
  the mean RGB;
- 13 3x3 convs (pad 1, stride 1) with their biases in five blocks of 2, 2,
  3, 3 and 3, a ReLU after each, a 2x2/2 max pool after each block;
- fc6 a conv over the whole remaining extent (7x7 at 224), fc7 a 1x1 conv,
  each with its bias and a ReLU;
- the fc7 features flattened, the head a linear layer.

Departures from the papers: the input is a gray face replicated to three
channels (the dense pass's frames); eval has no dropout; the head is
FER+'s 8 classes, not VGG-Face's 2,622 identities. With BatchNorm (the
reference's insertBNLayers retrofit) each conv and fc is followed by an
eval BatchNorm with its running statistics, before its ReLU.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

BLOCK_SIZES = (2, 2, 3, 3, 3)
BN_EPS = 1e-5


def conv_names() -> List[str]:
    return [f"conv{b}_{c}" for b, n in enumerate(BLOCK_SIZES, start=1)
            for c in range(1, n + 1)]


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


def _layer(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
           padding: int) -> torch.Tensor:
    x = F.conv2d(x, p[f"{name}.weight"].float(), p.get(f"{name}.bias"),
                 1, padding)
    bn = f"bn_{name}"
    if f"{bn}.weight" in p:
        inv = torch.rsqrt(p[f"{bn}.running_var"] + BN_EPS) * p[f"{bn}.weight"]
        x = ((x - p[f"{bn}.running_mean"][:, None, None]) * inv[:, None, None]
             + p[f"{bn}.bias"][:, None, None])
    return F.relu(x)


def forward(p: Dict[str, torch.Tensor], frames: torch.Tensor, input_size: int,
            mean_rgb: Sequence[float], embedding: bool = False) -> torch.Tensor:
    """[B, H, W, 1] uint8 gray frames -> [B, C] float32 logits, or the fc7
    features with ``embedding``."""
    p = {k: v.float() for k, v in p.items()}
    with exact_fp32():
        x = frames.float().permute(0, 3, 1, 2)
        if x.shape[-2:] != (input_size, input_size):
            x = F.interpolate(x, size=(input_size, input_size),
                              mode="bilinear", align_corners=True)
        mean = torch.tensor(mean_rgb, dtype=torch.float32, device=x.device)
        x = x.expand(-1, 3, -1, -1) - mean[None, :, None, None]
        names = conv_names()
        at = 0
        for n in BLOCK_SIZES:
            for name in names[at:at + n]:
                x = _layer(x, p, name, 1)
            at += n
            x = F.max_pool2d(x, 2, 2)
        x = _layer(_layer(x, p, "fc6", 0), p, "fc7", 0)
        x = x.flatten(1)
        if embedding:
            return x
        return F.linear(x, p["prediction.weight"], p["prediction.bias"])
