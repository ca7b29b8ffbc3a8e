"""VGG-VD-16's forward FLOPs from its config (13 convs, fc6, fc7, the head),
those of the 3x3 convolutions alone, and the least bytes of its block-end epilogue (``affine_relu_pool2x2``:
the affine, the ReLU and the 2x2/2 max pool of a block's last conv
output)."""

from __future__ import annotations

from typing import List, Tuple

from perfbench.counts import conv_flops


def block_ends(cfg: dict, size: int) -> List[Tuple[int, int]]:
    """(h = w, c) of each block's last conv output, which its pool reads."""
    out, h = [], size
    for widths in cfg["blocks"]:
        out.append((h, widths[-1]))
        h //= cfg["pool"]["stride"]
    return out


def layers(cfg: dict, size: int):
    """(cin, cout, kh, kw, ho, wo) of every conv and linear, in order."""
    k, out, cin, h = cfg["conv"]["kernel"], [], cfg["input_channels"], size
    for widths in cfg["blocks"]:
        for cout in widths:
            out.append((cin, cout, k, k, h, h))
            cin = cout
        h //= cfg["pool"]["stride"]
    fc = cfg["fc_features"]
    out.append((cin, fc, h, h, 1, 1))  # fc6 over the whole extent
    out.append((fc, fc, 1, 1, 1, 1))
    out.append((fc, cfg["num_outputs"], 1, 1, 1, 1))
    return out


def forward_flops(cfg: dict, size: int) -> int:
    return sum(conv_flops(*l) for l in layers(cfg, size))


def conv3x3_flops(cfg: dict, size: int) -> int:
    """The 13 3x3 convolutions' share of ``forward_flops``: fc6, fc7 and
    the head left out."""
    return sum(conv_flops(*l) for l in layers(cfg, size)[:-3])


def pool_bytes(cfg: dict, size: int, batch: int, elem_bytes: int) -> int:
    """The block-end epilogues of one forward at ``batch``: each reads the
    2 ho x 2 wo window rows of y and fp32 s and t, and writes y / 4."""
    total = 0
    for h, c in block_ends(cfg, size):
        ho = h // 2
        total += batch * (4 + 1) * ho * ho * c * elem_bytes + 2 * 4 * c
    return total
