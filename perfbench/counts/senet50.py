"""SE-ResNet-50's forward FLOPs from its config (convs, SE fcs, head)."""

from __future__ import annotations

from perfbench.counts import conv_flops, conv_out


def layers(cfg: dict, size: int):
    """(cin, cout, kh, kw, ho, wo) of every conv and linear, in order."""
    stem = cfg["stem"]
    h = conv_out(size, stem["kernel"], stem["stride"], stem["pad"])
    out = [(cfg["input_channels"], stem["out"], stem["kernel"], stem["kernel"], h, h)]
    pool = stem["pool"]
    h = -(-(h - pool["kernel"]) // pool["stride"]) + 1  # ceil mode
    cin = stem["out"]
    exp = cfg["expansion"]
    for stage, (blocks, width) in enumerate(zip(cfg["stage_sizes"], cfg["stage_widths"])):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ho = conv_out(h, 1, stride)
            out.append((cin, width, 1, 1, ho, ho))
            out.append((width, width, 3, 3, ho, ho))
            out.append((width, width * exp, 1, 1, ho, ho))
            red = width * exp // cfg["se_reduction"]
            out.append((width * exp, red, 1, 1, 1, 1))
            out.append((red, width * exp, 1, 1, 1, 1))
            if cin != width * exp or stride != 1:
                out.append((cin, width * exp, 1, 1, ho, ho))
            cin, h = width * exp, ho
    out.append((cin, cfg["num_outputs"], 1, 1, 1, 1))
    return out


def forward_flops(cfg: dict, size: int) -> int:
    return sum(conv_flops(*l) for l in layers(cfg, size))


def train_flops(cfg: dict, size: int) -> int:
    """Forward + backward: conv1's input (the image) needs no gradient."""
    ls = layers(cfg, size)
    return 3 * sum(conv_flops(*l) for l in ls) - conv_flops(*ls[0])
