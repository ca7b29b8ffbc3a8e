"""The VGG-M student's shapes, FLOPs and kernel bytes, from its config.

Input: a ``[bins, frames]`` spectrogram (512 bins). ``frames`` is what the
student sees: 400 for a 4 s crop, a bucket's width in extraction.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.counts import conv_flops, conv_out


def layer_shapes(cfg: dict, frames: int) -> List[dict]:
    """Every conv/linear with its input and output sizes, and the 3x3/2
    pools (K2) with their input, in network order."""
    h, w, c = cfg["input_bins"], frames, 1
    out = []
    for conv in cfg["convs"]:
        (kh, kw), (sh, sw), (ph, pw) = conv["kernel"], conv["stride"], conv["pad"]
        ho, wo = conv_out(h, kh, sh, ph), conv_out(w, kw, sw, pw)
        out.append(dict(kind="conv", name=conv["name"], cin=c, cout=conv["out"],
                        kh=kh, kw=kw, ho=ho, wo=wo))
        h, w, c = ho, wo, conv["out"]
        if conv["name"] in cfg["pool_3x3s2_after"]:
            out.append(dict(kind="pool", name=f"pool_{conv['name']}", c=c, h=h, w=w,
                            ho=conv_out(h, 3, 2), wo=conv_out(w, 3, 2)))
            h, w = conv_out(h, 3, 2), conv_out(w, 3, 2)
    (kh, kw), (sh, sw) = cfg["pool5"]["kernel"], cfg["pool5"]["stride"]
    h, w = conv_out(h, kh, sh), conv_out(w, kw, sw)
    fh, fw = cfg["fc6"]["kernel"]
    out.append(dict(kind="conv", name="fc6", cin=c, cout=cfg["fc6"]["out"],
                    kh=fh, kw=fw, ho=conv_out(h, fh, 1), wo=conv_out(w, fw, 1)))
    out.append(dict(kind="conv", name="fc7", cin=cfg["fc6"]["out"],
                    cout=cfg["fc7"], kh=1, kw=1, ho=1, wo=1))
    out.append(dict(kind="conv", name="prediction", cin=cfg["fc7"],
                    cout=cfg["num_outputs"], kh=1, kw=1, ho=1, wo=1))
    return out


def forward_flops(cfg: dict, frames: int) -> int:
    """Forward FLOPs of one utterance."""
    return sum(conv_flops(l["cin"], l["cout"], l["kh"], l["kw"], l["ho"], l["wo"])
               for l in layer_shapes(cfg, frames) if l["kind"] == "conv")


def train_flops(cfg: dict, frames: int) -> int:
    """Forward + backward FLOPs of one utterance: the backward's weight
    and input gradients are each a forward's work, and conv1's input (the
    spectrogram) needs none."""
    layers = [l for l in layer_shapes(cfg, frames) if l["kind"] == "conv"]
    fwd = sum(conv_flops(l["cin"], l["cout"], l["kh"], l["kw"], l["ho"], l["wo"])
              for l in layers)
    first = layers[0]
    return 3 * fwd - conv_flops(first["cin"], first["cout"], first["kh"],
                                first["kw"], first["ho"], first["wo"])


def pool_shapes(cfg: dict, frames: int) -> List[Tuple[int, int, int, int, int]]:
    """(C, H, W, Ho, Wo) of each 3x3/2 pool (K2) of one utterance."""
    return [(l["c"], l["h"], l["w"], l["ho"], l["wo"])
            for l in layer_shapes(cfg, frames) if l["kind"] == "pool"]
