"""conv1 alone, plain against space-to-depth, on the card.

Port of ``tools/probe_conv1_s2d.py``: the student's 7x7/2 Cin=1 conv1
against its space-to-depth form (``models/vggm.space_to_depth_conv1``:
the input regrouped 2x2 into 4 channels, a 4x4/1 conv with the kernel
re-laid inside the graph from the canonical ``[96, 1, 7, 7]`` weight), at
the train shape ``[128, 1, 512, 400]`` in bf16 (float32 inputs cast inside
each call, as the student casts them). Each fwd+bwd call returns y
together with the input and kernel gradients, as the JAX tool's jits do so
that no part of the work is left out. Prints the max |diff| of the two
forms in bf16 and in fp32 (TF32 off), then each form's forward and
forward+backward ms (``bench._best_of``)::

    python -m mcncrossmodalemotions_torch.tools.probe_conv1_s2d [--device cpu]

The last line is one JSON object of the records.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

BASE = "7x7s2 Cin=1 (baseline)"
S2D = "s2d 4x4s1 Cin=4"


def main(device="cuda", batch_size: int = 128, height: int = 512,
         width: int = 400, iters: int = 20) -> dict:
    """The two forms' parity and times at ``[batch_size, 1, height,
    width]``; a CPU rehearsal passes small sizes."""
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.bench import _best_of, _sync
    from mcncrossmodalemotions_torch.models.vggm import space_to_depth_conv1
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    dev = resolve_device(device, "probe_conv1_s2d")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch_size, height, width, 1).astype(
        np.float32)).to(dev).permute(0, 3, 1, 2)  # channels_last [B, 1, H, W]
    w = torch.from_numpy((rng.randn(7, 7, 1, 96) * 0.05).astype(
        np.float32).transpose(3, 2, 0, 1).copy()).to(dev)

    def conv_base(x, w, dtype=torch.bfloat16):
        return F.conv2d(x.to(dtype), w.to(dtype), stride=2)

    def conv_s2d(x, w, dtype=torch.bfloat16):
        return space_to_depth_conv1(x.to(dtype), w.to(dtype))

    out: dict = {}
    with torch.no_grad():
        ya, yb = conv_base(x, w), conv_s2d(x, w)
        out["shapes"] = [list(ya.shape), list(yb.shape)]
        out["max_abs_diff"] = (ya.float() - yb.float()).abs().max().item()
        out["max_abs_y"] = ya.float().abs().max().item()
        del ya, yb
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            ya = conv_base(x, w, torch.float32)
            yb = conv_s2d(x, w, torch.float32)
            out["max_abs_diff_fp32"] = (ya - yb).abs().max().item()
            out["max_abs_y_fp32"] = ya.abs().max().item()
        del ya, yb
    print(f"shapes {out['shapes'][0]}, max |diff| = {out['max_abs_diff']:.6f} "
          f"(bf16 accum; max |y| {out['max_abs_y']:.4f}), fp32 "
          f"{out['max_abs_diff_fp32']:.3e} (TF32 off)", flush=True)

    def timed(name, conv):
        box = [None]

        def fwd():
            with torch.no_grad():
                box[0] = conv(x, w)

        def fwdbwd():
            xg = x.detach().requires_grad_(True)
            wg = w.detach().requires_grad_(True)
            y = conv(xg, wg)
            loss = (y.float() ** 2).mean()
            box[0] = (y, *torch.autograd.grad(loss, (xg, wg)))

        rec = {}
        for label, fn in (("fwd", fwd), ("fwd+bwd", fwdbwd)):
            rec[f"{label}_ms"] = _best_of(fn, lambda: _sync(dev),
                                          iters=iters) * 1000
            print(f"{name:24s} {label:7s} {rec[f'{label}_ms']:7.3f} ms",
                  flush=True)
        box[0] = None
        return rec

    out[BASE] = timed(BASE, conv_base)
    out[S2D] = timed(S2D, conv_s2d)
    for label in ("fwd", "fwd+bwd"):
        out[f"speedup_{label}"] = (out[BASE][f"{label}_ms"]
                                   / out[S2D][f"{label}_ms"])
    print(f"\nspeedup fwd {out['speedup_fwd']:.3f}x, fwd+bwd "
          f"{out['speedup_fwd+bwd']:.3f}x", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
