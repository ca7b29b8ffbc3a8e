"""The 3x3/2 max pool as a 2x2/1 pool followed by a 2x2/2 pool.

Port of ``tools/probe_pool_compose.py``. Max is associative, so the max
over a 3x3 window at stride 2 is a 2x2/1 max pool followed by a 2x2/2 max
pool, exactly: the forward is held bitwise to the direct pool. The
backward routes each window's gradient to one winner as the direct pool
does, but ties may route differently (the composition picks its 2x2
stage's winner first), so it is compared on random float32 inputs, where
ties are rare (the largest difference and the count of elements that
differ are reported: among pool1's 612M float32 inputs a few exact ties
remain, where the two route apart). Rows at pool1's train input ``[128, 253, 197, 96]`` bf16:
the direct ``F.max_pool2d`` (the JAX tool's XLA row), the composition of
two ``F.max_pool2d``, and K2's train pair (``ops/pool.
max_pool_3x3s2_train``, the with-index forward and the backward kernel),
which is what the student runs; forward ms and forward+backward ms with
the loss (y^2 summed) and the gradient returned (``bench.cuda_ms``)::

    python -m mcncrossmodalemotions_torch.tools.probe_pool_compose [--device cpu]

The last line is one JSON object of the records.
"""

from __future__ import annotations

import argparse
import json

SHAPE = (128, 253, 197, 96)  # pool1's input at the train batch of 128
ROWS = ("direct 3x3s2", "2x2s1+2x2s2", "k2 train pair")


def main(device="cuda", shape=SHAPE, iters: int = 10) -> dict:
    """``{"shape", "fwd_max_abs_diff", "fwd_bitwise", "bwd_max_abs_diff",
    "bwd_mismatches", "bwd_bitwise", rows: {"fwd_ms", "fwd_bwd_ms"},
    "launches"}``; a CPU
    rehearsal passes a small shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.bench import device_ms
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.tools import kernel_launches
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    dev = resolve_device(device, "probe_pool_compose")
    x32 = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(
        np.float32)).to(dev)
    x = x32.to(torch.bfloat16)

    def direct(a):
        return F.max_pool2d(a.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)

    def composed(a):
        m = F.max_pool2d(a.permute(0, 3, 1, 2), 2, 1)
        return F.max_pool2d(m, 2, 2).permute(0, 2, 3, 1)

    fns = dict(zip(ROWS, (direct, composed, pool.max_pool_3x3s2_train)))

    def loss_and_grad(fn, a):
        ag = a.detach().requires_grad_(True)
        loss = (fn(ag).float() ** 2).sum()
        return loss, torch.autograd.grad(loss, ag)[0]

    out: dict = {"shape": list(shape)}
    with torch.no_grad():
        yd, yc = direct(x), composed(x)
        out["fwd_max_abs_diff"] = (yd.float() - yc.float()).abs().max().item()
        out["fwd_bitwise"] = torch.equal(yd.contiguous().view(torch.int16),
                                         yc.contiguous().view(torch.int16))
        del yd, yc
    gd, gc = loss_and_grad(direct, x32)[1], loss_and_grad(composed, x32)[1]
    out["bwd_max_abs_diff"] = (gd - gc).abs().max().item()
    out["bwd_mismatches"] = int((gd != gc).sum().item())
    out["bwd_bitwise"] = out["bwd_mismatches"] == 0
    del gd, gc, x32
    print(f"shape {tuple(shape)}; fwd max|diff| = {out['fwd_max_abs_diff']} "
          f"(bitwise {out['fwd_bitwise']}); bwd on float32 max|diff| = "
          f"{out['bwd_max_abs_diff']:.3e} at {out['bwd_mismatches']} of "
          f"{int(np.prod(shape))} elements (bitwise {out['bwd_bitwise']})",
          flush=True)
    for name, fn in fns.items():
        with torch.no_grad():
            t_f = device_ms(lambda: fn(x), dev, iters)
        t_fb = device_ms(lambda: loss_and_grad(fn, x), dev, iters)
        out[name] = {"fwd_ms": t_f, "fwd_bwd_ms": t_fb}
        print(f"{name:14s} fwd {t_f:6.2f} ms   fwd+bwd {t_fb:6.2f} ms",
              flush=True)
    out["launches"] = kernel_launches()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
