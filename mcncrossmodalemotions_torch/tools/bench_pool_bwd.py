"""K2's numerics on the card, then its time against F.max_pool2d's.

Port of ``tools/bench_pool_bwd.py``. Numerics: the student's pool
(``ops/pool.max_pool_3x3s2_train``: K2's with-index forward and its
backward kernel) against autograd of ``F.max_pool2d`` on random bf16
inputs at the JAX tool's three NHWC shapes, y and dx bitwise, and dx
again on a float32 input (the JAX tool's ``grad exact`` case). Time, at
pool1 ``[128, 253, 197, 96]`` and pool2 ``[128, 61, 47, 256]`` in bf16:
the forward alone, and the forward and backward together with both y
(summed) and dx returned, so the forward is part of the work timed (the
JAX tool's "honest" rule). The ``F.max_pool2d`` row is cuDNN's pool
(JAX's ``xla`` row), the ``k2`` row the student's. Times are
``bench.cuda_ms`` (CUDA events around calls queued behind a device
sleep). On the CPU (``--device cpu``) a bf16 dx is not the CPU autograd's
bitwise, which sums in bf16 where the card's sums in fp32 as the kernel
does::

    python -m mcncrossmodalemotions_torch.tools.bench_pool_bwd [--device cpu]

The last line is one JSON object of the records.
"""

from __future__ import annotations

import argparse
import json

NUMERICS_SHAPES = ((2, 21, 19, 96), (2, 34, 46, 8), (128, 253, 197, 96))
GRAD_SHAPE = (2, 33, 35, 8)  # float32
TIMED_SHAPES = (("pool1", (128, 253, 197, 96)), ("pool2", (128, 61, 47, 256)))


def _bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def main(device="cuda", numerics_shapes=NUMERICS_SHAPES,
         timed_shapes=TIMED_SHAPES, iters: int = 10) -> dict:
    """``{"numerics": [...], "timing": [...], "launches": {...}}``; a CPU
    rehearsal passes small shapes."""
    import torch

    from mcncrossmodalemotions_torch.bench import device_ms
    from mcncrossmodalemotions_torch.ops import pool
    from mcncrossmodalemotions_torch.tools import kernel_launches
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    dev = resolve_device(device, "bench_pool_bwd")
    gen = torch.Generator(device=dev)

    def plain(x):
        return pool.max_pool_3x3s2(x).contiguous()

    def both(fn, x, dy):
        xg = x.detach().requires_grad_(True)
        y = fn(xg)
        (dx,) = torch.autograd.grad(y, xg, dy)
        return y, dx

    numerics = []
    cases = [(s, torch.bfloat16) for s in numerics_shapes]
    cases.append((GRAD_SHAPE, torch.float32))
    for shape, dtype in cases:
        gen.manual_seed(0)
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        ho, wo = (shape[1] - 3) // 2 + 1, (shape[2] - 3) // 2 + 1
        dy = torch.randn((shape[0], ho, wo, shape[3]), device=dev,
                         generator=gen).to(dtype)
        y, dx = both(pool.max_pool_3x3s2_train, x, dy)
        ref_y, ref_dx = both(plain, x, dy)
        rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "fwd_exact": torch.equal(_bits(y), _bits(ref_y)),
               "grad_exact": torch.equal(_bits(dx), _bits(ref_dx.contiguous()))}
        numerics.append(rec)
        print(tuple(shape), rec["dtype"], "fwd exact=", rec["fwd_exact"],
              "grad exact=", rec["grad_exact"], flush=True)
        del x, dy, y, dx, ref_y, ref_dx

    timing = []
    for name, shape in timed_shapes:
        gen.manual_seed(0)
        ho, wo = (shape[1] - 3) // 2 + 1, (shape[2] - 3) // 2 + 1
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        dy = torch.randn((shape[0], ho, wo, shape[3]), device=dev,
                         generator=gen).to(torch.bfloat16)
        for label, fwd, train in (("F.max_pool2d", plain, plain),
                                  ("k2", pool.max_pool_3x3s2_cuda,
                                   pool.max_pool_3x3s2_train)):
            fwd_ms = device_ms(lambda: fwd(x), dev, iters)

            def fwd_bwd():
                y, dx = both(train, x, dy)
                return y.float().sum(), dx

            fb_ms = device_ms(fwd_bwd, dev, iters)
            timing.append({"pool": name, "shape": list(shape), "impl": label,
                           "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms})
            print(f"{name} {label:12s} fwd only:         {fwd_ms:7.3f} ms",
                  flush=True)
            print(f"{name} {label:12s} fwd+bwd (no DCE): {fb_ms:7.3f} ms",
                  flush=True)
        del x, dy
    return {"numerics": numerics, "timing": timing,
            "launches": kernel_launches()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
