"""The whole train step with a plain or a space-to-depth conv1.

Port of ``tools/ab_step_conv1.py``: the bench's headline step
(``bench.bench_train_step``: the full student at float32 ``[128, 64384]``,
hot-cross-ent at T=2, SGD without weight decay) with the student's conv1
as the plain 7x7/2 conv or as ``SpaceToDepthConv1`` (``conv1_s2d``). One
form a process, as the JAX CLI has it; run both and compare the ms::

    python -m mcncrossmodalemotions_torch.tools.ab_step_conv1 plain
    python -m mcncrossmodalemotions_torch.tools.ab_step_conv1 s2d [--iters 20] [--device cpu]

The last line is one JSON object of the record.
"""

from __future__ import annotations

import argparse
import json

VARIANTS = ("plain", "s2d")


def main(variant: str = "s2d", device="cuda", iters: int = 20,
         **step_kw) -> dict:
    """``{"conv1", "ms", "utts_per_sec", "launches"}`` of one form; ``step_kw`` goes to
    ``bench_train_step`` (a CPU rehearsal passes small sizes)."""
    from mcncrossmodalemotions_torch.bench import bench_train_step
    from mcncrossmodalemotions_torch.tools import kernel_launches

    if variant not in VARIANTS:
        raise ValueError(f"conv1 form {variant!r}; choose from {VARIANTS}")
    details: dict = {}
    utts = bench_train_step(details, device, iters=iters,
                            conv1_s2d=variant == "s2d", **step_kw)
    print(f"conv1={variant}: {details['train_step_ms']:.3f} ms "
          f"({utts:.1f} utts/s)", flush=True)
    return {"conv1": variant, "ms": details["train_step_ms"],
            "utts_per_sec": round(utts, 2), "launches": kernel_launches()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", nargs="?", default="s2d", choices=VARIANTS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.variant, args.device, args.iters)))
