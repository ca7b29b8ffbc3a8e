"""The train step with and without the masked BatchNorm at the bench shape.

Port of ``tools/probe_masked_bn.py``: the bench's headline step
(``bench.bench_train_step``: the full student at float32 ``[128, 64384]``,
hot-cross-ent at T=2, SGD without weight decay) without a ``pad_mask``
(``baseline``: every BatchNorm takes its unmasked branch, as the headline
does) or with an all-ones one the step passes to the student (``masked``:
the masked branch, as ``run_distillation``'s steps run it). One variant a
process::

    python -m mcncrossmodalemotions_torch.tools.probe_masked_bn baseline
    python -m mcncrossmodalemotions_torch.tools.probe_masked_bn masked [--iters 20] [--device cpu]

The last line is one JSON object of the record.
"""

from __future__ import annotations

import argparse
import json

VARIANTS = ("baseline", "masked")


def main(variant: str = "baseline", device="cuda", iters: int = 20,
         **step_kw) -> dict:
    """``{"variant", "ms", "utts_per_sec", "launches"}``; ``step_kw`` goes to
    ``bench_train_step`` (a CPU rehearsal passes small sizes)."""
    from mcncrossmodalemotions_torch.bench import bench_train_step
    from mcncrossmodalemotions_torch.tools import kernel_launches

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}; choose from {VARIANTS}")
    details: dict = {}
    utts = bench_train_step(details, device, iters=iters,
                            pad_mask=variant == "masked", **step_kw)
    print(f"{variant}: {details['train_step_ms']:.2f} ms/step "
          f"({utts:.0f} utts/s)", flush=True)
    return {"variant": variant, "ms": details["train_step_ms"],
            "utts_per_sec": round(utts, 2), "launches": kernel_launches()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.variant, args.device, args.iters)))
