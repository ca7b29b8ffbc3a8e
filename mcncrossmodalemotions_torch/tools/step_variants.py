"""The bench's train step in four forms, side by side in one process.

``bench.bench_train_step`` (the full student at ``[128, 64384]``, seed 0)
with float32 rows (the headline's form) and int16 rows, each without a
``pad_mask`` (the student's BatchNorm takes its unmasked branch, as the
headline does) and with an all-ones one (the masked branch, as
``run_distillation``'s steps and ``chip_smoke.py``'s train phase run it).
The forms run in the order A B C D D C B A, so a drift of the card's
clock falls on each alike::

    python -m mcncrossmodalemotions_torch.tools.step_variants [--iters 20] [--device cpu]

Prints a line a run, then one JSON line: each form's two ``train_step_ms``.
"""

from __future__ import annotations

import argparse
import json

FORMS = {"f32": dict(int16_rows=False, pad_mask=False),
         "f32 masked": dict(int16_rows=False, pad_mask=True),
         "int16": dict(int16_rows=True, pad_mask=False),
         "int16 masked": dict(int16_rows=True, pad_mask=True)}


def main(device="cuda", iters: int = 20, **step_kw) -> dict:
    """{form: [ms, ms]} over the two passes; ``step_kw`` goes to
    ``bench_train_step`` (a CPU rehearsal passes small sizes)."""
    from mcncrossmodalemotions_torch.bench import bench_train_step

    times: dict = {form: [] for form in FORMS}
    for form in list(FORMS) + list(FORMS)[::-1]:
        details: dict = {}
        bench_train_step(details, device, iters=iters, **FORMS[form], **step_kw)
        times[form].append(details["train_step_ms"])
        print(f"{form}: {details['train_step_ms']} ms", flush=True)
    return times


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device, args.iters)))
