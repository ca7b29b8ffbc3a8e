"""The readings that a cell's limits are set from, on the card:

    python perfbench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--variants control fault:<name> ...] [--variant-seeds 3] [--seconds 0]

For every seed one set-up, a window of ``--seconds`` (0: one unit of work)
and the check of the program's output against the plain reference; for
the first ``--variant-seeds`` seeds also each variant's readings: the
control (the reference in float8 in the program's place), the faults
planted in the reference (``fault:half_batch``, ``fault:altered_answer``)
and ``bf16``, the reference in the program's precision, a witness for the
look at a number. One JSON line a reading on standard output.
The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402

from perfbench.harness.cli import execute, set_cache_dirs  # noqa: E402
from perfbench.harness.spec import load_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--variant-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    cell = load_cell(args.workload, rehearse=args.rehearse)
    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for i, seed in enumerate(args.seeds):
        variants = (None, *args.variants) if i < args.variant_seeds else (None,)
        out = execute(cell, seed, args.seconds, False, device, args.rehearse,
                      time.perf_counter(), variants)
        for v, checks in out["variants"].items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v or "program",
                              **out["readings"].get(v, {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
