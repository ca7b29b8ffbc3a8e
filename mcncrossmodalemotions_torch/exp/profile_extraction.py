"""Where the extraction slice's time goes, on one CUDA device.

    python -m mcncrossmodalemotions_torch.exp.profile_extraction \\
        [--out chiprun_out/profile_tables.txt]

Drives ``compute_audio_feats`` over the traffic of ``chip_smoke.py`` (the
defaults of ``data.synthetic_track_imdb``: 126 tracks in three buckets)
with the full-width student and seeded weights, batch 64, once with the
kernels and once with their plain versions (``use_kernels=False``):

1. two warm-up runs of each;
2. five timed runs of each, in turns: host wall around the call,
   ended by ``torch.cuda.synchronize()``, and tracks/s;
3. one run of each under ``torch.profiler``: its wall, the device busy
   time (the union of the device events' intervals: kernels, copies and
   memsets), the busy share (busy / wall), and the device events by self
   time, summed by name.

The summary goes to stdout; the profiler's op tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

DEVICE_TYPES = (DeviceType.CUDA,)
BATCH = 64
REPS = 5


def busy_us(events, window: Optional[Tuple[float, float]] = None) -> float:
    """Microseconds in which at least one device event ran; within
    ``window`` ((start, end) on the events' clock) if one is given."""
    first, last = window or (float("-inf"), float("inf"))
    spans = sorted((max(e.time_range.start, first), min(e.time_range.end, last))
                   for e in events if e.device_type in DEVICE_TYPES)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > max(lo, end):
            total += hi - max(lo, end)
            end = hi
    return total


def main(argv: Sequence[str] = ()) -> int:
    from torch.profiler import ProfilerActivity, profile

    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("profile_extraction: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    modes = {"kernels": True, "plain": False}
    tables: List[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        imdb = synthetic_track_imdb(Path(tmp))
        n = len(imdb.wav_paths)
        model = build_student(with_frontend=False)  # full width, bf16
        state = student_state_dict_from_flax(random_student_variables(seed=0))

        def run(use_kernels: bool) -> float:
            t0 = time.perf_counter()
            compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                use_kernels=use_kernels, verbose=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for _ in range(2):
            for use in modes.values():
                run(use)
        walls = {m: [] for m in modes}
        for _ in range(REPS):
            for m, use in modes.items():
                walls[m].append(run(use))
        for m, ws in walls.items():
            print(f"{card}: {m}: {n} tracks, walls (s) "
                  f"{[round(w, 4) for w in ws]}, tracks/s "
                  f"{[round(n / w, 1) for w in ws]}")

        for m, use in modes.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = run(use)
            busy = busy_us(prof.events())
            by_name = sorted(
                (e for e in prof.key_averages() if e.device_type in DEVICE_TYPES),
                key=lambda e: -e.self_device_time_total)
            summed = sum(e.self_device_time_total for e in by_name)
            print(f"{card}: {m}, profiled run: wall {wall * 1e3:.3f} ms, device "
                  f"busy {busy / 1e3:.3f} ms ({busy / 1e3 / (wall * 1e3):.2%} of "
                  f"the wall), device events summed {summed / 1e3:.3f} ms")
            for e in by_name[:12]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                      f"{e.count:4d}x  {e.key[:90]}")
            ka = prof.key_averages()
            tables.append(f"=== {m} ===\n"
                          + ka.table(sort_by="self_device_time_total",
                                     row_limit=40, max_name_column_width=90)
                          + ka.table(sort_by="self_cpu_time_total",
                                     row_limit=25, max_name_column_width=90))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(card + "\n" + "\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
