"""The CPU time this process (its threads and children) spent over a
window, beside the cores it may use: a side record of how much of the
host a cell's run takes. The machine-wide ``/proc/stat`` is not read:
under a virtualised kernel it need not count other tenants' time."""

from __future__ import annotations

import os
import resource
import time


def snapshot() -> dict:
    """This process's CPU seconds so far, and the time."""
    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return {"t": time.perf_counter(),
            "cpu": me.ru_utime + me.ru_stime + kids.ru_utime + kids.ru_stime}


def report(a: dict, b: dict) -> str:
    """The CPU seconds spent between snapshots ``a`` and ``b``."""
    wall = b["t"] - a["t"]
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    cpu = b["cpu"] - a["cpu"]
    return (f"host: this process used {cpu:.3f} cpu-s over {wall:.3f} s, "
            f"{cpu / wall:.3f} of its {cores} cores")
