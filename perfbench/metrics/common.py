"""Arithmetic the per-layer readers share."""

from __future__ import annotations

from typing import Optional, Sequence

from perfbench.counts import kernels
from perfbench.harness.cli import side


def mfu(record: dict) -> Optional[float]:
    """The model FLOPs of the work completed in the window outside its
    traced slice over the time outside that slice, as a share (%) of the
    card's dense bf16 peak (the profiler slows the slice it traces)."""
    if not record.get("free_flops") or record.get("untraced_s", 0) <= 0:
        return None
    return (100.0 * record["free_flops"] / record["untraced_s"]
            / record["peaks"]["bf16_flops"])


def device_idle(record: dict) -> Optional[float]:
    """The profiled window's share (%) in which no device operation ran."""
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline(record: dict, metric: str, names: Sequence[str], work: str,
                    launches: dict) -> Optional[float]:
    """The roofline share (%) of the kernels named ``names`` in the traced
    slice: the least time of ``traced_work[work + '_bytes']`` and
    ``[work + '_flops']`` over their summed device time. None where the
    slice holds none of them, or other launch counts than the traced work
    needs (``launches``: kernel name -> expected count, None: any)."""
    t, w = record.get("trace"), record.get("traced_work")
    if not t or not w or not t["kernels"] or not (w.get(f"{work}_bytes") or
                                                   w.get(f"{work}_flops")):
        return None
    seconds = 0.0
    for name in names:
        k = t["kernels"].get(name)
        if k is None:
            return None
        if launches.get(name) is not None and k["launches"] != launches[name]:
            side(f"{metric}: {k['launches']} launches of {name} in the trace, "
                 f"{launches[name]} expected; not read")
            return None
        seconds += k["seconds"]
    share, bound = kernels.roofline(w.get(f"{work}_bytes", 0), w.get(f"{work}_flops", 0),
                                    seconds, record["peaks"])
    side(f"{metric}: {share:.4f}% of the {bound} bound over {seconds:.6f} s of "
         f"kernel time, {w.get(f'{work}_bytes', 0)} bytes, {w.get(f'{work}_flops', 0)} "
         f"operations")
    return share
