"""The program's spans (``mcncrossmodalemotions_torch/utils/trace``) joined
with the traced slice's device operations, on one clock.

The spans are stamped with ``time.time_ns()``; ``torch.profiler``'s
Chrome trace puts an event at ``baseTimeNanoseconds + ts`` microseconds on
the same clock, so both go onto the trace's microsecond scale here.

- A device operation goes to the narrowest span of any thread that holds
  its launching runtime call's start; else to ``NO_SPAN``. Within one
  thread the narrowest is the innermost. Across threads it is the most
  specific: a launch of the autograd engine's thread inside
  ``vggm.bn.backward`` goes there rather than to the main thread's wider
  ``train.backward``, and a main-thread launch inside ``visual.h2d``
  there rather than to the decoder thread's wider ``visual.decode``. The
  rule reads no thread ids, which this torch's CUDA-only trace does not
  give reliably: a launch of a thread with no span (the training feed's
  copies) goes to the narrowest span another thread has open then.
  Operations that overlap (two streams) share their union: each takes
  the part of its interval that no earlier-starting operation covered, so
  the seconds by span add up to the slice's busy time.
- Each idle interval of the slice (the complement of the union of device
  operations between the slice's start and end) goes to the innermost
  span of the main thread over it, split where that span changes, and to
  ``NO_SPAN`` where none is open.
- The clocks are checked by anchors alone: kernels (``ANCHOR_KERNEL``)
  each launched inside a ``trace.anchor`` span just wide enough for the
  launch. The i-th anchor launch lies inside the i-th anchor span only
  where the trace's clock less the spans' lies in ``[launch end - span
  end, launch start - span start]``; ``clock_us`` is the intersection of
  those ranges over the anchors.

The record's inputs: ``record["spans"]`` (``trace.snapshot()`` of the
window) and ``record["trace"]["device_op_intervals"]`` (``device_op_
intervals`` of the slice's Chrome trace, with the slice's ``time_ns``
bounds). A record without them (a run of a program that records no spans,
or an untraced run) joins to None.
"""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from perfbench.harness.cli import side
from perfbench.harness.trace import DEVICE_CATS

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ANCHOR_KERNEL = "spin_kernel"  # torch.cuda._sleep's
NO_SPAN = "(no span)"
# the trace.span fields (mcncrossmodalemotions_torch/utils/trace.py)
NAME, START, END, PARENT, TID, ATTRS = range(6)


def device_op_intervals(path: Path) -> dict:
    """Every device operation of a Chrome trace as ``[start, end, launch
    start, launch end, correlation]`` (microseconds after ``base_ns``; the
    launch fields None where the trace holds no runtime call of its
    correlation id), the launches ``[start, end]`` of its anchor kernels,
    and the file's ``baseTimeNanoseconds``."""
    doc = json.loads(Path(path).read_text())
    calls, ops = {}, []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, corr = e.get("cat", ""), (e.get("args") or {}).get("correlation")
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in LAUNCH_CATS and corr is not None:
            calls[corr] = (start, end)
        elif cat in DEVICE_CATS:
            ops.append((start, end, corr, ANCHOR_KERNEL in e.get("name", "")))
    out, anchors = [], []
    for start, end, corr, anchor in ops:
        call = calls.get(corr, (None, None))
        out.append([start, end, call[0], call[1], corr])
        if anchor and call[0] is not None:
            anchors.append(list(call))
    return {"base_ns": int(doc.get("baseTimeNanoseconds", 0)), "ops": out,
            "anchors": sorted(anchors)}


def narrowest(intervals) -> List[tuple]:
    """``(start, end, key)`` intervals as disjoint segments ``(start, end,
    key)`` on which ``key`` is the narrowest interval covering them (of
    two as wide, the later-started; the innermost where intervals nest)."""
    bounds = sorted({p for s, e, _ in intervals for p in (s, e)})
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    heap: list = []
    out: List[list] = []
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(order) and order[i][0] <= a:
            s, e, key = order[i]
            heapq.heappush(heap, (e - s, -s, -i, e, key))
            i += 1
        while heap and heap[0][3] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        key = heap[0][4]
        if out and out[-1][1] == a and out[-1][2] == key:
            out[-1][1] = b
        else:
            out.append([a, b, key])
    return [tuple(seg) for seg in out]


class _Timeline:
    """Innermost-span lookup on sorted disjoint segments."""

    def __init__(self, segments):
        self.segments = segments
        self.starts = [s for s, _, _ in segments]

    def at(self, t: float) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.segments[i][1] >= t:
            return self.segments[i][2]
        return None


def _union(ivs) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlaps(intervals, segments):
    """Yield ``(seconds, key)`` of each overlap of sorted disjoint
    ``intervals`` with sorted disjoint ``(start, end, key)`` segments, and
    ``(seconds, None)`` for the parts no segment covers."""
    j = 0
    for s, e in intervals:
        t = s
        while j < len(segments) and segments[j][1] <= t:
            j += 1
        k = j
        while t < e:
            if k < len(segments) and segments[k][0] < e:
                a, b, key = segments[k]
                if a > t:
                    yield (a - t) / 1e6, None
                    t = a
                stop = min(b, e)
                yield (stop - t) / 1e6, key
                t = stop
                k += 1
            else:
                yield (e - t) / 1e6, None
                t = e


def join(snapshot: dict, dev: dict) -> dict:
    """The slice's device and idle seconds by span name (see the module's
    docstring), with the anchors' bounds on the clocks' offset."""
    base = dev["base_ns"]
    lo, hi = ((n - base) / 1e3 for n in dev["slice_ns"])
    spans = [(s[NAME], (s[START] - base) / 1e3, (s[END] - base) / 1e3, s[TID])
             for s in snapshot["spans"] if s[END] is not None]
    names = [s[0] for s in spans]
    anywhere = _Timeline(narrowest([(s, e, i) for i, (_, s, e, _) in enumerate(spans)]))

    device: Dict[str, float] = defaultdict(float)
    cover = 0.0
    ops = sorted(((max(o[0], lo), min(o[1], hi), o[2])
                  for o in dev["ops"] if o[1] > lo and o[0] < hi),
                 key=lambda o: o[:2])
    for start, end, call_start in ops:
        part = max(0.0, end - max(start, cover)) / 1e6
        cover = max(cover, end)
        idx = anywhere.at(call_start) if call_start is not None else None
        device[NO_SPAN if idx is None else names[idx]] += part
    busy = _union([(s, e) for s, e, _ in ops])
    idle_ivs, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            idle_ivs.append((t, s))
        t = max(t, e)
    idle: Dict[str, float] = defaultdict(float)
    main = narrowest([(s, e, i) for i, (_, s, e, tid) in enumerate(spans)
                      if tid == snapshot["main_tid"]])
    for sec, idx in _overlaps(idle_ivs, main):
        idle[NO_SPAN if idx is None else names[idx]] += sec

    marks = sorted((s, e) for name, s, e, _ in spans if name == "trace.anchor")
    launches = dev.get("anchors", [])
    clock = None
    if marks and len(marks) == len(launches):
        clock = [max(ce - e for (_, e), (_, ce) in zip(marks, launches)),
                 min(cs - s for (s, _), (cs, _) in zip(marks, launches))]

    steps = sorted((s, e) for name, s, e, _ in spans
                   if name == "train.step" and lo <= s and e <= hi)
    starts = [s for s, _ in steps]
    step_launches = 0
    for o in dev["ops"]:
        if o[2] is not None:
            i = bisect.bisect_right(starts, o[2]) - 1
            step_launches += i >= 0 and o[2] <= steps[i][1]
    busy_s = sum(e - s for s, e in busy) / 1e6
    return {"slice_s": (hi - lo) / 1e6, "busy_s": busy_s,
            "idle_s": (hi - lo) / 1e6 - busy_s,
            "device_by_span_s": dict(device), "idle_by_span_s": dict(idle),
            "clock_us": clock, "anchors": len(launches),
            "steps": len(steps), "step_launches": step_launches,
            "ops": len(ops)}


def joined(record: dict) -> Optional[dict]:
    """``join`` of the record's spans and slice, made once a record (the
    two ``side:`` tables printed then); None without either."""
    if "span_join" in record:
        return record["span_join"]
    snap = record.get("spans")
    dev = (record.get("trace") or {}).get("device_op_intervals")
    out = None
    if snap and dev and dev.get("ops"):
        out = join(snap, dev)
        for kind, total in (("device", out["busy_s"]), ("idle", out["idle_s"])):
            key = f"{kind}_by_span_s"
            table = sorted(out[key].items(), key=lambda kv: -kv[1])
            side(f"{kind} seconds by span "
                 f"({sum(out[key].values()):.6f} of {total:.6f} s): "
                 + ", ".join(f"{n} {s:.6f}" for n, s in table))
        spanned = 1 - out["device_by_span_s"].get(NO_SPAN, 0) / max(out["busy_s"], 1e-12)
        side(f"span join: {out['ops']} device operations, {100 * spanned:.2f}% "
             f"of busy time in a span; by {out['anchors']} anchors the trace's clock "
             f"less the spans' lies in {out['clock_us']} us")
    record["span_join"] = out
    return out


def share(record: dict, kind: str, names) -> Optional[float]:
    """The share (%) of the slice's ``device`` (busy) or ``idle`` seconds
    under the spans ``names``."""
    out = joined(record)
    if out is None:
        return None
    key = f"{kind}_by_span_s"
    total = out["busy_s"] if kind == "device" else out["idle_s"]
    if total <= 0:
        return None
    return 100.0 * sum(out[key].get(n, 0.0) for n in names) / total


def untraced(record: dict, name: str) -> Optional[List[float]]:
    """The durations (s) of the spans ``name`` that lie outside the traced
    slice (all of them in a run without one); None without spans."""
    snap = record.get("spans")
    if not snap:
        return None
    dev = (record.get("trace") or {}).get("device_op_intervals") or {}
    lo, hi = dev.get("slice_ns", (0, 0))
    return [(s[END] - s[START]) / 1e9 for s in snap["spans"]
            if s[NAME] == name and s[END] is not None
            and (s[END] <= lo or s[START] >= hi)]
