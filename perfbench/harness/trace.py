"""The traced slice of a window: ``torch.profiler`` over whole units of
work (epochs, passes, segments), started and stopped by the cell driver's main
thread between units; after the window its Chrome trace is read back for
the device's busy time, each kernel's time and launches, and the longest
idle gaps named by what the host was doing.

On a card the profiler records the device's activity alone (kernels,
copies, sets and the CUDA runtime calls that issue them), not the host's
operators: recording every operator slows the host that paces these
cells, and so would inflate the slice's idle share. An idle gap is then
named by the runtime call it falls in, or as time between runtime calls
(Python, the feed, host work). Without a card (the CPU rehearsal) it
records the host's operators, as there is nothing else to record."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NO_HOST_EVENT = "host: between runtime calls (Python, feed, host work)"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, an anonymous namespace, its
    template arguments and parameter list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name


class Tracer:
    """Call ``boundary()`` before every unit of a window and ``finish()``
    after the last one: the profiler starts at the first boundary and
    stops at the first boundary ``seconds`` or more later. ``boundary``
    says whether the next unit is traced."""

    def __init__(self, enabled: bool, seconds: float, cuda: bool):
        self.enabled = enabled
        self.seconds = seconds
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = self.window_s = 0.0
        self.done = not enabled
        self.result: Optional[dict] = None
        self.start_offset_s = 0.0

    def _activities(self) -> list:
        import torch

        act = torch.profiler.ProfilerActivity
        return [act.CUDA] if self.cuda else [act.CPU]

    def warm_up(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer, seconds that would fall inside the
        window."""
        if not self.enabled:
            return
        import torch

        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
        self._sync()

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def boundary(self, window_t0: float = 0.0) -> bool:
        if self.done:
            return False
        if self.prof is None:
            import torch

            self._sync()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.t0 = time.perf_counter()
            self.start_offset_s = self.t0 - window_t0 if window_t0 else 0.0
            return True
        if time.perf_counter() - self.t0 >= self.seconds:
            self.finish()
            return False
        return True

    def finish(self) -> None:
        """Stop the profiler (its own stopping counts as traced time)."""
        if self.done or self.prof is None:
            self.done = True
            return
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.t1 = time.perf_counter()
        self.done = True

    def read(self) -> None:
        """Read the trace back, after the measured window."""
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.result = read_chrome_trace(Path(path), self.window_s)
        finally:
            os.unlink(path)
            self.prof = None


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merge [start, end] rows (sorted by start) into disjoint ones."""
    out: List[List[float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.float64).reshape(-1, 2)


def read_chrome_trace(path: Path, window_s: float) -> dict:
    """busy_s (the union of device operations), each kernel's seconds and
    launches, the top device operations and the longest idle gaps by the
    innermost host event (a runtime call on a card) running at their
    middle."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        k = kernels[short_name(name)]
        k[0] += (e - s) / 1e6
        k[1] += 1
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    if not dev:
        return {"window_s": window_s, "busy_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": [], "device_events": 0}
    host.sort()
    iv = _union(np.asarray(sorted((s, e) for s, e, _ in dev)))
    busy = float((iv[:, 1] - iv[:, 0]).sum()) / 1e6
    lo = min([iv[0, 0]] + [h[0] for h in host[:1]])
    hi = max([iv[-1, 1]] + [h[1] for h in host[-1:]])
    bounds = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
    gaps = bounds[:, 1] - bounds[:, 0]
    order = np.argsort(-gaps)[:200]
    hs = np.asarray([h[0] for h in host], np.float64)
    he = np.asarray([h[1] for h in host], np.float64)
    named: Dict[str, float] = defaultdict(float)
    for g in order:
        if gaps[g] <= 0:
            continue
        mid = 0.5 * (bounds[g, 0] + bounds[g, 1])
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        if len(cover):
            best = host[int(cover[np.argmin(he[cover] - hs[cover])])][2]
        else:
            best = NO_HOST_EVENT
        named[best] += float(gaps[g]) / 1e6
    gaps_top = sorted(named.items(), key=lambda x: -x[1])[:10]
    return {"window_s": window_s, "busy_s": busy,
            "kernels": {n: {"seconds": v[0], "launches": v[1]} for n, v in kernels.items()},
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_top],
            "device_events": len(dev)}
