"""One run of one cell: set-up, the measured window, the reference check,
and the result line.

The run exits 3 and prints no result without enough CUDA devices; it
never falls back to the CPU. ``main(..., rehearse=True)`` is the CPU
rehearsal the harness's tests drive: the cell's ``rehearse`` overrides
(tiny widths and data) on the CPU, the program's plain paths in place of
its kernels; it prints a result like a run, and no device metric of it
means anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from perfbench.harness import host
from perfbench.harness.spec import ROOT, Cell, driver, load_cell, metric_reader
from perfbench.harness.trace import Tracer

BANNED = ("jax", "jaxlib", "flax", "optax", "mcncrossmodalemotions_tpu")
PROGRAM = "mcncrossmodalemotions_torch"
TRACE_SECONDS = 3.0


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc and g++ builds go to ``build/kernels/``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's, Optax's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def side(msg: str) -> None:
    """A side record: an earlier line of standard output."""
    print(f"side: {msg}", flush=True)


def nvidia_smi(when: str) -> None:
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"unavailable ({exc})"
    for i, line in enumerate(out.splitlines() or [out]):
        side(f"nvidia-smi {when} card {i}: {query} = {line}")


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the device, a scratch
    directory under TMPDIR and the record the metric readers read."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    rehearse: bool
    tmp: Path
    record: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def workload(self) -> dict:
        return self.cell.workload

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()


def progress(marks, unit: str) -> None:
    """A side record of the window's rate by quarter, from the driver's
    ``(seconds into the window, count so far)`` marks at unit boundaries:
    a run that is slow all through was slowed by its host, not by a stall
    that a longer window would dilute."""
    if not marks or len(marks) < 2:
        return
    end = marks[-1][0]
    rates, last = [], (0.0, 0.0)
    for q in (0.25, 0.5, 0.75, 1.0):
        mark = next(m for m in marks if m[0] >= q * end - 1e-9)
        if mark[0] > last[0]:
            rates.append(f"{(mark[1] - last[1]) / (mark[0] - last[0]):.4f}")
            last = mark
    side(f"rate by quarter of the window ({len(marks)} marks): "
         f"{', '.join(rates)} {unit}")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            rehearse: bool, t_start: float, variants=(None,)) -> dict:
    """Set-up, window and check of one run. ``variants`` are the
    comparisons made: None the program's, ``control`` or ``fault:<name>``
    the reference in lower precision or with a fault planted put in the
    program's place (the calibration's readings); the first is the run's."""
    import importlib

    import torch

    importlib.import_module(PROGRAM)  # a checkout without the program stops here
    drv = driver(cell.workload["driver"])
    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmp:
        run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, rehearse=rehearse, tmp=Path(tmp))
        ctx = drv.setup(run)
        tracer = Tracer(trace, TRACE_SECONDS, device.type == "cuda")
        tracer.warm_up()
        gc.collect()
        run.sync()
        if device.type == "cuda":
            nvidia_smi("window start")
        cpu0 = host.snapshot()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        win = drv.window(run, ctx, t_window, tracer)
        run.sync()
        wall = time.perf_counter() - t_window
        cpu1 = host.snapshot()
        tracer.finish()
        tracer.read()
        if hasattr(drv, "after_window"):  # work timed apart, outside the wall
            drv.after_window(run, ctx, win)
        side(host.report(cpu0, cpu1))
        progress(win.get("progress"), cell.metric["unit"])
        side(f"window: {win['count']} done over {wall:.6f} s of wall, "
             f"{win['count'] / wall:.4f} {cell.metric['unit']}"
             + (f"; {win['device_s']:.6f} s of it timed on the device"
                if "device_s" in win else ""))
        if device.type == "cuda":
            nvidia_smi("window end")
            peak = int(torch.cuda.max_memory_allocated(device))
        else:
            peak = 0
        if tracer.result is not None:
            for name, k in sorted(tracer.result["kernels"].items(),
                                  key=lambda kv: -kv[1]["seconds"]):
                log(f"traced kernel {k['launches']} x {name}: {k['seconds']:.6f} s")
            side(f"profiled window starts {tracer.start_offset_s:.6f} s into the "
                 f"measured window and lasts {tracer.result['window_s']:.6f} s; "
                 f"{tracer.result['device_events']} device operations")
        traced_s = tracer.t1 - tracer.t0 if tracer.result is not None else 0.0
        if traced_s > 0 and wall > traced_s and win["count"] > win["traced_count"]:
            unit = cell.metric["unit"]
            inside = win["traced_count"] / tracer.result["window_s"]
            outside = (win["count"] - win["traced_count"]) / (wall - traced_s)
            side(f"traced slice {inside:.4f} {unit}, the rest of the window "
                 f"{outside:.4f} {unit}: the profiler costs "
                 f"{100.0 * (1.0 - inside / outside):.2f}% of the rate")
        run.record.update(window_s=wall, untraced_s=wall - traced_s,
                          trace=tracer.result, **win)
        checks = {}
        for v in variants:
            t0 = time.perf_counter()
            checks[v] = drv.check(run, ctx, win, v)
            side(f"check{'' if v is None else ' of ' + v} took "
                 f"{time.perf_counter() - t0:.2f} s")
    return {"setup_s": setup_s, "wall": wall, "win": win, "peak": peak,
            "checks": checks[variants[0]], "variants": checks, "record": run.record,
            "readings": run.record.get("readings", {}), "trace": tracer.result}


def result_line(cell: Cell, out: dict, trace: bool, device, chips: int) -> dict:
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
    ``checks`` last."""
    import torch

    win, record = out["win"], out["record"]
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = out["setup_s"]
            elif m["source"] == "device_trace":  # the work over the driver's device time
                value = win["count"] / win["device_s"]
            else:
                value = win["count"] / out["wall"]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(record)
            if value is None:
                log(f"per-layer metric {m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": out["peak"]}
    res: Dict[str, Any] = {"correct": bool(all(c.ok for c in out["checks"])
                                           and win["failed"] == 0),
                           "attempted": int(win["attempted"]),
                           "failed": int(win["failed"]), "metrics": metrics,
                           "device": dev}
    if trace and out["trace"] is not None:
        t = out["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        res["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out["checks"]}
    return res


def main(argv=None, *, t_start: Optional[float] = None, rehearse: bool = False) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(sys.argv[1:] if argv is None else argv)
    set_cache_dirs()
    cell = load_cell(args.workload, rehearse=rehearse)
    import torch

    if rehearse:
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            log(f"{args.workload} needs {cell.chips} CUDA device(s); found {have}. "
                "A measuring run does not fall back to the CPU.")
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        nvidia_smi("set-up")
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  rehearse, t_start)
    res = result_line(cell, out, bool(args.trace), device, cell.chips)
    found = banned_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {', '.join(found)}")
        return 4
    for c in out["checks"]:
        log(f"check {c.name} = {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'NOT CORRECT'}")
    print(json.dumps(res), flush=True)
    return 0
