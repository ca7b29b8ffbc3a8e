"""One traced run of a cell with the program's own spans recorded, joined
with the device trace on one clock:

    python perfbench/program_spans.py --workload <cell> --seed <n> \\
        [--seconds 30] [--record 1|0]

The run is the harness's ``--trace 1`` run (``harness/cli.execute``: the
same set-up, window, traced slice and check) with two parts in their
place for this process: the cell's driver, whose window runs with the
program's recording (``mcncrossmodalemotions_torch/utils/trace``) on
(``--record 1``) or off and leaves its ``snapshot()`` in the record
(``spans``), and the tracer, which also keeps the slice's ``time.time_ns()``
bounds, launches ``ANCHORS`` anchor kernels, each inside a
``trace.anchor`` span just wide enough for its launch, as the slice
starts, and reads every device operation with its launching runtime call
(``device_op_intervals``). It prints the join's two ``side:``
tables (device and idle seconds by span), then the per-layer metrics of
``program_spans.json`` that the cell lists, read by their readers under
``metrics/``, and the untraced rest's rate: comparing that rate between
``--record 1`` and ``--record 0`` gives what recording costs. The last
line is one JSON object. The benchmark's own runs never run this.

The tool stands in for two edits to the harness that its files do not yet
have: ``cli.execute`` turning the program's recording on around the
window in ``--trace 1`` runs, and ``trace.Tracer`` keeping the slice's
``time_ns`` bounds, the anchors and ``device_op_intervals``. Once the
harness has them, its readers read ``program_spans.json``'s metrics in the
benchmark's own traced runs, and this file and ``program_spans.json`` go.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import tempfile  # noqa: E402

from perfbench.harness import cli, spec  # noqa: E402
from perfbench.harness.trace import Tracer, read_chrome_trace  # noqa: E402
from perfbench.metrics.spans import device_op_intervals  # noqa: E402

ENTRIES = json.loads(Path(__file__).with_name("program_spans.json").read_text())["per_layer"]
ANCHORS = 16


class RecordingDriver:
    """A cell's driver whose window runs with the program recording
    (``record``) or not; the window's spans go to ``run.record["spans"]``."""

    def __init__(self, drv, record: bool):
        self._drv, self._record = drv, record

    def __getattr__(self, name):
        return getattr(self._drv, name)

    def window(self, run, ctx, t0, tracer):
        from mcncrossmodalemotions_torch.utils import trace

        trace.reset()
        if self._record:
            trace.enable()
        try:
            return self._drv.window(run, ctx, t0, tracer)
        finally:
            trace.disable()
            run.record["spans"] = trace.snapshot() if self._record else None


class SpanTracer(Tracer):
    """The harness's tracer, which also keeps the slice's bounds on the
    spans' clock, anchors it (``ANCHORS`` kernels of ``torch.cuda._sleep``,
    each launched inside a ``trace.anchor`` span that holds nothing
    else) and reads each device operation's launch."""

    ns0 = ns1 = 0
    _synced_ns = 0

    def warm_up(self) -> None:
        super().warm_up()
        if self.enabled and self.cuda:
            import torch

            torch.cuda._sleep(1)

    def _sync(self) -> None:
        super()._sync()
        self._synced_ns = time.time_ns()

    def boundary(self, window_t0: float = 0.0) -> bool:
        starts = self.prof is None and not self.done
        on = super().boundary(window_t0)
        if starts and on:
            self.ns0 = time.time_ns()
            from mcncrossmodalemotions_torch.utils import trace

            if self.cuda and trace.recording():
                import torch

                for _ in range(ANCHORS):
                    t0 = time.time_ns()
                    torch.cuda._sleep(1)
                    trace.add("trace.anchor", t0, time.time_ns())
        return on

    def finish(self) -> None:
        running = not self.done and self.prof is not None
        super().finish()
        if running:
            self.ns1 = self._synced_ns

    def read(self) -> None:
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.result = read_chrome_trace(Path(path), self.window_s)
            self.result["device_op_intervals"] = dict(
                device_op_intervals(Path(path)), slice_ns=[self.ns0, self.ns1])
        finally:
            os.unlink(path)
            self.prof = None


@contextlib.contextmanager
def program_spans(record: bool):
    """``cli.execute`` with the recording driver and the span tracer."""
    driver, tracer = cli.driver, cli.Tracer
    cli.driver = lambda name: RecordingDriver(spec.driver(name), record)
    cli.Tracer = SpanTracer
    try:
        yield
    finally:
        cli.driver, cli.Tracer = driver, tracer


def run(cell, seed: int, seconds: float, record: bool, device, rehearse: bool,
        t_start: float) -> dict:
    """One run; the line's object: the readings of the cell's span
    metrics, the rates in and outside the traced slice, the join's checks
    and ``correct``."""
    with program_spans(record):
        out = cli.execute(cell, seed, seconds, True, device, rehearse, t_start)
    rec, win = out["record"], out["win"]
    readings = {}
    for m in ENTRIES:
        if cell.name in m["workloads"]:
            readings[m["name"]] = spec.metric_reader(m["name"]).read(rec)
    t = out["trace"] or {}
    traced_s = t.get("window_s", 0.0)
    rest_s = rec.get("untraced_s", 0.0)
    join = rec.get("span_join") or {}
    return {"workload": cell.name, "seed": seed, "record": record,
            "correct": all(c.ok for c in out["checks"]) and win["failed"] == 0,
            "metrics": readings,
            "rest_rate": ((win["count"] - win["traced_count"]) / rest_s
                          if rest_s > 0 else None),
            "slice_rate": win["traced_count"] / traced_s if traced_s > 0 else None,
            "unit": cell.metric["unit"], "setup_s": out["setup_s"],
            "join": {k: v for k, v in join.items() if not k.endswith("_by_span_s")}}


def main(argv=None, rehearse: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cli.set_cache_dirs()
    cell = spec.load_cell(args.workload, rehearse=rehearse)
    import torch

    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            cli.log("no CUDA device")
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        cli.nvidia_smi("set-up")
    res = run(cell, args.seed, args.seconds, bool(args.record), device, rehearse,
              T_START if argv is None else time.perf_counter())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
