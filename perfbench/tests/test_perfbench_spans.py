"""The program's spans joined with the device trace (``metrics/spans.py``),
the readers of ``program_spans.json`` and the tool that runs them
(``program_spans.py``), on the CPU.

- On a hand-built Chrome trace and span record with a known answer: each
  device operation goes to the narrowest span of any thread that holds
  its launch; overlapping operations share their union; idle time goes to
  the main thread's innermost span, split where it changes; both tables
  add up to the slice's busy and idle time; launches a step count every
  thread's; the anchors bound the clocks' offset.
- Each reader returns None on a record without spans or without the
  slice's device operations, as it will on a program that records none.
- The span tracer leaves every key of the harness's ``read_chrome_trace``
  as it was and adds one.
- The tool rehearses each cell on the CPU: correct, the host-side readers
  read with recording on and nothing with it off.
"""

import json
import time

import pytest
import torch

from perfbench import program_spans
from perfbench.harness import cli
from perfbench.harness.spec import BENCH, metric_reader
from perfbench.harness.trace import read_chrome_trace
from perfbench.metrics import spans
from perfbench.tests.cells import BENCHMARK, load as load_cell

BASE = 1_000_000_000_000  # ns
MAIN, AUTOGRAD, FEED, DECODE = 101, 202, 303, 404


def _span(name, start_us, end_us, tid, parent=None):
    return (name, BASE + int(start_us * 1000), BASE + int(end_us * 1000),
            parent, tid, {})


def _x(cat, name, ts, dur, tid=0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, dur=2):
    # the trace's thread ids are not read: CUPTI's do not match the program's
    return _x("cuda_runtime", "cudaLaunchKernel", ts, dur, 7777, corr)


@pytest.fixture
def case(tmp_path):
    """A slice of 0-1000 us. Main thread: train.step 100-700 with
    train.forward 100-300 (vggm.bn 150-250 in it) and train.backward
    300-600; train.feed_wait 700-900. The autograd thread's
    vggm.bn.backward 400-500. The decoder thread's visual.decode 50-980."""
    snap = {"main_tid": MAIN, "dropped": 0, "spans": [
        _span("train.step", 100, 700, MAIN),
        _span("train.forward", 100, 300, MAIN, 0),
        _span("vggm.bn", 150, 250, MAIN, 1),
        _span("train.backward", 300, 600, MAIN, 0),
        _span("vggm.bn.backward", 400, 500, AUTOGRAD),
        _span("train.feed_wait", 700, 900, MAIN),
        _span("visual.decode", 50, 980, DECODE),
        ("still open", BASE, None, None, FEED, {}),
    ]}
    events = [
        # forward: conv launched at 110 runs 120-160; bn's two launched at
        # 160 and 170 run 200-240 and 230-260 (overlap: union 200-260)
        _launch(110, 1), _x("kernel", "conv", 120, 40, corr=1),
        _launch(160, 2), _x("kernel", "bn_a", 200, 40, corr=2),
        _launch(170, 3), _x("kernel", "bn_b", 230, 30, corr=3),
        # backward from the autograd thread: one in bn.backward, one not
        # (goes to the narrowest span that holds it: train.backward)
        _launch(410, 4), _x("kernel", "bn_bwd", 420, 60, corr=4),
        _launch(550, 5), _x("kernel", "conv_bwd", 560, 100, corr=5),
        # a copy launched in the feed wait, one launched where only the
        # decoder thread's span is open, and one operation whose runtime
        # call the trace does not hold
        _launch(750, 6, dur=5), _x("gpu_memcpy", "Memcpy HtoD", 760, 20, corr=6),
        _launch(920, 8), _x("kernel", "late", 930, 5, corr=8),
        _x("kernel", "orphan", 950, 10, corr=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    dev = dict(spans.device_op_intervals(path), slice_ns=[BASE, BASE + 1_000_000])
    return snap, dev


def test_the_join_attributes_operations_and_idle_time(case):
    snap, dev = case
    out = spans.join(snap, dev)
    us = 1e-6
    assert out["slice_s"] == pytest.approx(1000 * us)
    # busy: 120-160, 200-260, 420-480, 560-660, 760-780, 930-935, 950-960
    assert out["busy_s"] == pytest.approx(295 * us)
    assert out["idle_s"] == pytest.approx(705 * us)
    assert out["device_by_span_s"] == pytest.approx({
        "train.forward": 40 * us, "vggm.bn": 60 * us,
        "vggm.bn.backward": 60 * us, "train.backward": 100 * us,
        "train.feed_wait": 20 * us, "visual.decode": 5 * us,
        spans.NO_SPAN: 10 * us})
    assert sum(out["device_by_span_s"].values()) == pytest.approx(out["busy_s"])
    # idle: 0-100 none; 100-120 fwd; 160-200 bn; 260-300 fwd;
    # 300-420, 480-560 backward; 660-700 step; 700-760, 780-900 feed;
    # 900-930, 935-950, 960-1000 none (the decoder's span is not the main
    # thread's)
    assert out["idle_by_span_s"] == pytest.approx({
        spans.NO_SPAN: 185 * us, "train.forward": 60 * us, "vggm.bn": 40 * us,
        "train.backward": 200 * us, "train.step": 40 * us,
        "train.feed_wait": 180 * us})
    assert sum(out["idle_by_span_s"].values()) == pytest.approx(out["idle_s"])
    assert out["clock_us"] is None and out["anchors"] == 0
    assert (out["steps"], out["step_launches"], out["ops"]) == (1, 5, 8)


def test_the_anchors_bound_the_clocks_offset(case, tmp_path):
    """Two anchor spans, 10-20 and 30-40 us; their kernels' launches 12-15
    and 31-36 on the trace's clock: the offset lies in [-4, 1] us. Two
    spans and one launch bound nothing."""
    snap, dev = case
    snap["spans"] += [_span("trace.anchor", 30, 40, MAIN),
                      _span("trace.anchor", 10, 20, MAIN)]
    events = [_launch(31, 91, dur=5), _x("kernel", "at::cuda::spin_kernel(long)", 37, 1, corr=91),
              _launch(12, 90, dur=3), _x("kernel", "at::cuda::spin_kernel(long)", 16, 1, corr=90),
              _launch(50, 92), _x("kernel", "not_an_anchor", 52, 1, corr=92)]
    path = tmp_path / "anchors.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    anchors = spans.device_op_intervals(path)["anchors"]
    assert anchors == [[12.0, 15.0], [31.0, 36.0]]
    out = spans.join(snap, dict(dev, anchors=anchors))
    assert out["clock_us"] == pytest.approx([-4.0, 1.0]) and out["anchors"] == 2
    assert spans.join(snap, dict(dev, anchors=anchors[:1]))["clock_us"] is None


def test_narrowest_takes_the_narrowest_covering_span():
    segs = spans.narrowest([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                            (8, 12, "d"), (20, 30, "e"), (0, 10, "a2"),
                            (1, 9, "other thread")])
    assert segs == [(0, 1, "a2"), (1, 2, "other thread"), (2, 3, "b"),
                    (3, 4, "c"), (4, 5, "b"), (5, 8, "other thread"),
                    (8, 12, "d"), (20, 30, "e")]


def test_the_readers_read_the_join(case):
    snap, dev = case
    record = {"spans": snap, "trace": {"device_op_intervals": dev}, "untraced_s": 1.0}
    got = {m["name"]: metric_reader(m["name"]).read(dict(record))
           for m in program_spans.ENTRIES}
    assert got["bn_busy_share.distill"] == pytest.approx(100 * 120 / 295)
    assert got["feed_idle_share.distill"] == pytest.approx(100 * 180 / 705)
    assert got["launches_per_step.distill"] == 5
    assert got["host_issue_ms.distill"] is None  # the one step is in the slice
    assert got["decode_wait_frac.dense"] == 0.0
    assert got["decode_idle_share.dense"] == 0.0
    assert got["issue_idle_share.dense"] == 0.0
    outside = dict(record, trace={"device_op_intervals": dict(
        dev, slice_ns=[BASE + 2_000_000, BASE + 3_000_000])})
    assert metric_reader("host_issue_ms.distill").read(outside) == pytest.approx(0.6)


@pytest.mark.parametrize("name", [m["name"] for m in program_spans.ENTRIES])
@pytest.mark.parametrize("record", [
    {}, {"spans": None, "trace": None, "untraced_s": 5.0},
    {"spans": None, "trace": {"busy_s": 1.0}, "untraced_s": 5.0}])
def test_each_reader_reads_nothing_without_spans(name, record):
    assert metric_reader(name).read(dict(record)) is None


def test_the_entries_are_per_layer_metrics_of_the_benchmark():
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    names = {m["name"] for m in BENCHMARK["per_layer"]}
    for m in program_spans.ENTRIES:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["name"] not in names and (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["layer"] in layers and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_counter")
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in load_cell(cell).end_to_end}


def test_the_span_tracer_keeps_read_chrome_traces_keys(tmp_path):
    events = [_launch(0, 1), _x("kernel", "void k<float>(float*)", 10, 100, corr=1),
              _x("cuda_runtime", "cudaStreamSynchronize", 120, 40, MAIN),
              _x("gpu_memcpy", "Memcpy DtoH", 150, 20, corr=2)]
    fixture = tmp_path / "fixture.json"
    fixture.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write(fixture.read_text())

    tracer = program_spans.SpanTracer(True, 3.0, False)
    tracer.prof, tracer.window_s, tracer.ns0, tracer.ns1 = Prof(), 2e-4, BASE, BASE + 200_000
    tracer.read()
    want = read_chrome_trace(fixture, 2e-4)
    got = dict(tracer.result)
    new = got.pop("device_op_intervals")
    assert got == want
    assert new["base_ns"] == BASE and new["slice_ns"] == [BASE, BASE + 200_000]
    assert new["ops"] == [[10.0, 110.0, 0.0, 2.0, 1], [150.0, 170.0, None, None, 2]]
    assert new["anchors"] == []


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_the_tool_rehearses_each_cell(cell, record, capsys):
    from mcncrossmodalemotions_torch.utils import trace

    c = load_cell(cell, rehearse=True)
    cli.set_cache_dirs()
    res = program_spans.run(c, 3_000_000_019, 0.5, record, torch.device("cpu"),
                            True, time.perf_counter())
    assert res["correct"] and not trace.recording()
    assert set(res["metrics"]) == {m["name"] for m in program_spans.ENTRIES
                                   if cell in m["workloads"]}
    host_side = {m["name"] for m in program_spans.ENTRIES
                 if m["source"] == "program_counter" and cell in m["workloads"]}
    for name, value in res["metrics"].items():
        # no device operations on the CPU: the joined readers read nothing;
        # the host's read what lies outside the traced slice, if any does
        if name in host_side and record:
            assert value is None or value >= 0, name
        else:
            assert value is None, name
    json.dumps(res)


def test_the_recording_cost_study_rehearses(capsys):
    from perfbench import recording_cost
    from mcncrossmodalemotions_torch.utils import trace

    res = recording_cost.main(["--rounds", "2", "--steps", "1"], device="cpu", tiny=True)
    assert not trace.recording() and trace.snapshot()["spans"] == []
    for key in ("issue_ms", "step_ms"):
        assert len(res[key]["on"]) == len(res[key]["off"]) == 2
        assert 0 <= res[key]["pairs_on_slower"] <= 2
    assert res["device"] == "cpu" and res["cell"] == "distill"
    micro = json.loads(capsys.readouterr().out.splitlines()[0])["micro"]
    assert set(micro) == {"span_off_ns", "span_on_ns", "clock_read_ns"}
    res = recording_cost.main(["--cell", "dense", "--rounds", "1", "--seed", "3000000021"],
                              device="cpu", tiny=True)
    assert not trace.recording() and trace.snapshot()["spans"] == []
    for key in ("device_frames_per_s", "wall_frames_per_s"):
        assert len(res[key]["on"]) == 1 and res[key]["median_off"] > 0
