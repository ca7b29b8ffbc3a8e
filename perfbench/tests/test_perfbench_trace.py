"""The traced slice's reading: the device's busy time as the union of its
operations, idle gaps named by the host event they fall in, and work
timed apart from the window kept out of its wall."""

import json
import time

import pytest
import torch

from perfbench.harness import cli, host
from perfbench.harness.spec import load_cell
from perfbench.harness.trace import NO_HOST_EVENT, read_chrome_trace


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_time_is_the_union_and_gaps_are_named_by_runtime_calls(tmp_path):
    events = [  # out of order, as a trace may hold them
        _event("cuda_runtime", "cudaStreamSynchronize", 300, 150),
        _event("kernel", "void k<float>(float*)", 0, 100),
        _event("kernel", "void k<float>(float*)", 50, 100),
        _event("gpu_memcpy", "Memcpy HtoD", 400, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 0, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_chrome_trace(path, 1e-3)
    assert t["busy_s"] == pytest.approx(250e-6)
    assert t["kernels"]["k"] == {"seconds": pytest.approx(200e-6), "launches": 2}
    gaps = dict(t["idle_gaps"])
    # 150-400 is idle: its middle (275) lies in no runtime call
    assert gaps == {NO_HOST_EVENT: pytest.approx(250e-6)}


def test_a_gap_inside_a_runtime_call_takes_its_name(tmp_path):
    events = [_event("kernel", "a", 0, 10), _event("kernel", "b", 90, 10),
              _event("cuda_runtime", "cudaMemcpyAsync", 20, 70)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert dict(read_chrome_trace(path, 1e-4)["idle_gaps"]) == {
        "cudaMemcpyAsync": pytest.approx(80e-6)}


def test_host_usage_counts_this_process_cpu_time():
    a = host.snapshot()
    sum(i * i for i in range(2_000_000))
    b = host.snapshot()
    assert b["cpu"] > a["cpu"] and "cpu-s" in host.report(a, b)


def test_the_decoder_timed_alone_stays_out_of_the_window(monkeypatch):
    from mcncrossmodalemotions_torch.data import images
    from mcncrossmodalemotions_torch.exp import compute_visual_feats  # noqa: F401 (binds the decoder first)

    decode = images.load_frame_batch

    def slow(*args, **kwargs):
        time.sleep(2.0)
        return decode(*args, **kwargs)

    monkeypatch.setattr(images, "load_frame_batch", slow)
    c = load_cell("dense-senet50-jpeg-b128", rehearse=True)
    cli.set_cache_dirs()
    out = cli.execute(c, 11, 0.2, True, torch.device("cpu"), True, time.perf_counter())
    assert out["record"]["decode_frames_per_s"] > 0
    assert out["wall"] < 2.0  # the decoder alone sleeps 2 s a batch


def test_the_device_timer_counts_the_forwards_alone_and_unhooks():
    from perfbench.drivers.common import DeviceTimer

    class Slow(torch.nn.Module):
        def forward(self, x):
            time.sleep(0.05)
            return x + 1

    module = Slow()
    with DeviceTimer(module, torch.device("cpu")) as timer:
        for _ in range(3):
            module(torch.zeros(1))
            time.sleep(0.05)  # between the calls: not timed
    module(torch.zeros(1))  # after the window: not timed
    assert len(timer.spans) == 3
    assert 0.15 <= timer.seconds() < 0.25
    assert not module._forward_hooks and not module._forward_pre_hooks


def test_a_device_clock_metric_is_the_work_over_the_device_time():
    c = load_cell("dense-senet50-jpeg-b128", rehearse=True)
    cli.set_cache_dirs()
    out = cli.execute(c, 12, 0.2, False, torch.device("cpu"), True, time.perf_counter())
    res = cli.result_line(c, out, False, torch.device("cpu"), 1)
    (name,) = [m["name"] for m in c.end_to_end if m["source"] == "device_trace"]
    assert 0 < out["win"]["device_s"] < out["wall"]
    assert res["metrics"][name]["value"] == out["win"]["count"] / out["win"]["device_s"]
