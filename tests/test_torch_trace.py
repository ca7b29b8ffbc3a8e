"""The port's spans (``utils/trace.py``) on the CPU, and the
spans the training engine, the train step, the masked BatchNorm and the
dense extractor record.

- Off (the default) ``span`` hands back one shared no-op context and
  nothing is recorded; on, spans nest by thread with their parents'
  indices, every thread's spans are kept whole, and past the cap a span
  is dropped and counted.
- The clock is ``torch.profiler``'s: a span and a ``record_function``
  around the same operation start within 1 ms on the trace's
  ``baseTimeNanoseconds + ts``.
- ``run_epoch`` records one ``train.step`` a batch with its forward,
  loss, backward and SGD children, and ``feed_wait_s`` is the sum of its
  ``train.feed_wait`` spans; the student's and a tiny SENet's gradients
  and running statistics are bitwise those of a run that does not
  record, with one ``vggm.bn.backward`` span a BatchNorm a step (remat
  too); ``frame_logits`` records each ``visual.*`` span once a batch; the
  profiled epoch's ``trace.json`` holds the program's spans on its own
  time base.
"""

import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.data.images import save_synthetic_frame
from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
    VisualFeatureExtractor,
)
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.train import engine
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.utils import trace
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    build_teacher,
    student_loss_fn,
)

NAME, START, END, PARENT, TID, ATTRS = range(6)


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _names(spans):
    return [s[NAME] for s in spans]


def _children(spans, idx):
    return [s[NAME] for s in spans if s[PARENT] == idx]


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not trace.recording()
    first = trace.span("a", step=1)
    assert first is trace.span("b") and first is trace._NOOP
    with first:
        with trace.span("c"):
            pass
    trace.add("d", 1, 2)
    assert trace.open_span("e") is None
    trace.close_span(None)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0


def test_spans_nest_with_parents_attributes_and_times():
    trace.enable()
    t0 = time.time_ns()
    with trace.span("outer", step=7):
        with trace.span("inner"):
            pass
        with trace.span("second"):
            trace.add("timed", 10, 20, batch=3)
    t1 = time.time_ns()
    spans = trace.snapshot()["spans"]
    assert _names(spans) == ["outer", "inner", "second", "timed"]
    assert [s[PARENT] for s in spans] == [None, 0, 0, 2]
    assert spans[0][ATTRS] == {"step": 7} and spans[3][ATTRS] == {"batch": 3}
    assert spans[3][START:END + 1] == (10, 20)
    for s in spans[:3]:
        assert t0 <= s[START] <= s[END] <= t1
    assert spans[0][START] <= spans[1][START] and spans[1][END] <= spans[0][END]
    assert {s[TID] for s in spans} == {threading.get_native_id()}


def test_threads_keep_their_own_parents():
    trace.enable()
    done = threading.Event()

    def work():
        with trace.span("worker.outer"):
            with trace.span("worker.inner"):
                pass
        done.set()

    with trace.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and done.is_set()
    snap = trace.snapshot()
    spans = {s[NAME]: (i, s) for i, s in enumerate(snap["spans"])}
    assert spans["worker.outer"][1][PARENT] is None  # not under "main"
    assert spans["worker.inner"][1][PARENT] == spans["worker.outer"][0]
    assert spans["worker.outer"][1][TID] == t.native_id
    assert spans["main"][1][TID] == snap["main_tid"] == threading.get_native_id()


def test_spans_of_many_threads_are_kept_whole():
    """16 threads that switch every microsecond each record 500 pairs of
    nested spans: every one is kept, under its own thread's parent."""
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for k in range(500):
            with trace.span("outer", k=k):
                with trace.span("inner"):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = trace.snapshot()
    spans = snap["spans"]
    assert len(spans) == 16 * 500 * 2 and snap["dropped"] == 0
    for s in spans:
        if s[NAME] == "inner":
            parent = spans[s[PARENT]]
            assert parent[NAME] == "outer" and parent[TID] == s[TID]
        else:
            assert s[PARENT] is None
    assert len({s[TID] for s in spans}) == 16


def test_the_cap_drops_and_counts():
    rec = trace.Recorder(cap=3)
    rec.enable()
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    snap = rec.snapshot()
    assert _names(snap["spans"]) == ["s0", "s1", "s2"]
    assert snap["dropped"] == 2
    assert trace.MAX_SPANS == 1_000_000


def test_spans_that_do_not_nest_close_in_any_order():
    trace.enable()
    a = trace.open_span("a")
    b = trace.open_span("b")
    trace.close_span(a)
    with trace.span("c"):
        pass
    trace.close_span(b)
    spans = trace.snapshot()["spans"]
    assert [s[PARENT] for s in spans] == [None, 0, 1]
    assert all(s[END] is not None for s in spans)


def test_disable_keeps_and_reset_forgets():
    trace.enable()
    with trace.span("kept"):
        pass
    trace.disable()
    with trace.span("not kept"):
        pass
    assert _names(trace.snapshot()["spans"]) == ["kept"]
    rec = trace.Recorder(cap=1)
    rec.enable()
    for name in ("a", "b"):
        with rec.span(name):
            pass
    assert rec.snapshot()["dropped"] == 1
    trace.reset()
    rec.reset()
    assert trace.snapshot()["spans"] == [] and rec.snapshot()["dropped"] == 0


def test_chrome_events_rebase_closed_spans():
    spans = [("a", 5_000_000, 7_500_000, None, 11, {"step": 2}),
             ("open", 6_000_000, None, 0, 11, {}),
             ("early", 1_000_000, 2_000_000, None, 12, {})]
    events = trace.chrome_events(spans, base_ns=4_000_000, pid=3,
                                 since_ns=3_000_000)
    assert events == [{"ph": "X", "cat": "program", "name": "a", "pid": 3,
                       "tid": 11, "ts": 1000.0, "dur": 2500.0,
                       "args": {"step": 2}}]


def test_the_clock_is_the_profilers():
    """A span and a ``record_function`` around the same operation start
    within 1 ms on the Chrome trace's ``baseTimeNanoseconds + ts``."""
    trace.enable()
    x = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("probe"):
            with torch.profiler.record_function("probe_rf"):
                torch.mm(x, x)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "t.json"
        prof.export_chrome_trace(str(path))
        trace_file = json.loads(path.read_text())
    base = int(trace_file.get("baseTimeNanoseconds", 0))
    rf = next(e for e in trace_file["traceEvents"] if e.get("name") == "probe_rf")
    span = trace.snapshot()["spans"][0]
    start_ns = base + rf["ts"] * 1000.0
    assert abs(start_ns - span[START]) < 1e6, (start_ns, span[START])
    assert rf["tid"] == span[TID]


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 8)

    def reset_parameters(self, generator=None):
        torch.nn.init.normal_(self.fc.weight, 0.0, 0.1, generator=generator)
        torch.nn.init.zeros_(self.fc.bias)

    def forward(self, x, train=False, pad_mask=None, use_kernels=True,
                generator=None):
        return self.fc(x.float())


def _batches(n_batches, bsz=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(bsz, 4).astype(np.float32),
             "logit_target": rng.randn(bsz, 8).astype(np.float32),
             "max_label": rng.randint(0, 8, bsz).astype(np.int32)}
            for _ in range(n_batches)]


def _trainer(tmp_path, **cfg):
    cfg = engine.TrainConfig(exp_dir=str(tmp_path), learning_rate=0.1,
                             log_every=100, **cfg)
    return engine.Trainer(_Linear(), student_loss_fn(), cfg,
                          class_names=tuple("abcdefgh"), device="cpu")


def test_run_epoch_records_a_step_tree_a_batch(tmp_path):
    trainer = _trainer(tmp_path)
    state = trainer.init_state()
    trace.enable()
    state, stats = trainer.run_epoch(state, _batches(4), 1)
    snap = trace.snapshot()
    spans = snap["spans"]
    steps = [i for i, s in enumerate(spans) if s[NAME] == "train.step"]
    assert [spans[i][ATTRS]["step"] for i in steps] == [0, 1, 2, 3]
    for i in steps:
        assert _children(spans, i) == ["train.forward", "train.loss",
                                       "train.backward", "train.sgd"]
    waits = [s for s in spans if s[NAME] == "train.feed_wait"]
    assert len(waits) == 5  # four batches and the end of the feed
    assert stats["feed_wait_s"] == round(
        sum(s[END] - s[START] for s in waits) / 1e9, 3)
    assert _names(spans).count("train.metrics") == 4
    assert _names(spans).count("train.drain") == 1
    assert all(s[PARENT] is None for s in spans if s[NAME] in (
        "train.step", "train.feed_wait", "train.drain"))


def _student_state():
    model = build_student(tiny=True, dropout=0.5, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(0))
    return tstate.TrainState.create(model.double(),
                                    torch.Generator().manual_seed(3))


def _senet_state():
    teacher = FaceTeacherPipeline(
        build_teacher("senet50-ferplus", tiny=True), input_size=48,
        augment=False)
    teacher.reset_parameters(torch.Generator().manual_seed(2))
    teacher.teacher.dtype = torch.float64
    return tstate.TrainState.create(teacher.double(),
                                    torch.Generator().manual_seed(3))


def _batch(senet: bool):
    gen = torch.Generator().manual_seed(1)
    data = (torch.randint(0, 256, (4, 48, 48, 1), generator=gen,
                          dtype=torch.uint8) if senet else
            (torch.randn(4, 16384, generator=gen) * 3000).to(torch.int16))
    return {"data": data,
            "logit_target": torch.randn(4, 8, generator=gen,
                                        dtype=torch.float64) * 2,
            "max_label": torch.tensor([1, 5, 2, 7], dtype=torch.int32),
            "label_dist": torch.softmax(torch.randn(4, 8, generator=gen,
                                                    dtype=torch.float64), -1),
            "pad_mask": torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float64)}


def _steps(kind: str, record: bool):
    senet = kind == "senet"
    loss = (student_loss_fn("hot-cross-ent", temperature=2.0) if not senet
            else student_loss_fn("hot-cross-ent", temperature=1.0))
    step = tstate.make_train_step(
        loss, tstate.SGDConfig(weight_decay=5e-4), pass_pad_mask=True,
        remat_policy="nothing" if kind == "student-remat" else None)
    state = _senet_state() if senet else _student_state()
    batch = _batch(senet)
    if record:
        trace.enable()
    for lr in (1e-2, 5e-3):
        state, _ = step(state, batch, lr)
    trace.disable()
    return state


@pytest.mark.parametrize("kind", ["student", "student-remat", "senet"])
def test_recording_leaves_the_step_bitwise_and_times_each_bn_backward(kind):
    off = _steps(kind, record=False)
    on = _steps(kind, record=True)
    for k, v in off.model.state_dict().items():  # running statistics too
        assert torch.equal(on.model.state_dict()[k], v), k
    for k, v in off.velocity.items():
        assert torch.equal(on.velocity[k], v), k
    spans = trace.snapshot()["spans"]
    n_bn = sum(1 for name, _ in off.model.named_modules()
               if isinstance(_, torch.nn.BatchNorm2d))
    backward = [s for s in spans if s[NAME] == "vggm.bn.backward"]
    assert n_bn > 0 and len(backward) == 2 * n_bn
    assert all(s[END] is not None and s[END] >= s[START] for s in spans)
    # on the CPU the backward runs on the caller's thread, in train.backward
    for s in backward:
        assert spans[s[PARENT]][NAME] == "train.backward"
    forwards = [s for s in spans if s[NAME] == "vggm.bn"]
    assert len(forwards) >= 2 * n_bn  # and again where remat recomputes


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    paths = []
    for k in range(5):
        p = root / f"{k:05d}.jpg"
        save_synthetic_frame(p, k % 3, size=64, seed=k)
        paths.append(str(p))
    return paths


def test_frame_logits_records_each_visual_span_once_a_batch(frames):
    pipeline = FaceTeacherPipeline(build_teacher("senet50-ferplus", tiny=True),
                                   input_size=48, augment=False)
    pipeline.reset_parameters(torch.Generator().manual_seed(2))
    pipeline.eval()
    ex = VisualFeatureExtractor(pipeline, pipeline.state_dict(), batch_size=2,
                                num_threads=1, input_size=48, device="cpu")
    want = ex.frame_logits(frames, verbose=False)
    trace.enable()
    got = ex.frame_logits(frames, verbose=False)
    snap = trace.snapshot()
    np.testing.assert_array_equal(got, want)
    names = _names(snap["spans"])
    for name in ("visual.decode_wait", "visual.decode", "visual.h2d",
                 "visual.forward", "visual.read"):
        assert names.count(name) == 3, name  # batches of 2, 2 and 1
    decode_tids = {s[TID] for s in snap["spans"] if s[NAME] == "visual.decode"}
    assert decode_tids and snap["main_tid"] not in decode_tids


def test_the_profiled_epoch_writes_the_program_spans_on_its_base(tmp_path):
    trainer = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"))
    state = trainer.init_state()
    trainer.run_epoch(state, _batches(3), 1)
    assert not trace.recording()  # on for the profiled epoch only
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    program = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert [e["name"] for e in program].count("train.step") == 3
    assert {e["name"] for e in program} >= {
        "train.feed_wait", "train.forward", "train.loss", "train.backward",
        "train.sgd", "train.metrics"}  # the profiler ends with the loop
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e.get("name") == "aten::addmm"]
    steps = [e for e in program if e["name"] == "train.forward"]
    assert len(ops) >= 3
    # each step's linear layer runs inside a forward span, on one clock
    for op in ops[:3]:
        assert any(s["ts"] <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"]
                   for s in steps), op
    # a later epoch without the profiler records nothing
    trainer.run_epoch(state, _batches(2), 2)
    assert len(trace.snapshot()["spans"]) == len(program)
