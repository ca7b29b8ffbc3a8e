"""Program spans, kept in memory, off by default.

A span is a named interval of one thread's work::

    from mcncrossmodalemotions_torch.utils import trace

    with trace.span("train.step", step=k):
        ...

While recording is off (the default) ``span`` returns one shared no-op
context, reads no clock and allocates nothing. Whoever measures turns
recording on (``enable()``) and reads it back (``snapshot()``): the
benchmark's traced runs, the training engine's profiled epoch, tests.
There is no environment variable or option that turns it on.

Each span records its name, its start and end in nanoseconds of
``time.time_ns()`` (CLOCK_REALTIME, the clock ``torch.profiler``'s Chrome
trace is written on: an event starts at ``baseTimeNanoseconds + ts``
microseconds), the index of its parent (the innermost span open on the
same thread when it opened, None at the top), the thread's native id and
its attributes (a step or batch number; children share it through the
parent chain). Spans live in one list of at most ``MAX_SPANS``; past the
cap a span is not kept and ``snapshot()["dropped"]`` counts it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

MAX_SPANS = 1_000_000

# a span's fields in ``snapshot()["spans"]``
NAME, START, END, PARENT, TID, ATTRS = range(6)

_NOOP = contextlib.nullcontext()


class Recorder:
    """One process's spans (the module's functions are one instance's
    methods)."""

    def __init__(self, cap: int = MAX_SPANS):
        self.on = False
        self.cap = cap
        self._spans: List[list] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording --------------------------------------------------------
    def span(self, name: str, **attrs):
        """A context manager around one span of this thread's work."""
        if not self.on:
            return _NOOP
        return _Span(self, name, attrs)

    def _stack(self) -> list:
        """This thread's open spans; its native id, read once (a system
        call), is ``self._local.tid``."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.tid = threading.get_native_id()
        return stack

    def open(self, name: str, attrs: Optional[dict] = None,
             start_ns: Optional[int] = None) -> Optional[int]:
        """Open a span on this thread; returns its index (None while off
        or past the cap). ``close`` may run in another call than ``open``,
        as the backward hooks of ``models/vggm.batch_norm_train`` do."""
        if not self.on:
            return None
        stack = self._stack()
        rec = [name, time.time_ns() if start_ns is None else start_ns, None,
               stack[-1] if stack else None, self._local.tid,
               attrs or {}]
        with self._lock:
            if len(self._spans) >= self.cap:
                self._dropped += 1
                return None
            idx = len(self._spans)
            self._spans.append(rec)
        stack.append(idx)
        return idx

    def close(self, idx: Optional[int], end_ns: Optional[int] = None) -> None:
        """Close the span ``open`` returned (None: nothing was opened)."""
        if idx is None:
            return
        self._spans[idx][END] = time.time_ns() if end_ns is None else end_ns
        stack = self._stack()
        if stack and stack[-1] == idx:
            stack.pop()
        elif idx in stack:  # spans of one thread that do not nest
            stack.remove(idx)

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A span timed by the caller (whose own sum it feeds), under the
        innermost span open on this thread."""
        self.close(self.open(name, attrs, start_ns), end_ns)

    # -- control ----------------------------------------------------------
    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def recording(self) -> bool:
        return self.on

    def reset(self) -> None:
        """Forget every span; call it with no span open (an index ``open``
        returned before it names nothing after it)."""
        with self._lock:
            self._spans = []
            self._dropped = 0
        self._local = threading.local()

    def snapshot(self) -> Dict[str, Any]:
        """A copy of what was recorded: ``spans`` (tuples of name, start
        and end ns, parent index, thread id, attributes; a span still open
        has end None), ``dropped`` (the spans past the cap) and
        ``main_tid`` (the main thread's native id)."""
        with self._lock:
            spans = [tuple(s) for s in self._spans]
            dropped = self._dropped
        return {"spans": spans, "dropped": dropped,
                "main_tid": threading.main_thread().native_id}


class _Span:
    __slots__ = ("rec", "name", "attrs", "idx")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.idx = self.rec.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc) -> None:
        self.rec.close(self.idx)


RECORDER = Recorder()
span = RECORDER.span
add = RECORDER.add
open_span = RECORDER.open
close_span = RECORDER.close
enable = RECORDER.enable
disable = RECORDER.disable
recording = RECORDER.recording
reset = RECORDER.reset
snapshot = RECORDER.snapshot


def chrome_events(spans, base_ns: int, pid: int, since_ns: int = 0) -> List[dict]:
    """``spans`` (``snapshot()["spans"]``) that closed and started at or
    after ``since_ns`` as Chrome-trace ``X`` events of category
    ``program``, in microseconds after ``base_ns`` (a ``torch.profiler``
    trace's ``baseTimeNanoseconds``), on their threads' rows."""
    return [{"ph": "X", "cat": "program", "name": s[NAME], "pid": pid,
             "tid": s[TID], "ts": (s[START] - base_ns) / 1000.0,
             "dur": (s[END] - s[START]) / 1000.0, "args": dict(s[ATTRS])}
            for s in spans if s[END] is not None and s[START] >= since_ns]
