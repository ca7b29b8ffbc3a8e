"""Progress/ETA logging and the JSONL metrics log (zsvision ``zs_eta``).

The port's copy of ``Eta``, ``progress`` and ``MetricsLogger`` from
``mcncrossmodalemotions_tpu/utils/logging.py``: the same lines, so that
both packages' logs and ``metrics.jsonl`` files read alike
(``tests/test_torch_host_copies.py`` holds them equal).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


class Eta:
    """Throughput + ETA tracker for long loops
    (compute_audio_feats.m:117-132)."""

    def __init__(self, total: int, name: str = "", log_every: int = 50, file=None):
        self.total = total
        self.name = name
        self.log_every = max(1, log_every)
        self.start = time.monotonic()
        self.count = 0
        self.file = file or sys.stderr

    def tick(self, n: int = 1) -> None:
        self.count += n
        if self.count % self.log_every == 0 or self.count >= self.total:
            elapsed = time.monotonic() - self.start
            hz = self.count / max(elapsed, 1e-9)
            remaining = (self.total - self.count) / max(hz, 1e-9)
            print(
                f"[{self.name}] {self.count}/{self.total} "
                f"({hz:.1f} Hz, ETA {remaining:.0f}s)",
                file=self.file,
                flush=True,
            )


def progress(items: Iterable[T], total: Optional[int] = None, name: str = "",
             log_every: int = 50) -> Iterator[T]:
    """Wrap an iterable with ETA logging (``Eta`` on stderr); without
    ``total`` the items are listed first to count them."""
    seq = list(items) if total is None else items
    total = total if total is not None else len(seq)  # type: ignore[arg-type]
    eta = Eta(total, name=name, log_every=log_every)
    for item in seq:
        yield item
        eta.tick()


class MetricsLogger:
    """Append-only JSONL metrics log, one record per epoch
    (run_distillation.m:186-207 prints the same statistics)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        with self.path.open() as f:
            return [json.loads(line) for line in f if line.strip()]
