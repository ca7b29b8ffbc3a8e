"""The cells the tests drive: those of ``BENCHMARK.json`` and those left
out of it (``left_out.json``: cells whose driver, readers and limits are
kept and proved, but whose runs on the card spread too widely for any
bound; their entries are ready to list once they hold one)."""

import json
from pathlib import Path

from perfbench.harness.spec import ROOT, load_cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
LEFT_OUT = json.loads(Path(__file__).with_name("left_out.json").read_text())
MERGED = {k: v + LEFT_OUT.get(k, []) if isinstance(v, list) else v
          for k, v in BENCHMARK.items()}
CELLS = [w["name"] for w in MERGED["workloads"]]


def load(name: str, rehearse: bool = False):
    return load_cell(name, rehearse=rehearse, bench=MERGED)
