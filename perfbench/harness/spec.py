"""A cell's files, found by name: the cell's entry and metrics in
``BENCHMARK.json``, ``workloads/<cell>.json`` (driver, options, limits of
the numbers compared), ``configs/<config>.json`` and
``traffic/mixes/<traffic>.json``."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _read(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def metric(self) -> dict:
        """The cell's end-to-end metric besides ``setup_s``."""
        return next(m for m in self.end_to_end if m["name"] != "setup_s")


def load_cell(name: str, rehearse: bool = False, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json``);
    ``rehearse`` applies the workload's ``rehearse`` overrides (tiny
    widths and data for a CPU rehearsal)."""
    if bench is None:
        bench = _read(ROOT / "BENCHMARK.json", "BENCHMARK.json")
    workload = _read(BENCH / "workloads" / f"{name}.json", f"workload {name!r}")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    config = _read(BENCH / "configs" / f"{entry['config']}.json",
                   f"config {entry['config']!r}")
    mix = _read(BENCH / "traffic" / "mixes" / f"{entry['traffic']}.json",
                f"traffic {entry['traffic']!r}")
    if rehearse:
        over = workload.get("rehearse", {})
        config = _merge(config, over.get("config", {}))
        mix = _merge(mix, over.get("traffic", {}))
        workload = _merge(workload, over.get("workload", {}))
    return Cell(name=name, chips=int(entry["chips"]), config=config, mix=mix,
                workload=workload, end_to_end=e2e, per_layer=per_layer)


def driver(name: str) -> ModuleType:
    return load_module(BENCH / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def metric_reader(name: str) -> ModuleType:
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} ({path})")
    return load_module(path, "perfbench_metric_" + name.replace(".", "_"))
