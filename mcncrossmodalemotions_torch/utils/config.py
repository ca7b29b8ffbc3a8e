"""Config helpers: dataclass trees to plain dicts, their stable hash, and
a run's config read back from its experiment directory.

The port's copy of ``to_dict``, ``config_hash`` and
``read_latest_run_config`` from ``mcncrossmodalemotions_tpu/utils/config.py``,
so that an experiment directory gets the same name in both packages and
either package's run metadata reads back alike
(``tests/test_torch_host_copies.py``, ``tests/test_torch_run_distillation.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any


def is_config(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def to_dict(cfg: Any) -> Any:
    """Recursively convert a dataclass config tree to plain dicts."""
    if is_config(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def config_hash(cfg: Any) -> str:
    """Stable short hash of a config tree, for experiment-dir naming
    (run_distillation.m:95-105 names the directory by hand; the hash keeps
    distinct configs from colliding)."""
    blob = json.dumps(to_dict(cfg), sort_keys=True, default=repr).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


def read_latest_run_config(exp_dir, config_cls):
    """Rebuild a run's config dataclass from its newest meta dump.

    Unknown keys are dropped (forward compatibility) and JSON lists are
    coerced back to tuples for tuple-defaulted fields. Raises
    FileNotFoundError when the directory carries no meta dump."""
    exp_dir = Path(exp_dir)
    metas = sorted(exp_dir.glob("meta-*.json"))
    if not metas:
        raise FileNotFoundError(
            f"no meta-*.json in {exp_dir} — not a {config_cls.__name__} "
            "experiment directory (meta dumps ship with every training "
            "run)")
    cfg_dict = json.loads(metas[-1].read_text())["config"]
    fields = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg_dict.items() if k in fields})
