"""Config helpers: dataclass trees to plain dicts, and their stable hash.

The port's copy of ``to_dict`` and ``config_hash`` from
``mcncrossmodalemotions_tpu/utils/config.py``, so that an experiment
directory gets the same name in both packages
(``tests/test_torch_host_copies.py`` holds them equal).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
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
