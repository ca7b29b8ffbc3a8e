"""Config helpers: dotted-path overrides of dataclass trees (the
reference's ``vl_argparse``, run_distillation.m:71-90), the trees as plain
dicts and text, their stable hash, and a run's config read back from its
experiment directory.

The port's copy of ``override``, ``parse_overrides``, ``struct2str``,
``to_dict``, ``config_hash``, ``write_run_meta`` and
``read_latest_run_config`` from ``mcncrossmodalemotions_tpu/utils/config.py``,
so that one command line gives one config, and an experiment directory one
name, in both packages, and either package's run metadata reads back alike
(``tests/test_torch_host_copies.py``, ``tests/test_torch_run_distillation.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import time
from pathlib import Path
import typing
from typing import Any, Mapping


def is_config(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _coerce_by_annotation(value: str, annotation: Any) -> Any:
    """CLI-string coercion for a None-valued field, from its annotation:
    the Optional[...] fields whose default is None (use_bnorm, data_type,
    noise_dir, ...), so that ``use_bnorm=false`` stores False and not the
    truthy string 'false'. An annotation it cannot read keeps the string."""
    if isinstance(annotation, str):  # PEP 563 string annotations
        a = annotation.replace("typing.", "").replace(" ", "")
        if a.startswith("Optional[") and a.endswith("]"):
            a = a[len("Optional["):-1]
        a = a.removesuffix("|None").removeprefix("None|")
        base = {"bool": bool, "int": int, "float": float,
                "str": str}.get(a, annotation)
    else:
        args = [t for t in typing.get_args(annotation)
                if t is not type(None)]
        base = args[0] if len(args) == 1 else annotation
    if base is bool:
        return _coerce(value, False)
    if base is int:
        return int(value)
    if base is float:
        return float(value)
    return value


def _coerce(value: Any, target: Any, annotation: Any = None) -> Any:
    """Coerce ``value`` (possibly a CLI string) to the type of ``target``."""
    if value is None:
        return value
    if target is None:
        if isinstance(value, str) and annotation is not None:
            return _coerce_by_annotation(value, annotation)
        return value
    if isinstance(value, str) and not isinstance(target, str):
        if isinstance(target, bool):
            low = value.lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"cannot parse bool from {value!r}")
        if isinstance(target, int) and not isinstance(target, bool):
            return int(value)
        if isinstance(target, float):
            return float(value)
        if isinstance(target, (list, tuple)):
            parsed = json.loads(value)
            return type(target)(parsed)
        return value
    if isinstance(target, tuple) and isinstance(value, list):
        return tuple(value)
    return value


def override(cfg: Any, path: str, value: Any) -> Any:
    """A copy of dataclass tree ``cfg`` with the dotted field ``path`` (e.g.
    ``"train.batch_size"``, the reference's ``'train.batchSize'``,
    benchmark_ferplus_models.m:46-54) set to ``value``."""
    head, _, rest = path.partition(".")
    if not hasattr(cfg, head):
        raise AttributeError(
            f"{type(cfg).__name__} has no option {head!r} "
            f"(valid: {[f.name for f in dataclasses.fields(cfg)]})"
        )
    current = getattr(cfg, head)
    if rest:
        if not is_config(current):
            raise AttributeError(f"{head!r} is a leaf option; cannot descend into {rest!r}")
        new_value = override(current, rest, value)
    else:
        if is_config(current):
            new_value = value
        else:
            annotation = next(
                (f.type for f in dataclasses.fields(cfg) if f.name == head),
                None)
            new_value = _coerce(value, current, annotation)
    return dataclasses.replace(cfg, **{head: new_value})


def parse_overrides(cfg: Any, *args: str, **kwargs: Any) -> Any:
    """Apply overrides to a dataclass config tree: positional CLI-style
    ``"a.b=value"`` strings, then kwargs with ``__`` as the path separator
    (``train__batch_size=32``)."""
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override {arg!r} is not of the form path=value")
        path, _, value = arg.partition("=")
        cfg = override(cfg, path.strip(), value.strip())
    for key, value in kwargs.items():
        cfg = override(cfg, key.replace("__", "."), value)
    return cfg


def to_dict(cfg: Any) -> Any:
    """Recursively convert a dataclass config tree to plain dicts."""
    if is_config(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def struct2str(cfg: Any, indent: int = 0) -> str:
    """A config tree one ``key: value`` a line, nested trees indented
    (``third_party/struct2str.m``, run_distillation.m:233)."""
    d = to_dict(cfg) if is_config(cfg) else cfg
    lines = []
    pad = "  " * indent
    if isinstance(d, Mapping):
        for key, value in d.items():
            if isinstance(value, Mapping):
                lines.append(f"{pad}{key}:")
                lines.append(struct2str(value, indent + 1))
            else:
                lines.append(f"{pad}{key}: {value!r}")
    else:
        lines.append(f"{pad}{d!r}")
    return "\n".join(lines)


def config_hash(cfg: Any) -> str:
    """Stable short hash of a config tree, for experiment-dir naming
    (run_distillation.m:95-105 names the directory by hand; the hash keeps
    distinct configs from colliding)."""
    blob = json.dumps(to_dict(cfg), sort_keys=True, default=repr).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


def write_run_meta(exp_dir, cfg, **extra) -> str:
    """Run-metadata dump (storeMetaInfo, run_distillation.m:227-240): twin
    ``meta-<stamp>.json`` / ``.txt`` files with the full config, hostname,
    timestamp and ``extra`` keys. Returns the stamp."""
    exp_dir = Path(exp_dir)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    exp_dir.mkdir(parents=True, exist_ok=True)
    meta = {"config": to_dict(cfg), "hostname": platform.node(),
            "timestamp": stamp, **extra}
    (exp_dir / f"meta-{stamp}.json").write_text(json.dumps(meta, indent=2))
    (exp_dir / f"meta-{stamp}.txt").write_text(struct2str(cfg))
    return stamp


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
