"""Atomic epoch checkpoints with resume and best-epoch selection, PyTorch.

Port of ``mcncrossmodalemotions_tpu/train/checkpoints.py`` in the port's
own format: ``exp_dir/net-epoch-N.pt``, one ``torch.save`` of the model's
``state_dict``, the velocity, the step, the dropout generator's state and
the epoch record, written atomically (tmp file + ``os.replace``), with a
``net-epoch-N.json`` metrics sidecar. ``continue`` resume
(run_distillation.m:72,177-178) falls back past an unreadable latest
checkpoint to the last good one (the reference's corrupted-checkpoint
weakness, run_distillation.m:169); ``find_best_epoch`` is findBestEpoch
(ferplus_baselines.m:121-126).

The JAX package's own checkpoints (``net-epoch-N.msgpack``, flax
serialization of its ``TrainState``) are read by ``load_flax_checkpoint``
with the port's msgpack reader (``utils/msgpack_lite.py``) and mapped
through the weight bridge into the same record a ``.pt`` checkpoint holds;
``read_from_exp`` takes either kind of experiment directory.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from mcncrossmodalemotions_torch.train.state import TrainState
from mcncrossmodalemotions_torch.utils import msgpack_lite
from mcncrossmodalemotions_torch.zoo.bridge import (
    student_params_from_flax,
    student_state_dict_from_flax,
)

PORT_SUFFIX = ".pt"
FLAX_SUFFIX = ".msgpack"  # the JAX package's checkpoints


class CorruptCheckpointError(Exception):
    """The checkpoint's BYTES are unreadable (truncated write, disk
    corruption): the case ``load_latest`` falls back from. A readable
    checkpoint that does not fit the state (a changed model config) is not
    this error and propagates: silently restarting a changed run from
    epoch 1 would clobber the old experiment."""


def checkpoint_path(exp_dir: str | Path, epoch: int) -> Path:
    return Path(exp_dir) / f"net-epoch-{epoch}.pt"


def save_checkpoint(exp_dir: str | Path, epoch: int, state: TrainState,
                    metrics: Optional[dict] = None) -> Path:
    """Atomically write the epoch checkpoint (tmp + rename) and the
    metrics sidecar."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint_path(exp_dir, epoch)
    record = (None if metrics is None
              else json.loads(json.dumps(metrics, default=float)))
    blob = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "velocity": {k: v.detach().cpu() for k, v in state.velocity.items()},
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "record": record,
    }
    # pid-suffixed tmp: two processes saving the same epoch must not
    # interleave through one tmp file
    tmp = path.with_suffix(f".tmp.{os.getpid()}")
    torch.save(blob, tmp)
    os.replace(tmp, path)  # atomic on POSIX
    if record is not None:
        mpath = exp_dir / f"net-epoch-{epoch}.json"
        mtmp = mpath.with_suffix(f".json.tmp.{os.getpid()}")
        mtmp.write_text(json.dumps(record))
        os.replace(mtmp, mpath)
    return path


def list_checkpoints(exp_dir: str | Path,
                     suffix: str = PORT_SUFFIX) -> list[Tuple[int, Path]]:
    """(epoch, path) of every ``net-epoch-N<suffix>`` file, by epoch: the
    port's ``.pt`` checkpoints, or the JAX package's with ``FLAX_SUFFIX``."""
    exp_dir = Path(exp_dir)
    if not exp_dir.exists():
        return []
    pattern = re.compile(r"net-epoch-(\d+)" + re.escape(suffix))
    found = []
    for p in exp_dir.iterdir():
        m = pattern.fullmatch(p.name)
        if m and p.is_file():
            found.append((int(m.group(1)), p))
    return sorted(found)


def read_checkpoint(path: Path) -> dict:
    """The record of a ``.pt`` checkpoint: ``model`` (the ``state_dict``),
    ``velocity``, ``step``, ``generator`` and ``record``, on the CPU.
    Unreadable bytes raise :class:`CorruptCheckpointError`."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError,
            zipfile.BadZipFile) as exc:  # truncated/garbled bytes
        raise CorruptCheckpointError(f"{path}: {exc}") from exc


def load_flax_checkpoint(path: str | Path) -> dict:
    """Read the JAX package's ``net-epoch-N.msgpack`` (its ``TrainState``:
    params, ``model_state`` with the batch statistics, velocity, step,
    rng) into the port's record: ``model``, the ``state_dict`` of the
    student or pipeline the params describe (``zoo/bridge.py``),
    ``velocity`` under the port's parameter names, and ``step``. Every
    tensor is the file's float32 values bit for bit (a bfloat16 leaf
    widened exactly). Unreadable or truncated bytes raise
    :class:`CorruptCheckpointError`; a tree that is not a student's
    raises ``KeyError``."""
    try:
        tree = msgpack_lite.unpackb(Path(path).read_bytes())
    except msgpack_lite.MsgpackError as exc:
        raise CorruptCheckpointError(f"{path}: {exc}") from exc
    if not (isinstance(tree, dict)
            and {"params", "velocity", "step"} <= set(tree)):
        raise KeyError(f"{path}: not a TrainState (keys "
                       f"{sorted(tree) if isinstance(tree, dict) else type(tree)})")
    model_state = tree.get("model_state") or {}
    variables = {"params": tree["params"], **model_state}
    return {"model": student_state_dict_from_flax(variables),
            "velocity": student_params_from_flax(tree["velocity"]),
            "step": int(tree["step"])}


def read_from_exp(exp_dir: str | Path,
                  epoch: int | str | None = None) -> Tuple[int, dict]:
    """(epoch, record) of one checkpoint of an experiment directory: the
    port's ``.pt`` ones, or, where there are none, the JAX package's
    ``.msgpack`` ones (``load_flax_checkpoint``). ``epoch`` None takes the
    latest readable one (last-good fallback), ``'best'`` the
    ``find_best_epoch`` pick, an int that epoch. Raises
    ``FileNotFoundError`` when nothing fits."""
    suffix = PORT_SUFFIX if list_checkpoints(exp_dir) else FLAX_SUFFIX
    read = read_checkpoint if suffix == PORT_SUFFIX else load_flax_checkpoint
    ckpts = list_checkpoints(exp_dir, suffix)
    if epoch == "best":
        epoch = find_best_epoch(exp_dir, suffix=suffix)
        if epoch is None:
            raise FileNotFoundError(f"no epoch metrics in {exp_dir}")
    if epoch is None:
        for found, path in reversed(ckpts):
            try:
                return found, read(path)
            except CorruptCheckpointError as exc:  # corrupted: try older
                print(f"warning: checkpoint {path} unreadable ({exc}); "
                      "falling back")
        raise FileNotFoundError(f"no readable checkpoint in {exp_dir}")
    path = dict(ckpts).get(int(epoch))
    if path is None:
        raise FileNotFoundError(
            f"no checkpoint for epoch {epoch} in {exp_dir} (found epochs "
            f"{[e for e, _ in ckpts]})")
    return int(epoch), read(path)


def load_checkpoint(path: Path, state: TrainState) -> TrainState:
    """Restore ``path`` into ``state`` in place (model, velocity, step,
    generator) and return it. Unreadable bytes raise
    :class:`CorruptCheckpointError`; a checkpoint that does not fit the
    state raises the underlying error."""
    blob = read_checkpoint(path)
    state.model.load_state_dict(blob["model"], strict=True)
    if set(blob["velocity"]) != set(state.velocity):
        raise KeyError(f"{path}: velocity keys differ from the model's "
                       "parameters")
    with torch.no_grad():  # in place: the state's tensors stay where they are
        for name, v in state.velocity.items():
            v.copy_(blob["velocity"][name])
    state.step = int(blob["step"])
    state.generator.set_state(blob["generator"])
    return state


def load_latest(exp_dir: str | Path, state: TrainState) -> Tuple[int, TrainState]:
    """Resume from the newest READABLE checkpoint (last-good fallback).

    Returns (epoch, state); (0, state) untouched if none exists. Only
    byte-level corruption falls back to an older checkpoint."""
    for epoch, path in reversed(list_checkpoints(exp_dir)):
        try:
            return epoch, load_checkpoint(path, state)
        except CorruptCheckpointError as exc:  # corrupted: try older
            print(f"warning: checkpoint {path} unreadable ({exc}); falling back")
    return 0, state


def find_best_epoch(exp_dir: str | Path, priority_metric: str = "classerror",
                    mode: str = "min", subset: str = "val",
                    prune: bool = False,
                    suffix: str = PORT_SUFFIX) -> Optional[int]:
    """The epoch whose ``subset`` metrics optimise ``priority_metric``
    (``findBestEpoch``) among the ``net-epoch-N<suffix>`` checkpoints.
    With ``prune=True`` every other epoch's checkpoint and sidecar are
    deleted."""
    best_epoch, best_value = None, None
    ckpts = list_checkpoints(exp_dir, suffix)
    for epoch, path in ckpts:
        mpath = path.with_suffix(".json")
        if not mpath.exists():
            continue
        value = json.loads(mpath.read_text()).get(subset, {}).get(priority_metric)
        if value is None:
            continue
        if best_value is None or (value < best_value if mode == "min"
                                  else value > best_value):
            best_epoch, best_value = epoch, value
    if prune and best_epoch is not None:
        for epoch, path in ckpts:
            if epoch != best_epoch:
                path.unlink(missing_ok=True)
                path.with_suffix(".json").unlink(missing_ok=True)
    return best_epoch
