"""Atomic epoch checkpoints with resume and best-epoch selection, PyTorch.

Port of ``mcncrossmodalemotions_tpu/train/checkpoints.py`` in the port's
own format: ``exp_dir/net-epoch-N.pt``, one ``torch.save`` of the model's
``state_dict``, the velocity, the step, the dropout generator's state and
the epoch record, written atomically (tmp file + ``os.replace``), with a
``net-epoch-N.json`` metrics sidecar. ``continue`` resume
(run_distillation.m:72,177-178) falls back past an unreadable latest
checkpoint to the last good one (the reference's corrupted-checkpoint
weakness, run_distillation.m:169); ``find_best_epoch`` is findBestEpoch
(ferplus_baselines.m:121-126). Loading the JAX package's msgpack
checkpoints is not ported.
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

_CKPT_RE = re.compile(r"net-epoch-(\d+)\.pt$")


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


def list_checkpoints(exp_dir: str | Path) -> list[Tuple[int, Path]]:
    exp_dir = Path(exp_dir)
    if not exp_dir.exists():
        return []
    found = []
    for p in exp_dir.iterdir():
        m = _CKPT_RE.fullmatch(p.name)
        if m and p.is_file():
            found.append((int(m.group(1)), p))
    return sorted(found)


def load_checkpoint(path: Path, state: TrainState) -> TrainState:
    """Restore ``path`` into ``state`` in place (model, velocity, step,
    generator) and return it. Unreadable bytes raise
    :class:`CorruptCheckpointError`; a checkpoint that does not fit the
    state raises the underlying error."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError,
            zipfile.BadZipFile) as exc:  # truncated/garbled bytes
        raise CorruptCheckpointError(f"{path}: {exc}") from exc
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
                    prune: bool = False) -> Optional[int]:
    """The epoch whose ``subset`` metrics optimise ``priority_metric``
    (``findBestEpoch``). With ``prune=True`` every other epoch's
    checkpoint and sidecar are deleted."""
    best_epoch, best_value = None, None
    ckpts = list_checkpoints(exp_dir)
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
