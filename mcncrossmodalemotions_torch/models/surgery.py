"""Model surgery on ``state_dict``s (the DagNN graph-surgery equivalent).

Port of ``mcncrossmodalemotions_tpu/models/surgery.py`` onto the port's
``state_dict``s. The reference mutates loaded DAGs: strip loss layers,
resize and re-initialise the final classifier, keep the backbone
(emoVoxZoo.m prepareFromDagNN :187-253, ferPlusZoo.m :136-199). Models are
rebuilt from their config, so surgery reduces to operations on the weights:

- ``reinit_head``: a fresh head of ``num_outputs`` units, ``normal(scale)``
  with a zero bias, drawn from a ``torch.Generator`` seeded by ``seed``.
  Those values differ from the JAX package's ``jax.random`` draws for the
  same seed (a known difference of random draws, not a fault); the parity
  tests hand both packages the same head.
- ``transplant_backbone``: copy every tensor of a source into a target but
  the skipped modules', shape-checked.
- ``strip_collections``: keep the parameters and/or the BatchNorm running
  statistics (the Flax ``params`` and ``batch_stats`` collections).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

StateDict = Dict[str, torch.Tensor]
_BATCH_STATS = ("running_mean", "running_var", "num_batches_tracked")


def reinit_head(state: StateDict, num_outputs: int, seed: int,
                scale: float = 1e-4, head_name: str = "prediction") -> StateDict:
    """A new ``state_dict`` whose head (the ``<head_name>.weight`` /
    ``.bias`` entries, under any prefix) has ``num_outputs`` units, weights
    ``normal(0, scale)`` from ``torch.Generator().manual_seed(seed)`` and a
    zero bias. The head keeps its rank: a ``Linear`` ``[out, in]`` stays 2-D,
    a conv head ``[out, in, kh, kw]`` keeps its spatial axes (emoVoxZoo.m:
    210-243; the teachers use scale 1/100, ferPlusZoo.m:136-199)."""
    keys = [k for k in state if k.split(".")[-2:-1] == [head_name]]
    weight = [k for k in keys if k.endswith(".weight")]
    if len(weight) != 1:
        raise KeyError(f"no single {head_name!r} head in the state_dict "
                       f"(found {weight})")
    old = state[weight[0]]
    shape = (num_outputs,) + tuple(old.shape[1:])
    gen = torch.Generator().manual_seed(seed)
    out = dict(state)
    out[weight[0]] = scale * torch.randn(shape, generator=gen,
                                         dtype=torch.float32)
    bias = weight[0][:-len("weight")] + "bias"
    if bias in state:
        out[bias] = torch.zeros(num_outputs, dtype=torch.float32)
    return out


def transplant_backbone(target: StateDict, source: StateDict,
                        skip: Sequence[str] = ("prediction",)) -> StateDict:
    """``target`` with every tensor of ``source`` that it also holds copied
    in, except those of the modules named in ``skip`` (a component of the
    key). A shape mismatch raises ``ValueError``: the fine-tune pattern,
    pretrained backbone + fresh task head."""
    out = dict(target)
    for key, value in source.items():
        if any(name in key.split(".") for name in skip) or key not in target:
            continue
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(value.shape)} vs {tuple(target[key].shape)}")
        out[key] = value
    return out


def _collection(key: str) -> str:
    """The Flax collection of a ``state_dict`` key: ``'batch_stats'`` for a
    BatchNorm's running statistics, ``'params'`` for the rest."""
    return "batch_stats" if key.rsplit(".", 1)[-1] in _BATCH_STATS else "params"


def strip_collections(state: StateDict,
                      keep: Sequence[str] = ("params", "batch_stats")
                      ) -> StateDict:
    """The entries of the collections in ``keep`` (the strip-loss-layers
    analogue)."""
    return {k: v for k, v in state.items() if _collection(k) in keep}
