"""Train state + SGD-momentum step (cnn_train_dag's inner loop), PyTorch.

Port of ``mcncrossmodalemotions_tpu/train/state.py``. The reference's
update rule (MatConvNet cnn_train_dag, run_distillation.m:170-182):

    momentum <- m * momentum - lr * (grad + weight_decay * param)
    param    <- param + momentum

written out by hand (``apply_sgd_update``). ``torch.optim.SGD`` is not
this rule: it keeps ``m * buf + grad`` and multiplies by lr at the update,
so its trajectory drifts from the reference whenever lr changes, and the
logspace schedule changes lr every epoch.

The state is a plain dataclass around the model (parameters and BatchNorm
running statistics live in it), the velocity (one tensor per parameter,
keyed by ``named_parameters`` name), the step count and the
``torch.Generator`` that dropout draws from. A step updates all of them in
place and returns the same state object.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """Optimizer hyperparameters (cnn_train_dag defaults)."""

    momentum: float = 0.9
    weight_decay: float = 5e-4


@dataclasses.dataclass
class TrainState:
    """Model (parameters + running statistics), velocity, step, generator."""

    model: nn.Module
    velocity: Dict[str, torch.Tensor]
    step: int
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, generator: torch.Generator) -> "TrainState":
        velocity = {name: torch.zeros_like(p)
                    for name, p in model.named_parameters()}
        return cls(model=model, velocity=velocity, step=0, generator=generator)


# A LossFn maps (model outputs, batch dict) -> (scalar loss, metrics dict).
LossFn = Callable[[Any, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def finetune_lr_scale_fn(head_names: Tuple[str, ...] = ("prediction",),
                         backbone_scale: float = 0.1) -> Callable:
    """Per-parameter LR multiplier for fine-tuning (``finetuneLR``,
    ferPlusZoo.m:236-237): 1.0 for head parameters, ``backbone_scale``
    for the rest. The returned function maps a parameter path (tuple of
    str, e.g. ``('net', 'prediction', 'weight')``) to its multiplier."""

    def scale(path: Tuple[str, ...]) -> float:
        return 1.0 if any(h in path for h in head_names) else backbone_scale

    return scale


def apply_sgd_update(state: TrainState, grads: Dict[str, torch.Tensor], lr,
                     sgd: SGDConfig = SGDConfig(),
                     lr_scale_fn: Optional[Callable] = None) -> None:
    """MatConvNet SGD+momentum on the state's parameters and velocity."""
    # in place, under no_grad: the parameters and velocity are updated
    # where they live, as the functional JAX update rebuilds them
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            scale = 1.0 if lr_scale_fn is None else float(
                lr_scale_fn(tuple(name.split("."))))
            g = grads[name].float()
            v = state.velocity[name]
            v.mul_(sgd.momentum).sub_((lr * scale) * (g + sgd.weight_decay * p))
            p.add_(v)


def resolve_remat_policy(name: Optional[str]) -> None:
    """Rematerialisation is not ported: only ``None``/``'none'`` pass."""
    if name is not None and name != "none":
        raise NotImplementedError(
            f"remat policy {name!r}: rematerialisation is not ported to the "
            "PyTorch package yet (the JAX package's jax.checkpoint policies "
            "have no counterpart here)")


def make_train_step(loss_fn: LossFn, sgd: SGDConfig = SGDConfig(),
                    lr_scale_fn: Optional[Callable] = None,
                    remat_policy: Optional[str] = None,
                    pass_pad_mask: bool = False,
                    use_kernels: bool = True):
    """Build ``step(state, batch, lr) -> (state, metrics)``.

    The batch dict holds at least ``data``; the loss reads
    ``logit_target``, ``max_label``, ``hard_label``, ``label_dist``,
    ``pad_mask`` and ``instance_weights`` as it needs them. The model gets
    ``train=True`` and, of ``generator`` (``state.generator``: dropout,
    the teachers' fliplr), ``use_kernels`` and ``pad_mask``, those its
    forward accepts. ``pass_pad_mask`` gives ``batch['pad_mask']`` (when
    present), so train-mode BatchNorm statistics exclude padded rows.
    ``use_kernels`` runs the frontend and pool1/pool2 through the kernels
    on the card (False: their plain versions). ``lr_scale_fn`` maps a
    parameter's name split at the dots to its learning-rate multiplier.
    ``lr`` is a Python float, which may change every call.
    """
    resolve_remat_policy(remat_policy)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        model = state.model
        # by signature: the students take use_kernels, the teachers do not
        accepts = inspect.signature(model.forward).parameters
        kwargs: Dict[str, Any] = dict(train=True, generator=state.generator)
        if "use_kernels" in accepts:
            kwargs["use_kernels"] = use_kernels
        if pass_pad_mask and "pad_mask" in batch and "pad_mask" in accepts:
            kwargs["pad_mask"] = batch["pad_mask"]
        outputs = model(batch["data"], **kwargs)
        loss, metrics = loss_fn(outputs, batch)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        apply_sgd_update(state, dict(zip(names, grads)), lr, sgd, lr_scale_fn)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def make_eval_step(loss_fn: LossFn):
    """Build ``step(state, batch) -> metrics``: forward in test mode
    (running statistics, no dropout) + loss and metrics."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            outputs = state.model(batch["data"], train=False)
            loss, metrics = loss_fn(outputs, batch)
        return dict(metrics, loss=loss)

    return step
