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

Under a data-parallel ``mesh`` (``parallel/mesh.py``) every rank holds the
whole state and its shard of the batch; a step normalises the loss and
the metrics by the GLOBAL batch's valid rows, sums the gradients over the
ranks (one all-reduce of one flat buffer) before the update, and reports
the global loss and metrics, so every rank makes the one update that one
process makes on the whole batch.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from mcncrossmodalemotions_torch.models.vggm import REMAT_RUNS
from mcncrossmodalemotions_torch.parallel.mesh import (
    DataMesh,
    all_reduce_tensors,
)
from mcncrossmodalemotions_torch.utils import trace


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


def resolve_remat_policy(name: Optional[str]) -> Optional[str]:
    """Check a remat-policy name (JAX ``resolve_remat_policy``): None or
    ``'none'`` -> None (keep every activation), else one of the student's
    policies (``models.vggm.REMAT_RUNS``), which recompute activations in
    the backward instead of keeping them:

    - ``drop_conv1``: the conv1 + bn1 + relu1 block;
    - ``drop_through_pool1``: also pool1's output (up to conv2);
    - ``save_pools``: keep only the pool1, pool2, pool5 and fc6 outputs;
    - ``dots``: keep the matmul outputs, recompute the convs;
    - ``nothing``: keep nothing (full remat).

    The same operations run again, so the step's results are those without
    a policy.
    """
    if name is None or name == "none":
        return None
    if name not in REMAT_RUNS:
        raise ValueError(f"unknown remat policy {name!r}; "
                         f"choose from {['none', *REMAT_RUNS]}")
    return name


def _global_weight(batch: Dict[str, torch.Tensor],
                   mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """``batch`` with a ``pad_mask`` (ones where it had none) and
    ``pad_total``, the mask's sum over every rank's rows: the denominator
    of the loss stacks' means (``zoo.student_loss_fn``)."""
    mask = batch.get("pad_mask")
    if mask is None:
        mask = torch.ones(batch["data"].shape[0], device=batch["data"].device)
    total, = all_reduce_tensors([mask.float().sum()], mesh)
    return dict(batch, pad_mask=mask, pad_total=total)


def _global_metrics(loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                    mesh: Optional[DataMesh]) -> Dict[str, torch.Tensor]:
    """The step's metrics, detached, with ``loss``; under ``mesh`` each is
    this rank's share of the global figure (a mean over ``pad_total``, or
    a sum), so they are summed over the ranks (one all-reduce)."""
    out = {k: v.detach() for k, v in metrics.items()}
    out["loss"] = loss.detach()
    if mesh is not None:
        out = dict(zip(out, all_reduce_tensors(list(out.values()), mesh)))
    return out


def make_train_step(loss_fn: LossFn, sgd: SGDConfig = SGDConfig(),
                    lr_scale_fn: Optional[Callable] = None,
                    remat_policy: Optional[str] = None,
                    pass_pad_mask: bool = False,
                    use_kernels: bool = True,
                    mesh: Optional[DataMesh] = None):
    """Build ``step(state, batch, lr) -> (state, metrics)``.

    The batch dict holds at least ``data``; the loss reads
    ``logit_target``, ``max_label``, ``hard_label``, ``label_dist``,
    ``pad_mask`` and ``instance_weights`` as it needs them. The model gets
    ``train=True`` and, of ``generator`` (``state.generator``: dropout,
    the teachers' fliplr), ``use_kernels``, ``pad_mask`` and
    ``remat_policy``, those its forward accepts. ``pass_pad_mask`` gives
    ``batch['pad_mask']`` (when present), so train-mode BatchNorm
    statistics exclude padded rows. ``use_kernels`` runs the frontend and
    pool1/pool2 through the kernels on the card (False: their plain
    versions). ``remat_policy`` (``resolve_remat_policy``) needs a model
    whose forward takes it (the students). ``lr_scale_fn`` maps a
    parameter's name split at the dots to its learning-rate multiplier.
    ``lr`` is a Python float, which may change every call.

    ``mesh`` (``parallel.mesh.make_mesh``) makes the step data-parallel:
    ``batch`` is this rank's shard of the global batch and the model's
    forward takes ``mesh`` (BatchNorm statistics and random draws of the
    global batch); the loss function reads ``pad_total`` (the loss stacks
    of ``zoo`` do), the gradients are summed over the ranks before the
    update, and the metrics returned are the global batch's.

    While ``utils/trace`` records, the step's spans are ``train.forward``,
    ``train.loss``, ``train.backward`` (``torch.autograd.grad``) and
    ``train.sgd`` (``apply_sgd_update``).
    """
    policy = resolve_remat_policy(remat_policy)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        model = state.model
        # by signature: the students take use_kernels, the teachers do not
        accepts = inspect.signature(model.forward).parameters
        kwargs: Dict[str, Any] = dict(train=True, generator=state.generator)
        if "use_kernels" in accepts:
            kwargs["use_kernels"] = use_kernels
        if pass_pad_mask and "pad_mask" in batch and "pad_mask" in accepts:
            kwargs["pad_mask"] = batch["pad_mask"]
        if policy is not None:
            if "remat_policy" not in accepts:
                raise ValueError(f"remat policy {policy!r}: "
                                 f"{type(model).__name__} has no remat "
                                 "stages (only the students do)")
            kwargs["remat_policy"] = policy
        if mesh is not None:
            if "mesh" not in accepts:
                raise ValueError(f"{type(model).__name__}'s forward takes no "
                                 "mesh: its BatchNorm would see one shard")
            kwargs["mesh"] = mesh
            batch = _global_weight(batch, mesh)
        with trace.span("train.forward"):
            outputs = model(batch["data"], **kwargs)
        with trace.span("train.loss"):
            loss, metrics = loss_fn(outputs, batch)
        names, params = zip(*model.named_parameters())
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads = all_reduce_tensors(grads, mesh)
        with trace.span("train.sgd"):
            apply_sgd_update(state, dict(zip(names, grads)), lr, sgd,
                             lr_scale_fn)
        state.step += 1
        return state, _global_metrics(loss, metrics, mesh)

    return step


def make_eval_step(loss_fn: LossFn, mesh: Optional[DataMesh] = None):
    """Build ``step(state, batch) -> metrics``: forward in test mode
    (running statistics, no dropout) + loss and metrics; under ``mesh``
    over this rank's shard, the metrics the global batch's."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            if mesh is not None:
                batch = _global_weight(batch, mesh)
            outputs = state.model(batch["data"], train=False)
            loss, metrics = loss_fn(outputs, batch)
            return _global_metrics(loss, metrics, mesh)

    return step
