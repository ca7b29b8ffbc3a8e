"""Weight bridge: the JAX student's Flax variables -> the port's ``state_dict``.

The JAX ``VGGMStudent`` keeps ``{'params', 'batch_stats'}`` as nested
dicts (optionally under ``'net'``, as ``AudioStudentPipeline`` and
``load_pretrained_student`` nest them). The mapping:

- conv kernels HWIO -> OIHW (conv1 ``[7,7,1,96]``, fc6 ``[9,1,256,F6]``);
- dense kernels ``[in, out]`` -> ``[out, in]``; biases as they are;
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
  ``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``);
- a student built with ``use_batchnorm=False`` has conv biases and no
  BatchNorm (and may have no ``batch_stats`` at all).

Leaves are numpy arrays (or anything ``np.asarray`` takes) or torch
tensors (the msgpack reader gives bfloat16 leaves as tensors); each
becomes an fp32 tensor.

``student_params_from_flax`` maps a params-shaped tree alone (the JAX
``TrainState.velocity``, or its ``params``) to the port's parameter names
(``named_parameters``), the keys of the port's velocity.

Every leaf must be consumed and every port key produced, so a layout
change on either side fails loudly instead of loading half a model.
``random_student_variables`` makes seeded weights in the Flax layout with
numpy alone, so both packages can be given the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6")
_DENSES = ("fc7", "prediction")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        elif isinstance(value, torch.Tensor):  # a bfloat16 leaf
            flat[path] = value
        else:
            flat[path] = np.asarray(value)
    return flat


def _map_student(params: Mapping,
                 stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """Port keys of the student for ``params`` (and ``stats``, the
    running statistics; None maps the parameters alone). Variables nested
    under ``'net'`` get the pipeline's ``net.`` prefix."""
    prefix = ""
    if set(params) == {"net"}:
        params, prefix = params["net"], "net."
        stats = None if stats is None else stats.get("net", {})
    leaves = {f"params/{k}": v for k, v in _flatten(params).items()}
    if stats is not None:
        leaves.update({f"batch_stats/{k}": v for k, v in _flatten(stats).items()})
    use_bn = "bn1" in params

    def take(path: str) -> torch.Tensor:
        if path not in leaves:
            raise KeyError(f"student variables lack {path!r}")
        leaf = leaves.pop(path)
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", torch.float32, copy=True)
        return torch.from_numpy(np.array(leaf, np.float32))

    state: Dict[str, torch.Tensor] = {}
    for i, conv in enumerate(_CONVS, 1):
        state[f"{conv}.weight"] = take(f"params/{conv}/kernel").permute(
            3, 2, 0, 1).contiguous()
        if not use_bn:
            state[f"{conv}.bias"] = take(f"params/{conv}/bias")
            continue
        state[f"bn{i}.weight"] = take(f"params/bn{i}/scale")
        state[f"bn{i}.bias"] = take(f"params/bn{i}/bias")
        if stats is not None:
            state[f"bn{i}.running_mean"] = take(f"batch_stats/bn{i}/mean")
            state[f"bn{i}.running_var"] = take(f"batch_stats/bn{i}/var")
            state[f"bn{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for dense in _DENSES:
        state[f"{dense}.weight"] = take(f"params/{dense}/kernel").t().contiguous()
        state[f"{dense}.bias"] = take(f"params/{dense}/bias")
    if leaves:
        raise KeyError(f"student variables have unmapped leaves: {sorted(leaves)}")
    return {prefix + k: v for k, v in state.items()}


def student_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map JAX ``VGGMStudent`` variables to the port's ``state_dict``.

    Variables nested under ``'net'`` map to ``AudioStudentPipeline``'s keys
    (``net.`` prefix); bare ones to ``VGGMStudent``'s. Raises ``KeyError``
    on a missing or an unused leaf.
    """
    return _map_student(variables["params"], variables.get("batch_stats", {}))


def student_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a params-shaped tree (no ``batch_stats``: the JAX velocity or
    params) to the port's parameter names. Raises ``KeyError`` on a
    missing or an unused leaf."""
    return _map_student(tree, None)


def random_student_variables(seed: int = 0, fc6: int = 4096, fc7: int = 1024,
                             num_outputs: int = 8) -> dict:
    """Seeded student weights in the Flax layout, numpy only.

    He-normal conv and fc7 kernels; BatchNorm scales, biases, running means
    and variances all randomised (init values would make BN near identity
    and leave its arithmetic untested); the head scaled to give O(1)
    logits, not the 1e-4 of the scratch init.
    """
    rng = np.random.default_rng(seed)
    conv_shapes = {"conv1": (7, 7, 1, 96), "conv2": (5, 5, 96, 256),
                   "conv3": (3, 3, 256, 384), "conv4": (3, 3, 384, 256),
                   "conv5": (3, 3, 256, 256), "fc6": (9, 1, 256, fc6)}
    params, stats = {}, {}
    for i, (name, shape) in enumerate(conv_shapes.items(), 1):
        fan_in = shape[0] * shape[1] * shape[2]
        params[name] = {"kernel": rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)}
        feats = shape[-1]
        params[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, feats),
                            "bias": rng.normal(0.0, 0.1, feats)}
        stats[f"bn{i}"] = {"mean": rng.normal(0.0, 0.2, feats),
                           "var": rng.uniform(0.5, 2.0, feats)}
    params["fc7"] = {"kernel": rng.normal(0.0, np.sqrt(2.0 / fc6), (fc6, fc7)),
                     "bias": rng.normal(0.0, 0.1, fc7)}
    params["prediction"] = {
        "kernel": rng.normal(0.0, 1.0 / np.sqrt(fc7), (fc7, num_outputs)),
        "bias": rng.normal(0.0, 0.1, num_outputs)}

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.astype(np.float32)
                for k, v in tree.items()}

    return {"params": f32(params), "batch_stats": f32(stats)}
