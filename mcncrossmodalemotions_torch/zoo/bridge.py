"""Weight bridge: the JAX models' Flax variables -> the port's ``state_dict``.

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

from mcncrossmodalemotions_torch.models.vggface import VD16_BLOCKS, fc6_extent

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


# ---------------------------------------------------------------------------
# The face teachers (ResNet50 / SENet50, the classic VGGFace)
# ---------------------------------------------------------------------------

def teacher_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX face teachers' variables to the port's ``state_dict``:
    ``ResNet``/``SENet`` and ``VGGFace`` alike, whose port modules carry the
    Flax module names.

    Both the bare tree and the one nested under ``'teacher'`` by
    ``FaceTeacherPipeline`` (keys ``teacher.``-prefixed) map: conv kernels
    HWIO -> OIHW (VGGFace's fc6/fc7 are convs), Dense kernels ``[in, out]``
    -> ``Linear`` ``[out, in]`` (the SE pair and the head), conv and Dense
    biases as they are, BatchNorm ``scale/bias`` and ``mean/var`` ->
    ``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``).
    A tree without ``batch_stats`` maps its parameters alone. A leaf the
    port lacks or a key it has and the tree does not fail its strict
    ``load_state_dict``.
    """
    params, stats = variables["params"], variables.get("batch_stats", {})

    def tensor(leaf) -> torch.Tensor:
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", torch.float32, copy=True)
        return torch.from_numpy(np.array(leaf, np.float32))

    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params).items():
        module, name = path.rsplit("/", 1)
        key = module.replace("/", ".")
        t = tensor(leaf)
        if name == "kernel":
            state[f"{key}.weight"] = (t.permute(3, 2, 0, 1) if t.ndim == 4
                                      else t.t()).contiguous()
        elif name in ("scale", "bias"):
            state[f"{key}.{'weight' if name == 'scale' else 'bias'}"] = t
        else:
            raise KeyError(f"teacher variables have an unknown leaf {path!r}")
    for path, leaf in _flatten(stats).items():
        module, name = path.rsplit("/", 1)
        key = module.replace("/", ".")
        if name not in ("mean", "var"):
            raise KeyError(f"teacher batch_stats have an unknown leaf {path!r}")
        state[f"{key}.running_{name}"] = tensor(leaf)
        state[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return state


def teacher_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a teacher's params-shaped tree (the JAX ``TrainState.velocity``,
    or its ``params``) to the port's parameter names, the keys of the
    port's velocity."""
    return teacher_state_dict_from_flax({"params": tree})


def random_teacher_variables(seed: int = 0, use_se: bool = True,
                             stage_sizes=(3, 4, 6, 3), width: int = 64,
                             num_outputs: int = 8) -> dict:
    """Seeded ResNet/SENet weights in the Flax layout (bare ``ResNet``
    tree), numpy only (``np.random.RandomState(seed)``).

    He-normal convs (conv1 scaled by 1/100 for the mean-subtracted 0-255
    input), BatchNorm scales, biases, running means and variances all
    randomised, the last BatchNorm of each block scaled down so the residual
    sum stays bounded over 16 blocks, and a head that gives O(1) logits that
    differ across frames and classes: a golden on near-zero logits would
    prove nothing.
    """
    rng = np.random.RandomState(seed)
    params: dict = {}
    stats: dict = {}

    def conv(shape, gain=1.0):
        fan_in = shape[0] * shape[1] * shape[2]
        return {"kernel": rng.normal(0.0, gain * np.sqrt(2.0 / fan_in), shape)}

    def bn(feats, lo=0.5, hi=1.5):
        return ({"scale": rng.uniform(lo, hi, feats),
                 "bias": rng.normal(0.0, 0.1, feats)},
                {"mean": rng.normal(0.0, 0.1, feats),
                 "var": rng.uniform(0.5, 2.0, feats)})

    def dense(fan_in, fan_out, gain=np.sqrt(2.0)):
        return {"kernel": rng.normal(0.0, gain / np.sqrt(fan_in),
                                     (fan_in, fan_out)),
                "bias": rng.normal(0.0, 0.1, fan_out)}

    params["conv1"] = conv((7, 7, 3, width), gain=0.01)
    params["bn1"], stats["bn1"] = bn(width)
    in_features = width
    for s, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            feats = width * 2 ** s
            out = feats * 4
            p: dict = {}
            st: dict = {}
            p["conv1"] = conv((1, 1, in_features, feats))
            p["bn1"], st["bn1"] = bn(feats)
            p["conv2"] = conv((3, 3, feats, feats))
            p["bn2"], st["bn2"] = bn(feats)
            p["conv3"] = conv((1, 1, feats, out))
            p["bn3"], st["bn3"] = bn(out, 0.1, 0.3)
            if use_se:
                p["se"] = {"fc1": dense(out, out // 16),
                           "fc2": dense(out // 16, out, gain=1.0)}
            if in_features != out or (s > 0 and b == 0):
                p["downsample"] = conv((1, 1, in_features, out))
                p["bn_down"], st["bn_down"] = bn(out)
            params[f"layer{s + 1}_{b}"] = p
            stats[f"layer{s + 1}_{b}"] = st
            in_features = out
    params["prediction"] = dense(in_features, num_outputs, gain=1.0)

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.astype(np.float32)
                for k, v in tree.items()}

    return {"params": f32(params), "batch_stats": f32(stats)}


def random_vggface_variables(seed: int = 0, arch: str = "m",
                             use_batchnorm: bool = True,
                             width_multiplier: float = 1.0,
                             fc_features: int = 4096, num_outputs: int = 8,
                             input_size: int = 224) -> dict:
    """Seeded ``VGGFace`` weights in the Flax layout (bare tree), numpy
    only (``np.random.RandomState(seed)``), the shapes of
    ``models.vggface.VGGFace`` with the same arguments at ``input_size``.

    He-normal conv kernels (conv1 scaled by 1/100 for the mean-subtracted
    0-255 input); with ``use_batchnorm`` randomised BatchNorm scales,
    biases, running means and variances and no conv biases, without it
    small random conv biases; a head that gives O(1) logits."""
    rng = np.random.RandomState(seed)

    def width(c):
        return max(8, int(round(c * width_multiplier)))

    if arch == "vd":
        layers = [(f"conv{b}_{c}", 3, width(w))
                  for b, ws in enumerate(VD16_BLOCKS, start=1)
                  for c, w in enumerate(ws, start=1)]
    elif arch == "m":
        layers = [("conv1", 7, width(96)), ("conv2", 5, width(256))] + [
            (f"conv{i}", 3, width(512)) for i in (3, 4, 5)]
    else:
        raise ValueError(f"unknown VGGFace arch {arch!r}")
    fc = width(fc_features)
    layers += [("fc6", fc6_extent(arch, input_size), fc), ("fc7", 1, fc)]
    params: dict = {}
    stats: dict = {}
    in_ch = 3
    for name, k, out in layers:
        gain = 0.01 if in_ch == 3 else 1.0
        node = {"kernel": rng.normal(0.0, gain * np.sqrt(2.0 / (k * k * in_ch)),
                                     (k, k, in_ch, out))}
        if use_batchnorm:
            params[f"bn_{name}"] = {"scale": rng.uniform(0.5, 1.5, out),
                                    "bias": rng.normal(0.0, 0.1, out)}
            stats[f"bn_{name}"] = {"mean": rng.normal(0.0, 0.1, out),
                                   "var": rng.uniform(0.5, 2.0, out)}
        else:
            node["bias"] = rng.normal(0.0, 0.01, out)
        params[name] = node
        in_ch = out
    params["prediction"] = {
        "kernel": rng.normal(0.0, 1.0 / np.sqrt(fc), (fc, num_outputs)),
        "bias": rng.normal(0.0, 0.1, num_outputs)}

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.astype(np.float32)
                for k, v in tree.items()}

    out = {"params": f32(params)}
    if use_batchnorm:
        out["batch_stats"] = f32(stats)
    return out
