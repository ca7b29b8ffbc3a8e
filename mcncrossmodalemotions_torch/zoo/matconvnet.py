"""MatConvNet ``.mat`` weight import (released-model parity path).

The port's copy of ``mcncrossmodalemotions_tpu/zoo/matconvnet.py``, the
teacher layer maps included: numpy and scipy only, ``h5py`` imported
inside the ``-v7.3`` readers, and the container helpers from the port's
``utils/mat73.py``. It returns the same Flax-layout variable trees (numpy
leaves), bit for bit (``tests/test_torch_release.py``); the port turns
them into ``state_dict`` tensors with ``zoo/bridge.py``.

The reference distributes its models as MatConvNet DagNN ``.mat`` files
(emoVoxZoo.m:74-102, ferPlusZoo.m downloads from
robots.ox.ac.uk/~albanie/models/...). This module loads those files and
rebuilds Flax variable trees so released weights can be run through the
models for forward-parity validation against released logit
artifacts (wavLogits / afew-logits, SURVEY.md section 7 step 3).

Conventions handled:

- conv filters are stored HWCN (H, W, Cin, Cout) — identical to the Flax
  ``nn.Conv`` kernel layout, no transpose needed;
- batch-norm params come as (gamma, beta, moments[:, 0]=mean,
  moments[:, 1]=sigma) with sigma = sqrt(var + eps), so
  var = sigma^2 - eps;
- fully-connected layers appear as 1x1 convs; Dense kernels reshape from
  (1, 1, Cin, Cout) (or (Cin, Cout)) accordingly;
- ``ensure_compatibility``: stray fields like ``exBackprop`` on released
  models (misc/ensure_compatibility.m) are ignored by construction since
  only (name, value) pairs are read.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict

import numpy as np

BN_EPSILON = 1e-5  # MatConvNet vl_nnbnorm default epsilon

# Classic (scipy) .mat files must be parsed whole; callers routinely
# need BOTH params and meta from one release (weights import + its
# averageImage), and the big classics are ~1 GB — cache the last parse
# keyed on (path, mtime) so load_mat_params/load_mat_meta share it.
_CLASSIC_CACHE: dict = {}


def clear_mat_cache() -> None:
    """Drop the cached classic-.mat parse (it can pin ~1 GB for the big
    releases). Prefer ``mat_cache_scope`` — every zoo loader entry point
    runs inside one, so the parse is released as soon as the outermost
    scope's params+meta reads finish."""
    _CLASSIC_CACHE.clear()


_CACHE_SCOPE_DEPTH = 0


@contextlib.contextmanager
def mat_cache_scope():
    """Keep the classic-.mat parse cache warm for the duration of the
    scope, dropping it when the OUTERMOST scope exits.

    Reentrant: composite callers (e.g. ferplus_baselines reading params
    via prepare_*_from_base and then meta via release_mean_rgb from the
    same ~1 GB release) open one scope around the whole sequence, and
    the entry points' inner scopes become no-ops, so the file is parsed
    once and released once."""
    global _CACHE_SCOPE_DEPTH
    _CACHE_SCOPE_DEPTH += 1
    try:
        yield
    finally:
        _CACHE_SCOPE_DEPTH -= 1
        if _CACHE_SCOPE_DEPTH == 0:
            clear_mat_cache()


def _load_classic_net(path: str | Path):
    import os

    import scipy.io

    key = (str(path), os.stat(path).st_mtime_ns)
    if _CLASSIC_CACHE.get("key") != key:
        mat = scipy.io.loadmat(str(path), struct_as_record=False,
                               squeeze_me=True)
        _CLASSIC_CACHE.clear()
        _CLASSIC_CACHE["key"] = key
        _CLASSIC_CACHE["net"] = mat.get("net", mat)
    return _CLASSIC_CACHE["net"]


def load_mat_params(path: str | Path) -> Dict[str, np.ndarray]:
    """Flat {param_name: array} from a DagNN/SimpleNN ``.mat`` file.

    Handles both containers the release sites actually ship: the classic
    .mat (scipy.io) and MATLAB ``-v7.3``/HDF5 — the format MATLAB is
    forced into for >2 GB saves, so the large VGGFace2/vgg-vd dags
    plausibly use it (the released logits imdb demonstrably does,
    data/imdb.py). Dispatch mirrors ``emovox_imdb_from_mat``.
    """
    from mcncrossmodalemotions_torch.utils import mat73

    if mat73.is_hdf5(path):
        return _load_mat_params_h5(path)
    net = _load_classic_net(path)
    params: Dict[str, np.ndarray] = {}
    if hasattr(net, "params"):  # DagNN: array of structs with .name/.value
        entries = np.atleast_1d(net.params)
        for p in entries:
            params[str(p.name)] = np.asarray(p.value)
    elif hasattr(net, "layers"):  # SimpleNN: per-layer weights cells
        for layer in np.atleast_1d(net.layers):
            name = str(getattr(layer, "name", ""))
            weights = getattr(layer, "weights", None)
            if weights is None:
                continue
            weights = np.atleast_1d(weights)
            for i, w in enumerate(weights):
                suffix = ["f", "b", "m"][i] if i < 3 else str(i)
                params[f"{name}_{suffix}"] = np.asarray(w)
    else:
        raise ValueError(f"{path}: no net.params or net.layers found")
    return params


def _load_mat_params_h5(path: str | Path) -> Dict[str, np.ndarray]:
    """``-v7.3`` container read (utils/mat73 conventions).

    DagNN: ``net/params`` is a struct-array group whose ``name``/``value``
    fields are per-element object references. SimpleNN: ``net/layers`` is
    a cell of references to layer groups carrying ``name`` + a
    ``weights`` cell. Numeric values arrive column-major and are
    transposed back to the MATLAB (HWCN) shape.
    """
    import h5py

    from mcncrossmodalemotions_torch.utils import mat73

    params: Dict[str, np.ndarray] = {}
    with h5py.File(str(path), "r") as f:
        net = f["net"] if "net" in f else f
        if "params" in net:  # DagNN
            grp = net["params"]
            names = mat73.cell_refs(grp["name"])
            values = mat73.cell_refs(grp["value"])
            for nref, vref in zip(names, values):
                params[mat73.matlab_string(f, nref)] = (
                    mat73.matlab_array(f, vref))
        elif "layers" in net:  # SimpleNN
            for lref in mat73.cell_refs(net["layers"]):
                layer = mat73.deref(f, lref)
                if "weights" not in layer:
                    continue
                name = mat73.matlab_string(f, layer["name"])
                weights = mat73.cell_refs(layer["weights"])
                for i, wref in enumerate(weights):
                    suffix = ["f", "b", "m"][i] if i < 3 else str(i)
                    params[f"{name}_{suffix}"] = (
                        mat73.matlab_array(f, wref))
        else:
            raise ValueError(f"{path}: no net/params or net/layers found")
    return params


def _load_mat_meta_h5(path: str | Path) -> dict:
    import h5py

    from mcncrossmodalemotions_torch.utils import mat73

    meta: dict = {}
    with h5py.File(str(path), "r") as f:
        net = f["net"] if "net" in f else f
        m = net.get("meta") if hasattr(net, "get") else None
        if m is None:
            return meta
        norm = m.get("normalization")
        if norm is not None:
            for field in ("imageSize", "averageImage"):
                if field in norm:
                    meta[field] = mat73.matlab_array(f, norm[field])
        classes = m.get("classes")
        if classes is not None:
            # struct group (classes.name cell) or a bare cell dataset
            names = (classes.get("name", classes)
                     if hasattr(classes, "get") else classes)
            meta["classes"] = [str(s)
                               for s in mat73.string_cell(f, names)]
    return meta


def load_mat_meta(path: str | Path) -> dict:
    """Normalization meta (imageSize, averageImage, classes) if present.

    Container dispatch as in ``load_mat_params`` (classic vs -v7.3).
    """
    from mcncrossmodalemotions_torch.utils import mat73

    if mat73.is_hdf5(path):
        return _load_mat_meta_h5(path)
    net = _load_classic_net(path)
    meta = {}
    m = getattr(net, "meta", None)
    if m is not None:
        norm = getattr(m, "normalization", None)
        if norm is not None:
            for field in ("imageSize", "averageImage"):
                if hasattr(norm, field):
                    meta[field] = np.asarray(getattr(norm, field))
        classes = getattr(m, "classes", None)
        if classes is not None:
            names = getattr(classes, "name", classes)
            meta["classes"] = [str(c) for c in np.atleast_1d(names)]
    return meta


def conv_kernel(raw: np.ndarray, squeeze_axis: int = 2,
                hw: tuple | None = None) -> np.ndarray:
    """HWCN filter -> Flax kernel (same layout, dtype-normalised).

    MATLAB squeezes singleton dims on save/load, so a 3-D filter is
    missing one axis; ``squeeze_axis`` names which one to restore
    (2 = single input channel, the common case; 1 = unit-width kernels
    like VGG-M's 9x1 fc6). A fully squeezed 1x1 conv arrives 2-D
    [Cin, Cout]; pass ``hw=(1, 1)`` to restore the spatial axes.
    """
    raw = np.asarray(raw, np.float32)
    if raw.ndim == 2:  # fc / 1x1 conv stored as matrix [Cin, Cout]
        if hw is not None:
            return raw.reshape(*hw, *raw.shape)
        return raw
    if raw.ndim == 3:
        return np.expand_dims(raw, squeeze_axis)
    return raw


def dense_kernel(raw: np.ndarray) -> np.ndarray:
    """1x1-conv (or matrix) weights -> Dense kernel [Cin, Cout]."""
    raw = np.asarray(raw, np.float32)
    if raw.ndim == 4:
        assert raw.shape[0] == raw.shape[1] == 1, raw.shape
        return raw[0, 0]
    return raw


def bn_variables(gamma: np.ndarray, beta: np.ndarray,
                 moments: np.ndarray, epsilon: float = BN_EPSILON) -> dict:
    """(gamma, beta, moments) -> {scale, bias, mean, var}."""
    gamma = np.asarray(gamma, np.float32).reshape(-1)
    beta = np.asarray(beta, np.float32).reshape(-1)
    moments = np.asarray(moments, np.float32)
    mean = moments[:, 0]
    sigma = moments[:, 1]
    var = np.maximum(sigma ** 2 - epsilon, 0.0)
    return {"scale": gamma, "bias": beta, "mean": mean, "var": var}


def _resolve(params: Dict[str, np.ndarray], names, *,
             required: bool = True, context: str = "") -> str | None:
    """First param name present among ``names`` (str or tuple of candidates).

    Released MatConvNet models are inconsistent about param naming —
    ferPlusZoo.m:169-186 itself probes ``<layer>f`` / ``<layer>_filter`` /
    ``<layer>_f`` (and the bias equivalents) in turn; layer maps list the
    same candidates and this picks whichever the release actually uses.
    """
    if isinstance(names, str):
        names = (names,)
    for name in names:
        if name in params:
            return name
    if required:
        raise KeyError(f"none of {list(names)} found in .mat params"
                       f"{' for ' + context if context else ''}")
    return None


def import_variables(params: Dict[str, np.ndarray],
                     layer_map: Dict[str, dict]) -> dict:
    """Build a Flax variables tree from flat params + a layer mapping.

    ``layer_map`` maps a Flax module path (``"conv1"``,
    ``"layer1_0/bn2"``…) to a spec dict:
      {"kind": "conv"|"dense"|"bn",
       "filters"/"bias": param names, or for bn:
       "gamma"/"beta"/"moments": param names}.
    Each name may be a single string or a tuple of candidate names
    (first present wins — see ``_resolve``).
    Returns {"params": ..., "batch_stats": ...} nested by path.
    """
    tree: dict = {"params": {}, "batch_stats": {}}

    def insert(root: dict, path: str, leaf: dict) -> None:
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    for path, spec in layer_map.items():
        kind = spec["kind"]
        if kind in ("conv", "dense"):
            fname = _resolve(params, spec["filters"], context=path)
            if kind == "conv":
                leaf = {"kernel": conv_kernel(params[fname],
                                              spec.get("squeeze_axis", 2),
                                              hw=spec.get("hw"))}
            else:
                leaf = {"kernel": dense_kernel(params[fname])}
            bname = _resolve(params, spec.get("bias", ()), required=False)
            if bname is not None:
                leaf["bias"] = np.asarray(params[bname], np.float32).reshape(-1)
            insert(tree["params"], path, leaf)
        elif kind == "bn":
            bn = bn_variables(params[_resolve(params, spec["gamma"], context=path)],
                              params[_resolve(params, spec["beta"], context=path)],
                              params[_resolve(params, spec["moments"], context=path)],
                              spec.get("epsilon", BN_EPSILON))
            insert(tree["params"], path, {"scale": bn["scale"], "bias": bn["bias"]})
            insert(tree["batch_stats"], path, {"mean": bn["mean"], "var": bn["var"]})
        else:
            raise ValueError(f"unknown layer kind {kind!r} for {path}")
    return tree


def vggm_layer_map(prefix: str = "") -> Dict[str, dict]:
    """Mapping for VGGVox-style VGG-M releases (conv{1..5}, fc{6,7,8}).

    MatConvNet param naming convention: ``<layer>f`` / ``<layer>b`` for
    conv filters/biases, ``bn<k>{m,x,v}``-style for batch norm (exact
    names vary per release; remap with ``rename`` when needed).
    """
    m: Dict[str, dict] = {}
    for i in range(1, 6):
        m[f"{prefix}conv{i}"] = {"kind": "conv", "filters": f"conv{i}f",
                                 "bias": f"conv{i}b"}
        m[f"{prefix}bn{i}"] = {"kind": "bn", "gamma": f"bn{i}f",
                               "beta": f"bn{i}b", "moments": f"bn{i}m"}
    m[f"{prefix}fc6"] = {"kind": "conv", "filters": "fc6f", "bias": "fc6b",
                         "squeeze_axis": 1}  # 9x1 kernel: W squeezed
    m[f"{prefix}bn6"] = {"kind": "bn", "gamma": "bn6f", "beta": "bn6b",
                         "moments": "bn6m"}
    m[f"{prefix}fc7"] = {"kind": "dense", "filters": "fc7f", "bias": "fc7b"}
    m[f"{prefix}prediction"] = {"kind": "dense", "filters": "fc8f",
                                "bias": "fc8b"}
    return m


def import_vggm_student(mat_path: str | Path) -> dict:
    """Released emovoxceleb-student .mat -> VGGMStudent variables."""
    params = load_mat_params(mat_path)
    return import_variables(params, vggm_layer_map())


# ---------------------------------------------------------------------------
# Teacher (ResNet50 / SENet50) releases.
#
# The resnet50-ferplus / senet50-ferplus releases descend from the VGGFace2
# MatConvNet models (ferPlusZoo.m:37-92 registry; pretrained path
# ferPlusZoo.m:103-114), whose layers follow the Caffe-import naming:
#   conv1/7x7_s2, conv{s}_{b}_1x1_reduce / _3x3 / _1x1_increase,
#   conv{s}_{b}_1x1_proj (downsample), SE pairs conv{s}_{b}_1x1_down/_up,
#   classifier (1x1 conv head; after ferPlusZoo surgery its params are
#   re-initialised but keep the layer-derived names, ferPlusZoo.m:162-189).
# Param names derive from layer names with release-dependent suffixes;
# every spec lists the candidate suffix set (see ``_resolve``).
# ---------------------------------------------------------------------------


def _conv_spec(layer: str, **extra) -> dict:
    return {"kind": "conv",
            "filters": (f"{layer}_filter", f"{layer}f", f"{layer}_f",
                        f"{layer}_weight"),
            "bias": (f"{layer}_bias", f"{layer}b", f"{layer}_b"),
            **extra}


def _dense_spec(layer: str) -> dict:
    return {"kind": "dense",
            "filters": (f"{layer}_filter", f"{layer}f", f"{layer}_f",
                        f"{layer}_weight"),
            "bias": (f"{layer}_bias", f"{layer}b", f"{layer}_b")}


def _bn_spec(layer: str) -> dict:
    return {"kind": "bn",
            "gamma": (f"{layer}_mult", f"{layer}_gamma", f"{layer}_scale",
                      f"{layer}f", f"{layer}_filter"),
            "beta": (f"{layer}_bias", f"{layer}b", f"{layer}_b"),
            "moments": (f"{layer}_moments", f"{layer}m", f"{layer}_m")}


def resnet50_layer_map(stage_sizes=(3, 4, 6, 3), *, use_se: bool = False,
                       head_name: str = "classifier",
                       prefix: str = "") -> Dict[str, dict]:
    """Flax-path -> .mat-param mapping for ResNet50/SENet50 teachers.

    Matches ``models.resnet.ResNet``'s module tree (layer{s}_{b} blocks
    with conv1/bn1..conv3/bn3, downsample/bn_down on block 0, se/fc{1,2})
    against the VGGFace2 Caffe-import layer naming described above.
    ``stage_sizes`` supports the tiny test configs.
    """
    m: Dict[str, dict] = {
        f"{prefix}conv1": _conv_spec("conv1_7x7_s2"),
        f"{prefix}bn1": _bn_spec("conv1_7x7_s2_bn"),
    }
    for s, num_blocks in enumerate(stage_sizes, start=1):
        for b in range(num_blocks):
            mat = f"conv{s + 1}_{b + 1}"
            fl = f"{prefix}layer{s}_{b}"
            m[f"{fl}/conv1"] = _conv_spec(f"{mat}_1x1_reduce", hw=(1, 1))
            m[f"{fl}/bn1"] = _bn_spec(f"{mat}_1x1_reduce_bn")
            m[f"{fl}/conv2"] = _conv_spec(f"{mat}_3x3")
            m[f"{fl}/bn2"] = _bn_spec(f"{mat}_3x3_bn")
            m[f"{fl}/conv3"] = _conv_spec(f"{mat}_1x1_increase", hw=(1, 1))
            m[f"{fl}/bn3"] = _bn_spec(f"{mat}_1x1_increase_bn")
            if b == 0:  # projection shortcut on the first block of a stage
                m[f"{fl}/downsample"] = _conv_spec(f"{mat}_1x1_proj",
                                                   hw=(1, 1))
                m[f"{fl}/bn_down"] = _bn_spec(f"{mat}_1x1_proj_bn")
            if use_se:  # SE 1x1 convs -> Dense squeeze/excite pair
                m[f"{fl}/se/fc1"] = _dense_spec(f"{mat}_1x1_down")
                m[f"{fl}/se/fc2"] = _dense_spec(f"{mat}_1x1_up")
    m[f"{prefix}prediction"] = _dense_spec(head_name)
    return m


def senet50_layer_map(stage_sizes=(3, 4, 6, 3), **kw) -> Dict[str, dict]:
    """senet50-ferplus mapping (SE-ResNet-50)."""
    return resnet50_layer_map(stage_sizes, use_se=True, **kw)


def infer_teacher_arch(params: Dict[str, np.ndarray],
                       head_name: str = "classifier") -> dict:
    """Architecture hyperparams implied by a teacher .mat's param names.

    Returns {stage_sizes, use_se, width, num_outputs} so
    ``load_pretrained_teacher`` can build the matching ``ResNet`` without
    the caller hand-specifying dims (the reference reads them from the
    DagNN graph itself, ferPlusZoo.m:136-160).
    """
    use_se = any("_1x1_down" in name for name in params)
    stage_sizes = []
    s = 1
    while True:
        b = 0
        while _resolve(params, _conv_spec(f"conv{s + 1}_{b + 1}_1x1_reduce")
                       ["filters"], required=False) is not None:
            b += 1
        if b == 0:
            break
        stage_sizes.append(b)
        s += 1
    if not stage_sizes:
        raise ValueError("no conv{s}_{b}_1x1_reduce params found — "
                         "not a ResNet50/SENet50-style release")
    conv1 = params[_resolve(params, _conv_spec("conv1_7x7_s2")["filters"],
                            context="conv1")]
    width = int(np.atleast_3d(conv1).shape[-1])
    head = params[_resolve(params, _dense_spec(head_name)["filters"],
                           context=head_name)]
    num_outputs = int(np.asarray(head).shape[-1])
    return {"stage_sizes": tuple(stage_sizes), "use_se": use_se,
            "width": width, "num_outputs": num_outputs}


def import_teacher(mat_path: str | Path,
                   head_name: str = "classifier") -> tuple:
    """Released teacher .mat -> (arch dict, ResNet variables tree)."""
    params = load_mat_params(mat_path)
    arch = infer_teacher_arch(params, head_name)
    layer_map = resnet50_layer_map(arch["stage_sizes"], use_se=arch["use_se"],
                                   head_name=head_name)
    return arch, import_variables(params, layer_map)


# ---------------------------------------------------------------------------
# Classic VGG face releases (vgg_face / vgg-vd-face* / vgg-m-face-bn*),
# ferPlusZoo.m:44-59. VD-16 layers are conv{block}_{idx}; VGG-M layers
# are conv{1..5}; both end fc6/fc7/fc8. The '-bn' releases carry BN
# params alongside each conv/fc (insertBNLayers naming: <layer>_bn*).
# ---------------------------------------------------------------------------

VD16_BLOCK_SIZES = (2, 2, 3, 3, 3)


def vggface_layer_map(arch: str = "vd", *, use_batchnorm: bool = False,
                      head_name: str = "fc8",
                      prefix: str = "") -> Dict[str, dict]:
    """Flax-path -> .mat-param mapping for ``models/vggface.VGGFace``."""
    m: Dict[str, dict] = {}

    def add(flax_name: str, mat_layer: str) -> None:
        m[f"{prefix}{flax_name}"] = _conv_spec(mat_layer)
        if use_batchnorm:
            m[f"{prefix}bn_{flax_name}"] = _bn_spec(f"{mat_layer}_bn")

    if arch == "vd":
        for b, n in enumerate(VD16_BLOCK_SIZES, start=1):
            for c in range(1, n + 1):
                add(f"conv{b}_{c}", f"conv{b}_{c}")
    elif arch == "m":
        for i in range(1, 6):
            add(f"conv{i}", f"conv{i}")
    else:
        raise ValueError(f"unknown VGGFace arch {arch!r}")
    add("fc6", "fc6")
    add("fc7", "fc7")
    # fc6/fc7 are convs; when their spatial extent is 1x1 (fc7 always;
    # fc6 in small geometries) MATLAB's save squeezes them to [Cin, Cout]
    # — hw restores the spatial axes (full-spatial fc6 kernels arrive 4-D
    # and pass through untouched).
    m[f"{prefix}fc6"]["hw"] = (1, 1)
    m[f"{prefix}fc7"]["hw"] = (1, 1)
    m[f"{prefix}prediction"] = _dense_spec(head_name)
    return m


def import_classic_teacher(mat_path: str | Path, model) -> dict:
    """Released classic VGG face .mat -> ``VGGFace`` variables tree.

    ``model`` supplies the architecture config (arch + use_batchnorm),
    exactly as the reference reads it from the loaded DagNN graph
    (ferPlusZoo.m:136-160); shapes are validated implicitly when the
    tree is applied.

    useBnorm retrofit (ferPlusZoo.m:123 insertBNLayers): when the model
    wants BatchNorm but the release is BN-less (vgg_face / vgg-vd-face
    carry no BN params), the convs import as-is and FRESH identity BN
    variables (scale 1, bias 0, mean 0, var 1) are synthesised for each
    bn_<layer> the module expects — the reference likewise inserts
    identity-initialised vl_nnbnorm layers into the pretrained dag. The
    release's conv biases fold into the fresh BN running means
    (mean = -bias: (z-(-b))/1*1+0 == z+b), since the BN-variant module
    builds bias-free convs; exact in eval mode, and train mode uses
    batch stats exactly as the reference's retrofit does.
    """
    params = load_mat_params(mat_path)
    # BN presence is detected from the NAME SPACE, not one resolvable
    # candidate: a BN-carrying release with unexpected param suffixes
    # must fail LOUDLY in the BN map (KeyError naming the candidates),
    # never be silently re-imported with identity BN over trained stats.
    release_has_bn = any("_bn" in name or name.startswith("bn")
                         for name in params)
    if release_has_bn and not model.use_batchnorm:
        # the opposite of the retrofit below: dropping a release's
        # TRAINED normalization would import convs whose activations are
        # wrong at every layer — a silently-garbage model. Fail loudly;
        # the caller should build the model with use_batchnorm=True
        # (ferPlusZoo.m reads the structure from the dag itself).
        raise ValueError(
            f"{mat_path}: release carries BatchNorm params but the model "
            "was built with use_batchnorm=False — import would silently "
            "discard the trained normalization; build with "
            "use_batchnorm=True")
    layer_map = vggface_layer_map(
        model.arch,
        use_batchnorm=model.use_batchnorm and release_has_bn)
    tree = import_variables(params, layer_map)
    if model.use_batchnorm and not release_has_bn:
        for path, spec in vggface_layer_map(
                model.arch, use_batchnorm=True).items():
            if spec["kind"] != "bn" or not path.startswith("bn_"):
                continue
            conv = tree["params"].get(path[len("bn_"):])
            if conv is None:
                continue
            c = int(np.asarray(conv["kernel"]).shape[-1])
            bias = conv.pop("bias", None)  # bias-free convs under BN
            mean = (np.zeros(c, np.float32) if bias is None
                    else -np.asarray(bias, np.float32).reshape(-1))
            tree["params"][path] = {"scale": np.ones(c, np.float32),
                                    "bias": np.zeros(c, np.float32)}
            # var = 1 - eps so eval-mode sqrt(var + eps) == 1 exactly
            # (same convention as bn_variables' sigma^2 - eps)
            tree["batch_stats"][path] = {
                "mean": mean,
                "var": np.full(c, 1.0 - BN_EPSILON, np.float32)}
    return tree
