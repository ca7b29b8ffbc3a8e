"""The port's classic VGG face teachers, surgery and teacher zoo against the
JAX package's, on the CPU.

- ``VGGFace`` 'vd' (at 64: fc6 over 2x2) and 'm' (at 96: fc6 over 2x2),
  with and without BatchNorm, at width 1/16 and fc 64, the seeded Flax
  weights of ``random_vggface_variables`` carried across by the bridge:
  eval logits (fp32), and train-mode logits and updated running statistics
  with and without a ragged ``pad_mask`` (two of five rows padding; with
  BatchNorm in float64 on both sides, the head fp32 as the modules fix
  it: the fast batch variance of three rows cancels in fp32), each within
  1e-5 x the reference's largest magnitude of Flax at HIGHEST precision;
  the embedding too. The eval fast path (``fused_forward``: bias-free
  convs, fc6 and fc7 as GEMMs on the NHWC-flattened activations, the
  epilogues' plain versions on a CPU tensor) is held to Flax's eval logits
  the same way.
- Geometry: ``fc6_extent`` is 7 (VD) and 6 (VGG-M) at 224, as Flax's
  lazily sized fc6 kernel; VGG-M's [0 1 0 1] pool is ``stem_pool``, equal
  to Flax's padded pool at the released sizes 109, 54, 26 and 13 and at
  small even and odd sizes.
- ``surgery``: ``reinit_head`` keeps the head's rank, zeroes the bias and
  draws normal(scale) from its seed; ``transplant_backbone`` copies all but
  the skipped modules and refuses a shape mismatch; ``strip_collections``
  splits parameters from running statistics.
- ``build_teacher``: every name of ``TEACHER_MODELS``, ``VGGFACE2_MODELS``,
  ``CLASSIC_MODELS`` and ``resnet50-face-sfew`` gives the parameter shapes
  of the JAX zoo's module (full width through ``jax.eval_shape``, and tiny),
  with useBnorm both ways.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.models import surgery
from mcncrossmodalemotions_torch.models.resnet import stem_pool
from mcncrossmodalemotions_torch.models.vggface import VGGFace, fc6_extent
from mcncrossmodalemotions_torch.zoo import (
    CLASSIC_MODELS,
    TEACHER_MODELS,
    VGGFACE2_MODELS,
    build_teacher,
    random_vggface_variables,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.models.vggface import VGGFace as JVGGFace
from mcncrossmodalemotions_tpu.zoo import registry as jregistry

TINY = dict(width_multiplier=1 / 16, fc_features=64)
SIZE = {"vd": 64, "m": 96}
RTOL = 1e-5


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * float(np.abs(ref).max()), (what, err)


def _run(arch, bn, train, pad_mask, fused=False):
    size = SIZE[arch]
    v = random_vggface_variables(seed=3, arch=arch, use_batchnorm=bn,
                                 input_size=size, **TINY)
    x = (np.random.RandomState(size).randn(5, size, size, 3) * 50).astype(
        np.float32)
    # train mode in float64 on both sides: the batch variance E[x^2] -
    # E[x]^2 of a few rows cancels, and fp32's summation order then moves
    # the normalised values by up to 1e-4 of the logits
    wide = train and bn
    jdt, tdt = (jnp.float64, torch.float64) if wide else (jnp.float32,
                                                          torch.float32)
    jm = JVGGFace(arch=arch, use_batchnorm=bn, dtype=jdt, param_dtype=jdt,
                  **TINY)
    kw = {} if pad_mask is None else {"pad_mask": jnp.asarray(pad_mask)}
    with jax.enable_x64(wide), jax.default_matmul_precision("highest"):
        jv = jax.tree.map(lambda a: jnp.asarray(a, jdt), v)
        if train:
            (jl, jemb), mutated = jm.apply(jv, jnp.asarray(x), train=True,
                                           return_embedding=True,
                                           mutable=["batch_stats"], **kw)
            mutated = jax.tree.map(np.asarray, mutated)
        else:
            jl, jemb = jm.apply(jv, jnp.asarray(x), return_embedding=True)
            mutated = {}
    tm = VGGFace(arch, use_batchnorm=bn, dtype=tdt, input_size=size, **TINY)
    tm.load_state_dict(teacher_state_dict_from_flax(v), strict=True)
    tm = tm.to(tdt)
    tkw = {} if pad_mask is None else {"pad_mask": torch.from_numpy(pad_mask)}
    with torch.no_grad():
        if fused:
            tl, temb = tm.fused_forward(torch.from_numpy(x),
                                        return_embedding=True)
            assert tm.prepared.builds == 1
        else:
            tl, temb = tm(torch.from_numpy(x), train=train,
                          return_embedding=True, **tkw)
    want = teacher_state_dict_from_flax(dict(v, **mutated))
    return (np.asarray(jl), np.asarray(jemb), tl.numpy(), temb.numpy(),
            tm.state_dict(), want, v)


@pytest.mark.parametrize("arch", ["vd", "m"])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("mode", ["eval", "train", "train-ragged", "fused"])
def test_vggface_matches_flax(arch, bn, mode):
    mask = (np.float32([1, 0, 1, 1, 0]) if mode == "train-ragged" else None)
    train = mode.startswith("train")
    jl, jemb, tl, temb, got, want, before = _run(arch, bn, train, mask,
                                                 fused=mode == "fused")
    _close(tl, jl, "logits")
    _close(temb, jemb, "embedding")
    assert float(np.abs(jl).std()) > 0.1  # logits worth comparing
    stats = [k for k in want if "running_" in k]
    assert bool(stats) == bn
    for key in stats:
        _close(got[key].numpy(), want[key].numpy(), key)
        if train:  # the statistics moved
            old = teacher_state_dict_from_flax(before)[key].numpy()
            assert np.abs(got[key].numpy() - old).max() > 1e-3, key


@pytest.mark.parametrize("arch,extent", [("vd", 7), ("m", 6)])
def test_fc6_extent_is_flax_fc6_kernel_at_224(arch, extent):
    assert fc6_extent(arch, 224) == extent
    shapes = jax.eval_shape(JVGGFace(arch=arch).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    assert shapes["params"]["fc6"]["kernel"].shape[:2] == (extent, extent)
    with torch.device("meta"):
        assert tuple(VGGFace(arch).fc6.weight.shape[2:]) == (extent, extent)


@pytest.mark.parametrize("size", [109, 54, 26, 13, 2, 3, 4, 5])
def test_vggm_pool_is_the_padded_flax_pool(size):
    x = torch.randn(2, 3, size, size + 1)
    got = stem_pool(x).permute(0, 2, 3, 1).numpy()
    ref = fnn.max_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), (3, 3),
                       strides=(2, 2), padding=((0, 1), (0, 1)))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_reinit_head_keeps_rank_and_draws_from_its_seed():
    state = {"teacher.conv1.weight": torch.ones(4, 3, 7, 7),
             "teacher.prediction.weight": torch.ones(20, 2048),
             "teacher.prediction.bias": torch.ones(20)}
    out = surgery.reinit_head(state, 8, seed=5, scale=0.01)
    w = out["teacher.prediction.weight"]
    assert w.shape == (8, 2048) and w.dtype == torch.float32
    assert torch.equal(out["teacher.prediction.bias"], torch.zeros(8))
    assert abs(float(w.std()) - 0.01) < 5e-4 and abs(float(w.mean())) < 5e-4
    assert out["teacher.conv1.weight"] is state["teacher.conv1.weight"]
    assert torch.equal(surgery.reinit_head(state, 8, seed=5, scale=0.01)[
        "teacher.prediction.weight"], w)
    assert not torch.equal(surgery.reinit_head(state, 8, seed=6, scale=0.01)[
        "teacher.prediction.weight"], w)
    conv = surgery.reinit_head({"fc8.weight": torch.ones(10, 64, 1, 1),
                                "fc8.bias": torch.ones(10)}, 3, seed=0,
                               head_name="fc8")
    assert conv["fc8.weight"].shape == (3, 64, 1, 1)
    with pytest.raises(KeyError):
        surgery.reinit_head({"conv1.weight": torch.ones(1)}, 3, seed=0)


def test_transplant_backbone_and_strip_collections():
    target = VGGFace("m", num_outputs=8, input_size=48, **TINY).state_dict()
    source = VGGFace("m", num_outputs=20, input_size=48, use_batchnorm=True,
                     **TINY).state_dict()
    source = {k: v + 1 for k, v in source.items()}
    out = surgery.transplant_backbone(target, source)
    assert torch.equal(out["conv1.weight"], source["conv1.weight"])
    assert out["prediction.weight"].shape == (8, 8)  # the head skipped
    assert torch.equal(out["prediction.weight"], target["prediction.weight"])
    assert "bn_conv1.weight" not in out  # only what the target holds
    bad = dict(source, **{"conv1.weight": torch.ones(1, 2, 3, 4)})
    with pytest.raises(ValueError, match="conv1.weight"):
        surgery.transplant_backbone(target, bad)
    params = surgery.strip_collections(source, keep=("params",))
    stats = surgery.strip_collections(source, keep=("batch_stats",))
    assert set(params) | set(stats) == set(source)
    assert not set(params) & set(stats)
    assert "bn_conv1.running_var" in stats and "bn_conv1.weight" in params
    assert surgery.strip_collections(source) == source


def _flax_shapes_as_port(tree, prefix=""):
    """{port key: shape} of a Flax params/batch_stats shape tree."""
    out = {}
    for coll in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(tree.get(coll, {}))[0]
        for path, leaf in flat:
            names = [p.key for p in path]
            key, name = ".".join(names[:-1]), names[-1]
            s = tuple(leaf.shape)
            if name == "kernel":
                out[f"{key}.weight"] = ((s[3], s[2], s[0], s[1]) if len(s) == 4
                                        else (s[1], s[0]))
            elif name == "scale":
                out[f"{key}.weight"] = s
            elif name in ("mean", "var"):
                out[f"{key}.running_{name}"] = s
            else:
                out[f"{key}.{name}"] = s
    return out


_NAMES = TEACHER_MODELS + VGGFACE2_MODELS + CLASSIC_MODELS + (
    "resnet50-face-sfew",)


@pytest.mark.parametrize("tiny", [True, False])
def test_build_teacher_shapes_equal_jax(tiny):
    size = 64 if tiny else 224
    shapes = {}  # JAX module -> its shape tree (one trace a distinct module)
    for name in _NAMES:
        for use_bnorm in ((None, True, False) if name in CLASSIC_MODELS
                          else (None,)):
            jm = jregistry.build_teacher(name, num_outputs=7, dropout=0.5,
                                         use_bnorm=use_bnorm, tiny=tiny)
            if jm not in shapes:
                shapes[jm] = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3)))
            with torch.device("meta"):  # shapes only, no weights drawn
                tm = build_teacher(name, num_outputs=7, dropout=0.5,
                                   use_bnorm=use_bnorm, tiny=tiny,
                                   input_size=size)
            assert tm.dropout_rate == 0.5
            got = {k: tuple(v.shape) for k, v in tm.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
            assert got == _flax_shapes_as_port(shapes[jm]), (name, use_bnorm)
    assert len(shapes) == 6  # ResNet50, SENet50, VD +-BN, VGG-M +-BN
