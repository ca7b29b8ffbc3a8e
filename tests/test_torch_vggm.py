"""Port parity: the VGG-M student and the weight bridge against the JAX module.

Both packages get the same seeded weights (``random_student_variables``,
randomised BatchNorm statistics and scales) and the same numpy input.
The JAX side runs at HIGHEST matmul precision for the fp32 comparison:
JAX CPU matmuls and convs otherwise default to bf16 passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_tpu.models.vggm import (
    temporal_valid_frames as jax_valid_frames,
)
from mcncrossmodalemotions_tpu.zoo import build_student as jax_build_student
from mcncrossmodalemotions_torch.models.vggm import (
    VGGMStudent,
    temporal_valid_frames,
)
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    random_student_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
)

TINY = dict(fc6_features=64, fc7_features=32)


@pytest.fixture(scope="module")
def jax_tiny_variables():
    """The tiny JAX student's variable tree (shapes from ``eval_shape``,
    so nothing compiles), filled with seeded numpy values."""
    model = jax_build_student(tiny=True, with_frontend=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 512, 100, 1)))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def test_bridge_maps_every_leaf(jax_tiny_variables):
    state = student_state_dict_from_flax(jax_tiny_variables)
    model = build_student(tiny=True, with_frontend=False)
    ref = model.state_dict()
    assert sorted(state) == sorted(ref)
    for key, value in ref.items():
        assert state[key].shape == value.shape, key
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        model.conv1.weight.detach().numpy(),
        jax_tiny_variables["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.fc7.weight.detach().numpy(),
        jax_tiny_variables["params"]["fc7"]["kernel"].T)


def test_bridge_nested_pipeline_variables():
    """Variables nested under 'net' (the JAX pipeline) map to the port
    pipeline's ``net.`` keys, and the seeded layout matches flax's."""
    jax_pipe = jax_build_student(tiny=True, with_frontend=True)
    jv = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(jax_pipe.init, jax.random.PRNGKey(1),
                       jnp.zeros((1, 16384))))
    rv = random_student_variables(seed=1, fc6=64, fc7=32)
    assert (jax.tree_util.tree_map(np.shape, rv)
            == jax.tree_util.tree_map(np.shape, {
                "params": jv["params"]["net"],
                "batch_stats": jv["batch_stats"]["net"]}))
    pipe = build_student(tiny=True, with_frontend=True)
    pipe.load_state_dict(student_state_dict_from_flax(jv), strict=True)


def test_bridge_refuses_unmapped_and_missing_leaves():
    v = random_student_variables(seed=0, fc6=64, fc7=32)
    v["params"]["conv1"]["bias"] = np.zeros(96, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        student_state_dict_from_flax(v)
    v = random_student_variables(seed=0, fc6=64, fc7=32)
    del v["batch_stats"]["bn3"]["var"]
    with pytest.raises(KeyError, match="bn3/var"):
        student_state_dict_from_flax(v)


@pytest.mark.parametrize("nested", [False, True])
def test_bridge_maps_a_params_only_tree_to_parameter_names(nested):
    """A tree without batch_stats (the JAX TrainState.velocity) maps to the
    port's parameter names, every leaf consumed."""
    v = random_student_variables(seed=2, fc6=64, fc7=32)["params"]
    tree = {"net": v} if nested else v
    got = student_params_from_flax(tree)
    model = build_student(tiny=True, with_frontend=nested)
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert got[name].shape == p.shape, name
    prefix = "net." if nested else ""
    np.testing.assert_array_equal(got[prefix + "conv2.weight"].numpy(),
                                  v["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got[prefix + "bn4.bias"].numpy(),
                                  v["bn4"]["bias"])


def test_bridge_params_only_refuses_unmapped_and_missing_leaves():
    v = random_student_variables(seed=0, fc6=64, fc7=32)["params"]
    v["fc7"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        student_params_from_flax(v)
    v = random_student_variables(seed=0, fc6=64, fc7=32)["params"]
    del v["bn2"]["scale"]
    with pytest.raises(KeyError, match="bn2/scale"):
        student_params_from_flax(v)
    with pytest.raises(KeyError, match="unmapped"):  # stats are not params
        student_params_from_flax(
            dict(random_student_variables(seed=0, fc6=64, fc7=32)["params"],
                 bn9={"mean": np.zeros(2)}))


def test_bridge_maps_a_batchnorm_free_student():
    jm = JaxVGGM(use_batchnorm=False, **TINY)
    jv = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 100, 1))))
    assert "batch_stats" not in jv
    tm = build_student(tiny=True, with_frontend=False, use_bnorm=False)
    tm.load_state_dict(student_state_dict_from_flax(jv), strict=True)


def _forward_pair(dtype_jax, dtype_torch, highest: bool):
    variables = random_student_variables(seed=3, fc6=64, fc7=32)
    x = np.random.RandomState(3).randn(2, 512, 100, 1).astype(np.float32)
    valid = np.array([100, 60], np.int32)
    jm = JaxVGGM(dtype=dtype_jax, **TINY)
    if highest:
        with jax.default_matmul_precision("highest"):
            jl, je = jm.apply(variables, jnp.asarray(x), valid_frames=valid,
                              return_embedding=True)
    else:
        jl, je = jm.apply(variables, jnp.asarray(x), valid_frames=valid,
                          return_embedding=True)
    tm = VGGMStudent(dtype=dtype_torch, **TINY).eval()
    tm.load_state_dict(student_state_dict_from_flax(variables))
    with torch.inference_mode():
        tl, te = tm(torch.from_numpy(x), valid_frames=torch.from_numpy(valid),
                    return_embedding=True)
    return (np.asarray(jl), np.asarray(je, np.float32), tl.numpy(), te.numpy())


def test_vggm_fp32_forward_matches_jax():
    jl, je, tl, te = _forward_pair(jnp.float32, torch.float32, highest=True)
    scale = np.abs(jl).max()
    assert tl.shape == jl.shape == (2, 8)
    assert scale > 0.1  # seeded head gives O(1) logits, not ~1e-4
    assert np.abs(tl - jl).max() <= 1e-4 * scale
    assert np.abs(te - je).max() <= 1e-4 * np.abs(je).max()


def test_vggm_bf16_forward_matches_jax():
    jl, je, tl, te = _forward_pair(jnp.bfloat16, torch.bfloat16, highest=False)
    assert np.all(np.isfinite(tl))
    assert np.abs(tl - jl).max() <= 3e-2 * np.abs(jl).max()


def test_pipeline_matches_jax():
    """Waveform -> logits through both pipelines (bf16 students, as the
    JAX pipeline builds its student), with valid_frames masking."""
    v = random_student_variables(seed=4, fc6=64, fc7=32)
    nested = {"params": {"net": v["params"]},
              "batch_stats": {"net": v["batch_stats"]}}
    x = np.random.RandomState(4).randn(2, 19584).astype(np.float32)
    valid = np.array([120, 100], np.int32)
    jl = np.asarray(jax_build_student(tiny=True).apply(
        nested, jnp.asarray(x), valid_frames=valid))
    pipe = build_student(tiny=True).eval()
    pipe.load_state_dict(student_state_dict_from_flax(nested))
    with torch.inference_mode():
        tl = pipe(torch.from_numpy(x), valid_frames=torch.from_numpy(valid))
    assert tl.shape == jl.shape == (2, 8)
    assert np.abs(tl.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()


def test_temporal_valid_frames_matches_jax():
    widths = np.arange(100, 2001)
    got = temporal_valid_frames(torch.from_numpy(widths)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_valid_frames(widths)))
    assert temporal_valid_frames(400) == 11


def test_build_student_widths_match_jax():
    for tiny in (False, True):
        jm = jax_build_student(tiny=tiny, with_frontend=False)
        tm = build_student(tiny=tiny, with_frontend=False)
        assert tm.fc6.out_channels == jm.fc6_features
        assert tm.fc7.out_features == jm.fc7_features
        assert tm.prediction.out_features == jm.num_outputs
    with pytest.raises(KeyError):
        build_student("resnet50-ferplus")
