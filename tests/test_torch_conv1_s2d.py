"""Port parity: the space-to-depth conv1 (``SpaceToDepthConv1``,
``conv1_s2d``) against the JAX module and against the plain conv1.

The counterparts of ``tests/test_models.py::test_conv1_s2d_matches_plain_conv``
and ``::test_conv1_s2d_init_equals_plain_init``, and more:

- the port's ``SpaceToDepthConv1`` against the JAX one on the same numpy
  kernel and input: the forward and the gradients of the input and of the
  canonical ``[7, 7, Cin, 96]`` kernel within 1e-5 relative in float32
  (JAX at HIGHEST matmul precision). Cin 3 as well as 1: the two packages
  order the regrouped channels differently (the port's is
  ``F.pixel_unshuffle``'s), which must not show;
- the same function as the port's plain conv1 within 1e-10 in float64, and
  the plain conv itself on odd heights or widths (the 2x2 grid does not
  tile there);
- one ``state_dict`` layout and the same init draws under both settings,
  in the bare student and the pipeline; ``_bare_student_for`` keeps the
  pipeline's conv1 form;
- a tiny ``VGGMStudent(conv1_s2d=True)`` trained three SGD steps against
  JAX's (whose default conv1 is the space-to-depth one) in float64, as
  ``test_torch_train_step.py`` compares the plain student.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcncrossmodalemotions_tpu.models.vggm import (
    SpaceToDepthConv1 as JaxS2D,
    VGGMStudent as JaxVGGM,
)
from mcncrossmodalemotions_tpu.ops.spectrogram import DEFAULT_SPEC, waveform_to_input
from mcncrossmodalemotions_tpu.train import state as jstate
from mcncrossmodalemotions_tpu.zoo import student_loss_fn as jax_loss_fn
from mcncrossmodalemotions_torch.bench import train_step_setup
from mcncrossmodalemotions_torch.exp.run_distillation import _bare_student_for
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import (
    SpaceToDepthConv1,
    VGGMStudent,
    space_to_depth,
)
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    student_loss_fn,
    student_params_from_flax,
    student_state_dict_from_flax,
)

TINY = dict(fc6_features=64, fc7_features=32)
LRS = (1e-2, 5e-3, 2e-3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("cin", [1, 3])
def test_space_to_depth_conv1_matches_jax(cin):
    rng = np.random.RandomState(cin)
    x = rng.randn(2, 22, 30, cin).astype(np.float32)  # NHWC, even extents
    kernel = (rng.randn(7, 7, cin, 96) * 0.05).astype(np.float32)
    out_hw = (8, 12)
    g = rng.randn(2, *out_hw, 96).astype(np.float32)  # the cotangent

    jmod = JaxS2D(features=96, dtype=jnp.float32)
    jvars = {"params": {"kernel": jnp.asarray(kernel)}}

    def jloss(xx, kk):
        y = jmod.apply({"params": {"kernel": kk}}, xx)
        return jnp.sum(y * g), y

    with jax.default_matmul_precision("highest"):
        (_, jy), (jgx, jgk) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jnp.asarray(x), jvars["params"]["kernel"])

    conv = SpaceToDepthConv1(cin, 96)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    ty = conv(tx)
    gx, gw = torch.autograd.grad(
        ty, (tx, conv.weight), torch.from_numpy(g.transpose(0, 3, 1, 2)))
    assert tuple(ty.shape) == (2, 96, *out_hw)
    _close(ty.detach().permute(0, 2, 3, 1).numpy(), jy, 1e-5, "y")
    _close(gx.permute(0, 2, 3, 1).numpy(), jgx, 1e-5, "dx")
    _close(gw.permute(2, 3, 1, 0).numpy(), jgk, 1e-5, "dkernel")


def test_space_to_depth_is_pixel_unshuffle_in_channels_last():
    x = torch.randn(2, 3, 8, 6).contiguous(memory_format=torch.channels_last)
    z = space_to_depth(x)
    assert torch.equal(z, F.pixel_unshuffle(x, 2))
    assert z.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [(32, 40), (33, 40), (32, 41), (31, 29)])
def test_space_to_depth_conv1_is_the_plain_conv(hw):
    """float64, against the plain 7x7/2 conv; odd H or W takes the plain
    conv (the 2x2 grid does not tile)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, *hw, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    conv = SpaceToDepthConv1(1, 96, bias=True).double()
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    y = conv(x)
    ref = F.conv2d(x, conv.weight, conv.bias, 2)
    assert y.shape == ref.shape
    g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    grads = torch.autograd.grad(y, (x, conv.weight, conv.bias), g)
    want = torch.autograd.grad(ref, (x, conv.weight, conv.bias), g)
    for a, b in zip((y, *grads), (ref, *want)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_one_state_dict_layout_and_init():
    """Same keys, shapes and init draws under both settings (bare student
    and pipeline); the bench's step builds ``build_student``'s pipeline;
    ``_bare_student_for`` keeps the pipeline's conv1 form."""
    def state(cls, **kw):
        return cls(generator=torch.Generator().manual_seed(7), **TINY,
                   **kw).state_dict()

    for cls in (VGGMStudent, AudioStudentPipeline):
        a, b = state(cls, conv1_s2d=True), state(cls, conv1_s2d=False)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    built = build_student(tiny=True, generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(v, built.state_dict()[k])
               for k, v in state(AudioStudentPipeline, conv1_s2d=True).items())
    _, st, _ = train_step_setup("cpu", batch_size=1, num_frames=100,
                                tiny=True, conv1_s2d=True)
    ref = build_student(tiny=True, generator=torch.Generator().manual_seed(0))
    assert isinstance(st.model.net.conv1, SpaceToDepthConv1)
    for k, v in ref.state_dict().items():
        assert torch.equal(st.model.state_dict()[k], v), k
    for flag in (True, False):
        bare = _bare_student_for(AudioStudentPipeline(conv1_s2d=flag, **TINY))
        assert isinstance(bare, VGGMStudent) and bare.conv1_s2d is flag
        assert isinstance(bare.conv1, SpaceToDepthConv1) is flag


@pytest.mark.parametrize("frames", [100, 99])
def test_student_logits_s2d_equal_plain(frames):
    """The tiny student's train- and eval-mode logits under both conv1
    forms on the same weights, in float64 (an odd width takes the plain
    conv in both)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 512, frames, 1, generator=gen, dtype=torch.float64)
    plain = VGGMStudent(dtype=torch.float64, **TINY).double()
    s2d = VGGMStudent(dtype=torch.float64, conv1_s2d=True, **TINY).double()
    s2d.load_state_dict(plain.state_dict())
    for train in (False, True):
        torch.testing.assert_close(s2d(x, train=train), plain(x, train=train),
                                   rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    wav = rng.randn(2, DEFAULT_SPEC.crop_samples(100)).astype(np.float32) * 0.1
    with jax.default_matmul_precision("highest"):
        spec = np.asarray(waveform_to_input(jnp.asarray(wav)))
    return {"data": spec,
            "logit_target": rng.randn(2, 8).astype(np.float32) * 2,
            "max_label": rng.randint(0, 8, 2).astype(np.int32)}


def test_s2d_train_steps_match_jax_in_float64(batch):
    """Three SGD steps (weight decay 5e-4) of the tiny space-to-depth
    student, both packages in float64 from Flax's scratch init: the losses
    within 1e-5 and every tensor of the state within 1e-4 (elementwise,
    plus 1e-4 of the tensor's largest magnitude), as
    ``test_torch_train_step.py`` holds the plain student."""
    assert batch["data"].shape[1:3] == (512, 100)  # even: the s2d path
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        model = JaxVGGM(dtype=jnp.float64, param_dtype=jnp.float64,
                        conv1_s2d=True, **TINY)
        init = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["data"]))
        init = jax.tree_util.tree_map(np.asarray, init)
        state = jstate.TrainState.create(init, jax.random.PRNGKey(1))
        step = jax.jit(jstate.make_train_step(
            model.apply, jax_loss_fn("hot-cross-ent", temperature=2.0),
            jstate.SGDConfig(weight_decay=5e-4)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jlosses = []
        for lr in LRS:
            state, m = step(state, jb, lr)
            jlosses.append(float(m["loss"]))
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {"params": state.params, "velocity": state.velocity,
             "batch_stats": state.model_state["batch_stats"]})
    want = student_state_dict_from_flax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    vel = student_params_from_flax(tree["velocity"])

    port = VGGMStudent(dtype=torch.float64, conv1_s2d=True, **TINY)
    port.load_state_dict(student_state_dict_from_flax(init))
    st = tstate.TrainState.create(port.double(), torch.Generator().manual_seed(1))
    tstep = tstate.make_train_step(
        student_loss_fn("hot-cross-ent", temperature=2.0),
        tstate.SGDConfig(weight_decay=5e-4))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tlosses = []
    for lr in LRS:
        st, m = tstep(st, tb, lr)
        tlosses.append(m["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert jlosses[2] < jlosses[0]
    got = st.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key].double().numpy(), want[key].double().numpy(), 1e-4, key)
    for key in vel:
        _close(st.velocity[key].double().numpy(), vel[key].double().numpy(),
               1e-4, f"velocity {key}")
