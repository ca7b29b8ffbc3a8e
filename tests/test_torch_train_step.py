"""Port parity: three SGD train steps of the student against the JAX step.

The ``_numerics_probe`` recipe (``bench.py``): the tiny student
(fc6 64, fc7 32, 100 frames; the JAX pipeline fixes its student to bf16,
so both sides take the bare student on the same spectrogram batch, made by
the JAX frontend), Flax's scratch init carried into the port by the
bridge, hot-cross-ent at T=2 on a fixed batch, three steps. The lr changes
at every step (1e-2, 5e-3, 2e-3): ``torch.optim.SGD``, which folds lr into
its buffer, would drift from the reference there. The JAX side runs at
HIGHEST matmul precision.

The whole state is compared in float64 on both sides (JAX under
``enable_x64``; the head, pool6 and the gradients fed to the update stay
fp32 on both, as the modules fix them), with weight decay 5e-4 and 0. In
fp32 the two frameworks' forward values differ by rounding (up to ~5e-5
after the batch-of-2 BatchNorms), so a ReLU input or a pool window that
close to a tie goes the other way on one side, and the gradient it sends
elsewhere moves sums that the next BatchNorm drives towards 0: velocity
then differs by up to 3e-2 relative L2 at this size, which says nothing
about the port. In float64 no such flip happens. The fp32 case holds the
losses only.

Tolerances:

- losses: rtol 1e-5 (float64 and fp32);
- float64: every tensor of parameters, running statistics and velocity
  after step 3, the zero-init ones included, within rtol 1e-4 elementwise
  plus an atol of 1e-4 times the reference tensor's largest magnitude.
  Measured: at most 1.7e-6 of that magnitude; without the weight decay the
  velocity is off by 0.98 of it, and ``torch.optim.SGD``'s rule by 0.64.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.models.vggm import VGGMStudent as JaxVGGM
from mcncrossmodalemotions_tpu.ops.spectrogram import DEFAULT_SPEC, waveform_to_input
from mcncrossmodalemotions_tpu.train import state as jstate
from mcncrossmodalemotions_tpu.zoo import student_loss_fn as jax_loss_fn
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.zoo import (
    build_student,
    student_loss_fn,
    student_params_from_flax,
    student_state_dict_from_flax,
)

TINY = dict(fc6_features=64, fc7_features=32)
LRS = (1e-2, 5e-3, 2e-3)
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    wav = rng.randn(2, DEFAULT_SPEC.crop_samples(100)).astype(np.float32) * 0.1
    with jax.default_matmul_precision("highest"):
        spec = np.asarray(waveform_to_input(jnp.asarray(wav)))
    return {"data": spec,
            "logit_target": rng.randn(2, 8).astype(np.float32) * 2,
            "max_label": rng.randint(0, 8, 2).astype(np.int32)}


@pytest.fixture(scope="module")
def init(batch):
    """Flax's fp32 scratch init, as numpy."""
    variables = JaxVGGM(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["data"]))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_run(batch, init, dtype, wd):
    """Three JAX steps in ``dtype``; returns (state dict, velocity, losses)
    mapped to the port's names."""
    with jax.enable_x64(dtype == jnp.float64), \
            jax.default_matmul_precision("highest"):
        model = JaxVGGM(dtype=dtype, param_dtype=dtype, **TINY)
        state = jstate.TrainState.create(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), init),
            jax.random.PRNGKey(1))
        step = jax.jit(jstate.make_train_step(
            model.apply, jax_loss_fn("hot-cross-ent", temperature=2.0),
            jstate.SGDConfig(weight_decay=wd)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = []
        for lr in LRS:
            state, m = step(state, jb, lr)
            losses.append(float(m["loss"]))
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {"params": state.params, "velocity": state.velocity,
             "batch_stats": state.model_state["batch_stats"]})
    want = student_state_dict_from_flax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    return want, student_params_from_flax(tree["velocity"]), np.asarray(losses)


def _port_run(batch, init, dtype, wd):
    model = VGGMStudent(dtype=dtype, **TINY)
    model.load_state_dict(student_state_dict_from_flax(init))
    state = tstate.TrainState.create(model.to(dtype),
                                     torch.Generator().manual_seed(1))
    step = tstate.make_train_step(student_loss_fn("hot-cross-ent", temperature=2.0),
                                  tstate.SGDConfig(weight_decay=wd))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    losses = []
    for lr in LRS:
        state, m = step(state, tb, lr)
        losses.append(m["loss"].item())
    return state, np.asarray(losses)


def _close(got: torch.Tensor, ref: torch.Tensor, key: str):
    ref = ref.double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("dtype,wd", [("float64", 5e-4), ("float64", 0.0),
                                      ("float32", 5e-4)])
def test_three_steps_match_jax(batch, init, dtype, wd):
    jdtype, tdtype = DTYPES[dtype]
    want, vel, jlosses = _jax_run(batch, init, jdtype, wd)
    st, tlosses = _port_run(batch, init, tdtype, wd)
    assert st.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert jlosses[2] < jlosses[0]  # the steps did train
    if dtype == "float32":
        return  # fp32 near-tie flips: the state is held in float64
    got = st.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key)
    assert sorted(vel) == sorted(st.velocity)
    for key in vel:
        assert vel[key].abs().max() > 0, key
        _close(st.velocity[key], vel[key], f"velocity {key}")


def test_sgd_update_is_the_matconvnet_rule():
    """v = m v - lr s (g + wd p); p += v, with a per-step lr and the
    finetune lr scale on the backbone."""
    model = torch.nn.Linear(3, 2)
    state = tstate.TrainState.create(model, torch.Generator())
    sgd = tstate.SGDConfig(momentum=0.9, weight_decay=0.1)
    scale = tstate.finetune_lr_scale_fn(head_names=("bias",), backbone_scale=0.5)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    g = {k: torch.full_like(v, 2.0) for k, v in p0.items()}
    tstate.apply_sgd_update(state, g, 0.1, sgd, scale)
    tstate.apply_sgd_update(state, g, 0.01, sgd, scale)
    for k, p in model.named_parameters():
        s = 1.0 if k == "bias" else 0.5
        v1 = -0.1 * s * (2.0 + 0.1 * p0[k])
        p1 = p0[k] + v1
        v2 = 0.9 * v1 - 0.01 * s * (2.0 + 0.1 * p1)
        torch.testing.assert_close(state.velocity[k], v2)
        torch.testing.assert_close(p.detach(), p1 + v2)


def test_scratch_init_has_flax_std():
    """Per layer, the port's init std is within 5% of Flax's initializer
    drawn at the layer's fan-in (full widths: init only, no forward)."""
    model = build_student(with_frontend=False,
                          generator=torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    for i, (name, layer) in enumerate(model.convs() + [("fc7", model.fc7),
                                                       ("prediction",
                                                        model.prediction)]):
        w = layer.weight.detach()
        fan_in = int(np.prod(w.shape[1:]))
        init = (fnn.initializers.normal(model.head_init_scale)
                if name == "prediction" else fnn.initializers.lecun_normal())
        ref = np.asarray(init(jax.random.fold_in(key, i),
                              (fan_in, max(2_000_000 // fan_in, 8))))
        assert abs(float(w.std()) / ref.std() - 1) < 0.05, name
        if name != "prediction":  # truncated at 2 stddev of the draw
            assert float(w.abs().max()) <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796
        if layer.bias is not None:
            assert float(layer.bias.detach().abs().max()) == 0.0
    for i in range(1, 7):
        bn = getattr(model, f"bn{i}")
        assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
        assert torch.all(bn.running_mean == 0) and torch.all(bn.running_var == 1)


def test_euclidean_head_and_bnorm_free_student():
    a = build_student(with_frontend=False, tiny=True, loss_type="euclidean")
    assert a.head_init_scale == pytest.approx(1e-5)
    b = build_student(with_frontend=False, tiny=True, use_bnorm=False)
    assert not hasattr(b, "bn1") and b.conv1.bias is not None
    with pytest.raises(ValueError):
        build_student(use_bnorm=False)  # the pipeline always has BatchNorm
    out = b(torch.randn(2, 512, 100, 1), train=True)
    assert out.shape == (2, 8)


def test_remat_policy_names_resolve_as_jax():
    """The JAX package's remat policy names are accepted and an unknown
    one is refused, as ``jax``'s ``resolve_remat_policy`` refuses it (the
    policies themselves: ``tests/test_torch_remat.py``)."""
    assert tstate.resolve_remat_policy(None) is None
    assert tstate.resolve_remat_policy("none") is None
    assert jstate.resolve_remat_policy("none") is None
    for name in ("drop_conv1", "drop_through_pool1", "save_pools", "dots",
                 "nothing"):
        assert jstate.resolve_remat_policy(name) is not None
        assert tstate.resolve_remat_policy(name) == name
        tstate.make_train_step(student_loss_fn(), remat_policy=name)
    for mod in (tstate, jstate):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.resolve_remat_policy("drop_everything")


def test_dropout_draws_from_the_state_generator():
    """Train-mode dropout is reproducible from the generator's seed and is
    off in eval."""
    model = build_student(with_frontend=False, tiny=True, dropout=0.5,
                          dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 512, 100, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = [model(x, train=True, return_embedding=True,
                      generator=torch.Generator().manual_seed(s))
                for s in (3, 3, 4)]
        ev = [model(x) for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(ev[0], ev[1])
    with pytest.raises(ValueError):
        model(x, train=True)  # no generator: no silent global RNG
