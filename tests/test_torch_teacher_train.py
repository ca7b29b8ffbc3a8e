"""The port's teacher train step against the JAX package's, on the CPU.

- Three SGD steps of the tiny SENet (``stage_sizes=(1, 1)``, ``width=8``)
  and the tiny VGG-M-bn (width 1/16, fc 64) through ``FaceTeacherPipeline``
  (48x48 uint8 faces resized to 64; fliplr and dropout off), each with the
  'distributions' and the 'softmaxlog' loss, weight decay 5e-4 and the
  finetune scale 0.1 on the backbone, a ragged ``pad_mask``: the whole
  state in float64 on both sides (JAX under ``enable_x64``, the head and
  the loss fp32 as the modules fix them), the reason
  ``tests/test_torch_train_step.py`` gives; the batch is warped to 64 on
  the host, so the pipeline's fp32 resize (another summation order in each
  framework) stays out. Tolerances: losses rtol 1e-5; every parameter,
  running statistic and velocity tensor after step 3 within rtol 1e-4 plus
  1e-4 of the reference tensor's largest magnitude. In fp32 the first
  step's loss alone (rtol 1e-5).
- A train-mode forward of the tiny ResNet/SENet, with and without a ragged
  ``pad_mask``: logits, embedding and updated running statistics within
  1e-5 x their scale of Flax.
- The fliplr with a given mask is numpy's flip of those rows; the drawn
  mask and the teachers' dropout keep their rates (binomial bounds at 6
  sigma) and dropout scales the kept values by 1 / (1 - rate).
- The full-width train golden (``tests/fixtures/
  torch_teacher_train_golden.npz``): SENet50 from
  ``random_teacher_variables(seed=0)``, two steps on chip_smoke's golden
  batch (48x48, resized to 224 in the pipeline), in the JAX package in
  float64 (float64 parameters), fp32 (HIGHEST) and bf16. The golden holds
  the float64 run's losses, head after the steps and a sample of every
  parameter's first update, and JAX's own fp32 and bf16 errors against
  it. The port's CPU runs (``chip_smoke.golden_train_run``) in float64,
  fp32 and bf16 are held to it at the card's gates
  (``chip_smoke.train_golden_errors``; float64 on the host's resize);
  planted faults of the step fail them, and a one-ulp change of the
  resized input fails float64's and keeps fp32's. Rewrite the
  golden (minutes: full-width JAX compiles on the CPU) with

      JAX_PLATFORMS=cpu python tests/test_torch_teacher_train.py --golden

  and recheck it with the ``slow`` test below, outside Tier-1.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.models import (
    FaceTeacherPipeline,
    ResNet,
    VGGFace,
)
from mcncrossmodalemotions_torch.models import SENet50 as TSENet50
from mcncrossmodalemotions_torch.models import resnet as tresnet
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    fliplr,
    random_flip,
)
from mcncrossmodalemotions_torch.train import state as tstate
from mcncrossmodalemotions_torch.zoo import (
    random_teacher_variables,
    random_vggface_variables,
    teacher_loss_fn,
    teacher_params_from_flax,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_tpu.models.resnet import ResNet as JResNet
from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
    FaceTeacherPipeline as JPipeline,
)
from mcncrossmodalemotions_tpu.models.vggface import VGGFace as JVGGFace
from mcncrossmodalemotions_tpu.train import state as jstate
from mcncrossmodalemotions_tpu.zoo import teacher_loss_fn as jteacher_loss_fn

import chip_smoke  # noqa: E402

GOLDEN = chip_smoke.TRAIN_GOLDEN
LRS = (1e-2, 5e-3, 2e-3)
FINETUNE = 0.1


TINY_RESNET = dict(stage_sizes=(1, 1), width=8)
TINY_VGG = dict(width_multiplier=1 / 16, fc_features=64)
RAGGED = np.float32([1, 1, 0, 1, 1, 0])  # two padding rows
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}
TAGS = {"fp64": torch.float64, "fp32": torch.float32, "bf16": torch.bfloat16}
_finetune = tstate.finetune_lr_scale_fn
_sgd = tstate.SGDConfig


def _nested(v):
    out = {"params": {"teacher": v["params"]}}
    if "batch_stats" in v:
        out["batch_stats"] = {"teacher": v["batch_stats"]}
    return out


def _float64_params(tree) -> dict:
    """``teacher_params_from_flax`` in float64: the bridge casts to fp32,
    so map each leaf's fp32 part and its fp32 remainder and add them."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    head = jax.tree.map(lambda a: a.astype(np.float32), tree)
    rest = jax.tree.map(lambda a, h: (a - h).astype(np.float32), tree, head)
    rest = teacher_params_from_flax(rest)
    return {n: h.double() + rest[n].double()
            for n, h in teacher_params_from_flax(head).items()}


def jax_golden_run(dtype) -> dict:
    """chip_smoke's golden run in the JAX package: the same weights, batch,
    loss and SGD, ``FaceTeacherPipeline(SENet50)`` at 224, augment off;
    the first update and the head as ``chip_smoke.golden_train_run``
    returns them."""
    from mcncrossmodalemotions_tpu.models.resnet import SENet50

    pdt = jnp.float64 if dtype == jnp.float64 else jnp.float32
    model = JPipeline(teacher=SENet50(num_outputs=8, dtype=dtype,
                                      param_dtype=pdt),
                      input_size=224, augment=False)
    batch = {k: jnp.asarray(v) for k, v in chip_smoke.golden_train_batch().items()}
    step = jax.jit(jstate.make_train_step(
        model.apply, jteacher_loss_fn("distributions"),
        jstate.SGDConfig(momentum=0.9, weight_decay=5e-4),
        lr_scale_fn=jstate.finetune_lr_scale_fn(
            backbone_scale=chip_smoke.GOLDEN_FINETUNE),
        pass_pad_mask=True))
    names = [n for n, _ in FaceTeacherPipeline(
        TSENet50(num_outputs=8)).named_parameters()]
    with jax.enable_x64(dtype == jnp.float64), \
            jax.default_matmul_precision("highest"):
        variables = jax.tree.map(lambda a: jnp.asarray(a, pdt), _nested(
            random_teacher_variables(seed=chip_smoke.SEED)))
        state = jstate.TrainState.create(variables, jax.random.PRNGKey(0))
        losses = []
        for i in range(chip_smoke.GOLDEN_STEPS):
            state, m = step(state, batch, chip_smoke.GOLDEN_LR)
            losses.append(float(m["loss"]))
            if i == 0:
                update = _float64_params(state.velocity)
        head = np.asarray(state.params["teacher"]["prediction"]["kernel"],
                          np.float64)
    return {"names": names, "losses": np.asarray(losses, np.float64),
            "update": chip_smoke.golden_sample({n: update[n] for n in names}),
            "head_kernel": head}


def golden_arrays() -> dict:
    """Everything the train golden holds, computed afresh: the batch, the
    parameter names, JAX's float64 run (losses, the first update's sample,
    cut at ``update_sizes``, and the head), and JAX's own errors against
    it in fp32 and bf16: the first loss's and the head's (absolute), and
    each parameter's first update's (relative L2)."""
    batch = chip_smoke.golden_train_batch()
    runs = {tag: jax_golden_run(dt) for tag, dt in
            (("fp64", jnp.float64), ("fp32", jnp.float32),
             ("bf16", jnp.bfloat16))}
    ref = runs["fp64"]
    out = {"data": batch["data"], "label_dist": batch["label_dist"],
           "names": np.asarray(ref["names"]),
           "update_sizes": np.asarray([len(u) for u in ref["update"]]),
           "losses_fp64": ref["losses"],
           "update_fp64": np.concatenate(ref["update"]),
           "head_kernel_fp64": ref["head_kernel"]}
    for tag in ("fp32", "bf16"):
        run = runs[tag]
        out[f"losses_{tag}"] = run["losses"]
        out[f"first_loss_jax_{tag}_err"] = np.float64(
            abs(run["losses"][0] - ref["losses"][0]))
        out[f"head_kernel_jax_{tag}_err"] = np.float64(
            np.abs(run["head_kernel"] - ref["head_kernel"]).max())
        out[f"update_rel_jax_{tag}"] = np.asarray(chip_smoke.leaf_errors(
            run["update"], out["update_fp64"], out["update_sizes"]))
    return out


def _tiny(kind: str, jdtype, tdtype):
    """(JAX pipeline, port pipeline, Flax variables) of a tiny teacher at
    input 64, fliplr off."""
    if kind == "senet":
        v = random_teacher_variables(seed=7, use_se=True, **TINY_RESNET)
        jt = JResNet(use_se=True, dtype=jdtype, param_dtype=jdtype,
                     **TINY_RESNET)
        tt = ResNet(use_se=True, dtype=tdtype, **TINY_RESNET)
    else:
        v = random_vggface_variables(seed=7, arch="m", use_batchnorm=True,
                                     input_size=64, **TINY_VGG)
        jt = JVGGFace(arch="m", use_batchnorm=True, dtype=jdtype,
                      param_dtype=jdtype, **TINY_VGG)
        tt = VGGFace("m", use_batchnorm=True, dtype=tdtype, input_size=64,
                     **TINY_VGG)
    return (JPipeline(teacher=jt, input_size=64, augment=False),
            FaceTeacherPipeline(tt, input_size=64, augment=False),
            _nested(v))


@pytest.fixture(scope="module")
def batch():
    from mcncrossmodalemotions_torch.data.ferplus import (
        build_synthetic_ferplus,
        ferplus_batches,
    )

    # warped straight to the input size on the host: the pipeline's fp32
    # resize, whose summation order differs between the frameworks, stays
    # out of the float64 comparison
    imdb = build_synthetic_ferplus(num_images=12, seed=3)
    b = next(ferplus_batches(imdb, 1, 6, seed=3, augment=True,
                             augment_out_size=64))
    return dict(b, pad_mask=RAGGED)


def _jax_steps(kind, loss, batch, dtype):
    jmodel, _, v = _tiny(kind, dtype, None)
    with jax.enable_x64(dtype == jnp.float64), \
            jax.default_matmul_precision("highest"):
        state = jstate.TrainState.create(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), v),
            jax.random.PRNGKey(0))
        step = jax.jit(jstate.make_train_step(
            jmodel.apply, jteacher_loss_fn(loss),
            jstate.SGDConfig(weight_decay=5e-4),
            lr_scale_fn=jstate.finetune_lr_scale_fn(backbone_scale=FINETUNE),
            pass_pad_mask=True))
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        losses = []
        for lr in LRS:
            state, m = step(state, jb, lr)
            losses.append(float(m["loss"]))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                            {"params": state.params,
                             "batch_stats": state.model_state["batch_stats"],
                             "velocity": state.velocity})
    want = teacher_state_dict_from_flax({"params": tree["params"],
                                         "batch_stats": tree["batch_stats"]})
    return want, teacher_params_from_flax(tree["velocity"]), np.asarray(losses)


def _port_steps(kind, loss, batch, dtype):
    _, model, v = _tiny(kind, None, dtype)
    model.load_state_dict(teacher_state_dict_from_flax(v), strict=True)
    state = tstate.TrainState.create(model.to(dtype),
                                     torch.Generator().manual_seed(0))
    step = tstate.make_train_step(
        teacher_loss_fn(loss), tstate.SGDConfig(weight_decay=5e-4),
        lr_scale_fn=tstate.finetune_lr_scale_fn(backbone_scale=FINETUNE),
        pass_pad_mask=True)
    tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
    losses = []
    for lr in LRS:
        state, m = step(state, tb, lr)
        losses.append(m["loss"].item())
    return state, np.asarray(losses)


def _close(got: torch.Tensor, ref: torch.Tensor, key: str):
    ref = ref.double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("kind", ["senet", "vggm-bn"])
@pytest.mark.parametrize("loss", ["distributions", "softmaxlog"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_teacher_steps_match_jax(batch, kind, loss, dtype):
    """Three steps through the pipeline, ragged pad_mask, wd 5e-4, the
    backbone at 0.1 of each step's lr; the float64 state in full."""
    torch.set_num_threads(2)
    jdtype, tdtype = DTYPES[dtype]
    want, vel, jlosses = _jax_steps(kind, loss, batch, jdtype)
    st, tlosses = _port_steps(kind, loss, batch, tdtype)
    assert st.step == 3
    assert len(set(jlosses.tolist())) == 3  # every step moved the weights
    if dtype == "float32":
        # the first step's loss, before any update; fp32 near-tie flips move
        # the later ones (VGG-M-bn's third by 1.4% here), so the state is
        # held in float64
        np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
        return
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    got = st.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        if not key.endswith("num_batches_tracked"):
            _close(got[key], want[key], key)
    assert sorted(vel) == sorted(st.velocity)
    for key in vel:
        assert vel[key].abs().max() > 0, key
        _close(st.velocity[key], vel[key], f"velocity {key}")


@pytest.mark.parametrize("use_se", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_resnet_train_forward_and_batch_stats_match_flax(use_se, masked):
    """A train-mode forward of the tiny ResNet/SENet: logits, embedding and
    the updated running statistics within 1e-5 x their scale of Flax."""
    v = random_teacher_variables(seed=2, use_se=use_se, **TINY_RESNET)
    x = (np.random.RandomState(4).randn(6, 64, 64, 3) * 50).astype(np.float32)
    mask = RAGGED if masked else None
    jm = JResNet(use_se=use_se, dtype=jnp.float32, **TINY_RESNET)
    kw = {} if mask is None else {"pad_mask": jnp.asarray(mask)}
    with jax.default_matmul_precision("highest"):
        (jl, jemb), mutated = jm.apply(v, jnp.asarray(x), train=True,
                                       return_embedding=True,
                                       mutable=["batch_stats"], **kw)
    tm = ResNet(use_se=use_se, dtype=torch.float32, **TINY_RESNET)
    tm.load_state_dict(teacher_state_dict_from_flax(v), strict=True)
    tkw = {} if mask is None else {"pad_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        tl, temb = tm(torch.from_numpy(x), train=True, return_embedding=True,
                      **tkw)
    for got, ref in ((tl.numpy(), np.asarray(jl)),
                     (temb.numpy(), np.asarray(jemb))):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    want = teacher_state_dict_from_flax(dict(v, **mutated))
    got = tm.state_dict()
    stats = [k for k in want if "running_" in k]
    assert len(stats) == 2 * (1 + 2 * 4)  # bn1, and 4 in each block
    for key in stats:
        ref = want[key].numpy()
        assert np.abs(got[key].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


class _Capture(torch.nn.Module):
    """A stand-in teacher that keeps what the pipeline hands it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, h, **kw):
        self.seen.append(h)
        return h[:, 0, 0, :]


def test_fliplr_with_a_given_mask_is_numpys_flip():
    x = np.random.RandomState(0).randint(0, 256, (5, 9, 9, 1)).astype(np.uint8)
    flip = np.array([True, False, True, True, False])
    got = fliplr(torch.from_numpy(x), torch.from_numpy(flip)).numpy()
    ref = np.where(flip[:, None, None, None], x[:, :, ::-1], x)
    np.testing.assert_array_equal(got, ref)
    # the pipeline mirrors the rows of its mask in train mode only, before
    # the channel replication; drawn from a generator, the mask is
    # random_flip's from the same seed
    teacher = _Capture()
    model = FaceTeacherPipeline(teacher, input_size=9, mean_rgb=(0, 0, 0))
    xt = torch.from_numpy(x)
    model(xt, train=True, flip=torch.from_numpy(flip))
    model(xt, train=False)
    model(xt, train=True, generator=torch.Generator().manual_seed(4))
    drawn = random_flip(5, 0.5, torch.Generator().manual_seed(4)).numpy()
    for seen, want in zip(teacher.seen, (ref, x, np.where(
            drawn[:, None, None, None], x[:, :, ::-1], x))):
        assert seen.shape == (5, 9, 9, 3)
        np.testing.assert_array_equal(seen[..., 2].numpy(), want[..., 0])
    FaceTeacherPipeline(teacher, input_size=9, mean_rgb=(0, 0, 0),
                        augment=False)(xt, train=True)
    np.testing.assert_array_equal(teacher.seen[-1][..., 0].numpy(), x[..., 0])
    with pytest.raises(ValueError, match="Generator"):
        model(xt, train=True)  # no generator: no silent global RNG


def test_flip_and_dropout_rates_from_the_generator():
    """The flip mask's rate is flip_prob and dropout keeps 1 - rate of the
    values (6 sigma of a binomial), scaled by 1 / (1 - rate); the ResNet's
    train-mode logits are its head on its pooled embedding after that
    dropout, VGGFace's dropouts repeat with the generator's seed and are
    off in eval mode."""
    from mcncrossmodalemotions_torch.models.vggm import dropout

    n = 20000
    for prob in (0.5, 0.2):
        flips = random_flip(n, prob, torch.Generator().manual_seed(1))
        assert abs(float(flips.float().mean()) - prob) <= 6 * np.sqrt(
            prob * (1 - prob) / n)
        kept = dropout(torch.ones(n), prob, torch.Generator().manual_seed(2))
        assert set(torch.unique(kept).tolist()) == {0.0, 1.0 / (1 - prob)}
        assert abs(float((kept > 0).float().mean()) - (1 - prob)) <= 6 * np.sqrt(
            prob * (1 - prob) / n)
    a = random_flip(64, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(a, random_flip(64, 0.5, torch.Generator().manual_seed(3)))

    x = torch.randn(6, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 50
    resnet = ResNet(dtype=torch.float32, dropout_rate=0.5, **TINY_RESNET)
    resnet.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, emb = resnet(x, train=True, return_embedding=True,
                             generator=torch.Generator().manual_seed(5))
        head = resnet.prediction
        want = torch.nn.functional.linear(
            dropout(emb, 0.5, torch.Generator().manual_seed(5)), head.weight,
            head.bias)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    vgg = VGGFace("m", dropout_rate=0.5, dtype=torch.float32, input_size=64,
                  **TINY_VGG)
    vgg.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = [vgg(x, train=True, generator=torch.Generator().manual_seed(s))
                for s in (3, 3, 4)]
        ev = [vgg(x) for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert torch.equal(ev[0], ev[1])
    with pytest.raises(ValueError, match="Generator"):
        vgg(x, train=True)


def test_golden_batch_is_the_committed_one():
    gold = np.load(GOLDEN)
    batch = chip_smoke.golden_train_batch()
    np.testing.assert_array_equal(batch["data"], gold["data"])
    np.testing.assert_array_equal(batch["label_dist"], gold["label_dist"])


@pytest.mark.parametrize("tag", ["fp64", "fp32", "bf16"])
def test_full_width_cpu_step_matches_the_jax_golden(tag):
    """The port's two full-width steps on the CPU against JAX's float64
    run, at the card's gates (``chip_smoke.train_golden_errors``): the
    first loss, the head after the steps and every parameter's first
    update; bf16 within twice JAX's own bf16 error."""
    torch.set_num_threads(2)
    gold = np.load(GOLDEN)
    got = chip_smoke.golden_train_run(TAGS[tag], "cpu")
    errs = chip_smoke.train_golden_errors(got, gold, tag)
    print(f"{tag}: losses {got['losses']}; " + ", ".join(
        f"{k} {e:.3e} (gate {g:.3e})" for k, (e, g) in errs.items()))
    for key, (err, gate) in errs.items():
        assert err <= gate, (key, err, gate)
    # the steps trained, and every parameter's update is worth holding
    assert gold["losses_fp64"][1] < gold["losses_fp64"][0]
    assert all(np.linalg.norm(u) > 0 for u in np.split(
        gold["update_fp64"], np.cumsum(gold["update_sizes"])[:-1]))


def _bn_variance_detached(x, bn, pad_mask=None, mesh=None):
    """A planted fault: train-mode BatchNorm with no gradient through the
    batch variance (all rows, as the golden's full mask)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf.square().mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
    mul = torch.rsqrt(var.detach() + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


FAULTS = {
    "backbone update zeroed": (tstate, "finetune_lr_scale_fn",
                               lambda backbone_scale: _finetune(backbone_scale=0.0)),
    "backbone at the head's lr": (tstate, "finetune_lr_scale_fn",
                                  lambda backbone_scale: _finetune(backbone_scale=1.0)),
    "no weight decay": (tstate, "SGDConfig", lambda momentum, weight_decay:
                        _sgd(momentum=momentum, weight_decay=0.0)),
    "no momentum": (tstate, "SGDConfig", lambda momentum, weight_decay:
                    _sgd(momentum=0.0, weight_decay=weight_decay)),
    "BatchNorm variance detached": (tresnet, "batch_norm_train",
                                    _bn_variance_detached),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_miss_the_golden_gates(monkeypatch, fault):
    """Each planted fault of the step fails a float64 gate of the golden:
    the backbone's update zeroed or at 1.0 x lr, no weight decay, no
    momentum (the head after the second step) and no gradient through
    BatchNorm's batch variance."""
    torch.set_num_threads(2)
    monkeypatch.setattr(*FAULTS[fault])
    got = chip_smoke.golden_train_run(torch.float64, "cpu")
    errs = chip_smoke.train_golden_errors(got, np.load(GOLDEN), "fp64")
    print(fault, {k: f"{e:.3e} (gate {g:.3e})" for k, (e, g) in errs.items()})
    assert any(err > gate for err, gate in errs.values())


def test_one_ulp_of_the_resize_passes_fp32s_gates_not_float64s(monkeypatch):
    """Why float64 takes the host's resize and fp32 is held at JAX's fp32
    spread: both packages resize in fp32, and the card's resize may round
    a last bit otherwise. Moving every resized value one unit in the last
    place, at random, moves the float64 first update past float64's gate
    (median relative L2 above 1e-5) and keeps every fp32 gate."""
    from mcncrossmodalemotions_torch.ops import warp

    torch.set_num_threads(2)
    real = warp.resize_separable

    def one_ulp(*a, **k):
        out = real(*a, **k)
        up = torch.randint(0, 2, out.shape,
                           generator=torch.Generator().manual_seed(1)).bool()
        return torch.nextafter(out, torch.where(up, torch.inf, -torch.inf))

    monkeypatch.setattr(warp, "resize_separable", one_ulp)
    got = chip_smoke.golden_train_run(torch.float64, "cpu")
    gold = np.load(GOLDEN)
    errs = chip_smoke.train_golden_errors(got, gold, "fp32")
    print({k: f"{e:.3e} (gate {g:.3e})" for k, (e, g) in errs.items()})
    assert errs["update median"][0] > chip_smoke.F64_UPDATE_RTOL
    for key, (err, gate) in errs.items():
        assert err <= gate, (key, err, gate)


@pytest.mark.slow
def test_train_golden_rechecked():
    """The committed train golden is what the JAX package gives today."""
    gold = np.load(GOLDEN)
    fresh = golden_arrays()
    assert sorted(gold.files) == sorted(fresh)
    for key, val in fresh.items():
        if val.dtype.kind == "f":
            scale = max(float(np.abs(gold[key]).max()), 1e-12)
            err = float(np.abs(val - gold[key]).max())
            print(f"{key}: max abs diff {err:.3e} (max |golden| {scale:.3e})")
            assert err <= 1e-5 * scale, key
        else:
            np.testing.assert_array_equal(val, gold[key], err_msg=key)


def main(argv) -> int:
    if "--golden" in argv:
        arrays = golden_arrays()
        np.savez_compressed(GOLDEN, **arrays)
        for key, val in arrays.items():
            if val.size <= 8:
                print(key, np.round(val, 7).tolist())
        for tag in ("fp32", "bf16"):
            rel = arrays[f"update_rel_jax_{tag}"]
            print(f"JAX's own {tag} first update: median {np.median(rel):.3e},"
                  f" max {rel.max():.3e}")
        print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.exit(main(sys.argv[1:]))
