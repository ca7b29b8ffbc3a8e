"""Port parity: the loss and metric library against the JAX one.

Every function of ``mcncrossmodalemotions_tpu.losses``, with and without
``sample_weight`` (including a zero weight, the padded-row case), in value
and, for the losses, in gradient with respect to the logits: fp32, rtol
1e-6 (the two libraries differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu import losses as jl
from mcncrossmodalemotions_torch import losses as tl

B, C = 6, 8


def _data():
    rng = np.random.RandomState(7)
    return {
        "logits": rng.randn(B, C).astype(np.float32) * 2,
        "teacher": rng.randn(B, C).astype(np.float32) * 3,
        "probs": rng.dirichlet(np.ones(C), B).astype(np.float32),
        "labels": rng.randint(0, C, B).astype(np.int32),
        "iw": rng.uniform(0.5, 1.5, (B, C)).astype(np.float32),
        "w": np.array([1, 1, 0, 1, 0.5, 1], np.float32),
    }


# name -> fn(lib, logits, d, w), with the same call on both libraries
LOSSES = {
    "distillation_ce": lambda L, z, d, w: L.distillation_ce(
        z, d["teacher"], 2.0, sample_weight=w),
    "distribution_ce": lambda L, z, d, w: L.distribution_ce(
        z, d["probs"], sample_weight=w),
    "softmax_ce": lambda L, z, d, w: L.softmax_ce(z, d["labels"],
                                                 sample_weight=w),
    "euclidean_loss": lambda L, z, d, w: L.euclidean_loss(
        z, d["teacher"], d["iw"], sample_weight=w),
    "euclidean_loss_no_iw": lambda L, z, d, w: L.euclidean_loss(
        z, d["teacher"], sample_weight=w),
    "huber_loss": lambda L, z, d, w: L.huber_loss(
        z, d["teacher"], sigma=1.0, instance_weights=d["iw"], sample_weight=w),
    "huber_loss_sigma2": lambda L, z, d, w: L.huber_loss(
        z, d["teacher"] * 0.1, sigma=2.0, sample_weight=w),
}


def _as(lib, d):
    conv = jnp.asarray if lib is jl else torch.from_numpy
    return {k: conv(v) for k, v in d.items()}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(name, weighted):
    d = _data()
    fn = LOSSES[name]
    jd, td = _as(jl, d), _as(tl, d)
    jw = jd["w"] if weighted else None
    tw = td["w"] if weighted else None
    jval, jgrad = jax.value_and_grad(lambda z: fn(jl, z, jd, jw))(jd["logits"])
    z = td["logits"].clone().requires_grad_(True)
    tval = fn(tl, z, td, tw)
    (tgrad,) = torch.autograd.grad(tval, z)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(weighted):
    d = _data()
    d["logits"][0] = 1.0  # an all-tie row: argmax takes the first index
    jd, td = _as(jl, d), _as(tl, d)
    jw = jd["w"] if weighted else None
    tw = td["w"] if weighted else None
    np.testing.assert_allclose(
        tl.class_error(td["logits"], td["labels"], tw).item(),
        float(jl.class_error(jd["logits"], jd["labels"], jw)), rtol=1e-6)
    tc, tp = tl.per_class_stats(td["logits"], td["labels"], C, tw)
    jc, jp = jl.per_class_stats(jd["logits"], jd["labels"], C, jw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_temperature_softmax_matches_jax(temperature):
    z = _data()["logits"]
    for tfn, jfn in ((tl.softmax_t, jl.softmax_t),
                     (tl.log_softmax_t, jl.log_softmax_t)):
        for axis in (-1, 0):
            np.testing.assert_allclose(
                tfn(torch.from_numpy(z), temperature, axis).numpy(),
                np.asarray(jfn(jnp.asarray(z), temperature, axis)),
                rtol=1e-6, atol=1e-7)


def test_wmean_semantics():
    """sum(w * x) / max(sum(w), 1): all-zero weights give 0, not NaN."""
    x = torch.tensor([1.0, 2.0, 3.0])
    assert tl._wmean(x, torch.zeros(3)).item() == 0.0
    assert tl._wmean(x, torch.tensor([0.0, 0.25, 0.25])).item() == 1.25
    assert tl._wmean(x, torch.tensor([1.0, 0.0, 1.0])).item() == 2.0
